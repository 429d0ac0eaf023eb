"""Instruction embeddings, precomputed (counterpart of
``vla_touch_tpu/models/encoders/t5.py``).

T5-XXL stays out of the control tick: instructions are embedded once and
the tick reads the arrays.  :class:`LanguageEncoder` has the three tool
surfaces: one instruction, a directory of episodes (each
``<episode>/instruction.txt`` -> ``<episode>/instruct_lang.npy``), and a
list -> dict with an ``all_instructions`` index (the dict the inference
loop's instruction switch reads), over any embedder with
``get_text_embeddings``: the port's own encoder
(``t5_native.NativeT5Embedder``) or :class:`T5Embedder`, an HF
``T5EncoderModel``.  The dict's npz file is the JAX package's
(:func:`save_instruction_dict`, :func:`load_instruction_dict`).

    python -m vla_touch_tpu_torch.models.encoders.t5 --model DIR \
        --instruction "wipe the table" [--episodes_dir DIR] [--out FILE] [--device cpu]

``transformers`` is imported only by :class:`T5Embedder`, and only when it
is not handed both a model and a tokenizer.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from vla_touch_tpu_torch.utils.device import resolve_device


class T5Embedder:
    """A frozen HF T5 encoder -> (L, D) embeddings.  With no ``model``
    (and no ``tokenizer``), ``model_name_or_path`` is a local directory
    whose weights (and tokenizer) ``transformers`` reads; its absence
    raises ``RuntimeError``.  On ``device`` (default CUDA)."""

    def __init__(self, model_name_or_path: str = "google/t5-v1_1-xxl",
                 max_length: int = 1024, model=None, tokenizer=None, device=None):
        self.max_length = max_length
        self.device = resolve_device(device)
        self.model, self.tokenizer = model, tokenizer
        if model is None or tokenizer is None:
            try:
                import transformers
            except ImportError as e:
                raise RuntimeError("T5Embedder without a model needs the transformers "
                                   "package; pass model= and tokenizer=, or use "
                                   "t5_native.NativeT5Embedder") from e
            if tokenizer is None:
                self.tokenizer = transformers.AutoTokenizer.from_pretrained(
                    model_name_or_path, local_files_only=True)
            if model is None:
                self.model = transformers.T5EncoderModel.from_pretrained(
                    model_name_or_path, local_files_only=True)
        self.model.eval().to(self.device)
        for p in self.model.parameters():
            p.requires_grad_(False)

    @torch.no_grad()
    def get_text_embeddings(self, texts: Sequence[str]) -> list:
        """One (L_i, D) float32 numpy array per text (its valid tokens)."""
        out = []
        for text in texts:
            tok = self.tokenizer(text, return_tensors="pt", truncation=True,
                                 max_length=self.max_length)
            hidden = self.model(
                tok["input_ids"].to(self.device),
                attention_mask=tok["attention_mask"].to(self.device)).last_hidden_state[0]
            out.append(hidden.float().cpu().numpy())
        return out


class LanguageEncoder:
    """The encode_lang tool surfaces over any embedder with
    ``get_text_embeddings``."""

    def __init__(self, embedder):
        self.embedder = embedder

    def encode_instruction(self, instruction: str) -> np.ndarray:
        return self.embedder.get_text_embeddings([instruction])[0]

    def encode_instructions(self, instructions: Sequence[str]) -> dict:
        """list -> {'all_instructions': [...], '<instruction>': (L, D)}."""
        embeds = self.embedder.get_text_embeddings(list(instructions))
        out = {"all_instructions": list(instructions)}
        for ins, emb in zip(instructions, embeds):
            out[ins] = emb
        return out

    def encode_directory(self, dir_path: str, out_suffix: str = "_lang.npy",
                         instruction_file: str = "instruction.txt") -> list:
        """Each episode directory's ``instruction_file`` embedded into
        ``instruct<out_suffix>`` beside it; returns the written paths."""
        written = []
        for name in sorted(os.listdir(dir_path)):
            epi = os.path.join(dir_path, name)
            ins_path = os.path.join(epi, instruction_file)
            if not os.path.isdir(epi) or not os.path.exists(ins_path):
                continue
            with open(ins_path) as f:
                instruction = f.read().strip()
            out_path = os.path.join(epi, f"instruct{out_suffix}")
            np.save(out_path, self.encode_instruction(instruction))
            written.append(out_path)
        return written


def save_instruction_dict(path: str, d: dict) -> None:
    """npz: ``all_instructions`` and ``emb_{i}`` per instruction."""
    np.savez(path, all_instructions=np.asarray(d["all_instructions"]),
             **{f"emb_{i}": d[k] for i, k in enumerate(d["all_instructions"])})


def load_instruction_dict(path: str) -> dict:
    z = np.load(path, allow_pickle=False)
    names = [str(x) for x in z["all_instructions"]]
    out = {"all_instructions": names}
    for i, n in enumerate(names):
        out[n] = z[f"emb_{i}"]
    return out


def main(argv=None, embedder=None):
    """Precompute instruction embeddings (``embedder`` replaces the
    :class:`T5Embedder` the CLI builds from ``--model``)."""
    import argparse

    p = argparse.ArgumentParser(description="Precompute T5 instruction embeddings")
    p.add_argument("--model", default="google/t5-v1_1-xxl",
                   help="local directory of an HF T5 checkpoint and tokenizer")
    p.add_argument("--instruction", action="append", default=[],
                   help="repeatable; saved as an instruction dict")
    p.add_argument("--episodes_dir", default=None,
                   help="batch mode: embed each episode's instruction.txt")
    p.add_argument("--out", default="instructions.npz")
    p.add_argument("--device", default=None, help="default CUDA")
    args = p.parse_args(argv)

    enc = LanguageEncoder(embedder or T5Embedder(args.model, device=args.device))
    if args.episodes_dir:
        written = enc.encode_directory(args.episodes_dir)
        print(f"wrote {len(written)} embeddings under {args.episodes_dir}")
    if args.instruction:
        save_instruction_dict(args.out, enc.encode_instructions(args.instruction))
        print(f"wrote {len(args.instruction)} instructions to {args.out}")


if __name__ == "__main__":
    main()
