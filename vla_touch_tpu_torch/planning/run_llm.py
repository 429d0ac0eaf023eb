"""The planner's LLM interface and scenario reasoning, inference only
(counterpart of ``vla_touch_tpu/planning/run_llm.py``; the projector and
LoRA training wait for the port's training slice).

:func:`make_llm_interface` wraps the in-repo decoder (``planning/llm.py``)
in the embedding-space contract the planning entry points use; :func:`reason_llm` walks a
scenario's chat, greedy-generating the description turns and answering the
final turn with N tempered samples reduced by :func:`select_generation`.

One choice differs from the JAX package: projected tactile features (and
empty text segments) take the dtype of the LLM's embeddings before the
splice, so a bf16 serving tree decodes its prompt in bf16 through the
kernels.  (The JAX package concatenates them in float32, and its bf16
decode then cannot write float32 K/V into the cache.)  Float32 trees are
unaffected.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Callable, Optional

import torch

from vla_touch_tpu_torch.planning import encoder as PE
from vla_touch_tpu_torch.planning import llm as L
from vla_touch_tpu_torch.planning.datasets import clip_preprocess, load_video_frames
from vla_touch_tpu_torch.planning.llm_splice import TACTILE_PLACEHOLDER, process_user_input
from vla_touch_tpu_torch.planning.qa import TACT_MARKER


@dataclasses.dataclass
class LLMInterface:
    """Embedding-space LLM contract: ``embed_text(str) -> (L, D)``,
    ``generate_fn(input_embeds) -> str`` (greedy), the delimiter embeddings
    (D,), and ``sample_fn(input_embeds, num, temperature, seed) -> list`` of
    ``{"text", "avg_surprisal", "total_surprisal"}`` dicts."""

    dim: int
    embed_text: Callable
    generate_fn: Callable
    start_embed: torch.Tensor
    end_embed: torch.Tensor
    sample_fn: Optional[Callable] = None


def make_llm_interface(cfg: L.LLMConfig, params: L.LLM, tokenizer=None, lora=None,
                       max_new_tokens: int = 32) -> LLMInterface:
    """An :class:`LLMInterface` over the decoder: ``embed_text`` is a table
    lookup, ``generate_fn`` greedy-decodes (its per-token entropies kept
    on ``iface.last_entropy``), ``sample_fn`` draws N tempered samples of
    one prompt (the seed seeds torch's generator)."""
    tok = tokenizer or L.ByteTokenizer()
    emb = params.embed

    def embed_text(s):
        ids = tok.encode(s)
        if not ids:
            return emb.new_zeros((0, cfg.hidden_size))
        return L.embed_tokens(params, ids)

    def generate_fn(input_embeds):
        toks, ents, lengths = L.greedy_generate(
            cfg, params, torch.as_tensor(input_embeds, device=emb.device)[None],
            max_new_tokens=max_new_tokens, eos_id=tok.EOS, lora=lora)
        n = int(lengths[0])
        iface.last_entropy = ents[0, :n].cpu().numpy()
        ids = [int(t) for t in toks[0].tolist() if int(t) != tok.EOS][:n]
        return tok.decode(ids)

    def sample_fn(input_embeds, num: int, temperature: float, seed: int = 0):
        toks, _, surps, lengths = L.sample_generate(
            cfg, params, torch.as_tensor(input_embeds, device=emb.device)[None], seed=seed,
            max_new_tokens=max_new_tokens, eos_id=tok.EOS, lora=lora,
            temperature=temperature, num_return_sequences=num)
        avg = L.sequence_avg_surprisal(surps, lengths).tolist()
        toks, lengths = toks.tolist(), lengths.tolist()
        out = []
        for i in range(num):
            n = int(lengths[i])
            ids = [t for t in toks[i] if t != tok.EOS][:n]
            out.append({"text": tok.decode(ids), "avg_surprisal": float(avg[i]),
                        "total_surprisal": float(avg[i] * max(n, 1))})
        return out

    delims = L.embed_tokens(params, [tok.TACTILE_START, tok.TACTILE_END])
    iface = LLMInterface(dim=cfg.hidden_size, embed_text=embed_text, generate_fn=generate_fn,
                         start_embed=delims[0], end_embed=delims[1], sample_fn=sample_fn)
    iface.last_entropy = None
    iface.tokenizer = tok
    return iface


def render_chat(chat: list, add_generation_prompt: bool = True) -> str:
    """Role/content turns -> one ChatML prompt string."""
    parts = [f"<|im_start|>{t['role']}\n{t['content']}<|im_end|>\n" for t in chat]
    if add_generation_prompt:
        parts.append("<|im_start|>assistant\n")
    return "".join(parts)


def parse_answer_option(text: str) -> str:
    """The first character after the last ``"Answer: "`` (the whole text's
    first character when absent), ``*`` stripped."""
    return text.replace("*", "").split("Answer: ")[-1][:1]


def select_generation(candidates: list, selection_type: str, valid_options=("A", "B", "C"),
                      rng=None):
    """Pick the final generation from N sampled candidates:
    ``majority_voting`` (the option with most votes, a random supporter's
    text) or ``best_of_n`` (per-candidate confidence ``(max_avg - avg_i) /
    max_avg``, options ranked by the sum of their supporters' scores, the
    winner's best-scored text).  Returns ``(final_text, option,
    option_counts, option_scores)``; with no valid option, the first
    candidate and ``None``."""
    rng = rng or random.Random(0)
    option_generations: dict = {}
    option_counts: dict = {}
    option_scores: dict = {}
    if selection_type not in ("majority_voting", "best_of_n"):
        raise ValueError(selection_type)
    max_avg = max(c["avg_surprisal"] for c in candidates)
    for c in candidates:
        option = parse_answer_option(c["text"])
        if option not in valid_options:
            continue
        score = (max_avg - c["avg_surprisal"]) / max_avg if max_avg > 0 else 0.0
        option_generations.setdefault(option, []).append(c["text"])
        option_counts[option] = option_counts.get(option, 0) + 1
        option_scores.setdefault(option, []).append(score)
    if not option_counts:
        return candidates[0]["text"], None, {}, {}
    if selection_type == "majority_voting":
        best = max(option_counts, key=option_counts.get)
        final = rng.choice(option_generations[best])
    else:
        best = max(option_scores, key=lambda k: sum(option_scores[k]))
        idx = option_scores[best].index(max(option_scores[best]))
        final = option_generations[best][idx]
    return final, best, option_counts, {k: sum(v) for k, v in option_scores.items()}


def _encode_video(encoder_state: PE.TactileEncoderState, video_dir: str, frame_size: int,
                  max_frames: int = 4, sensor: str = "dotted"):
    """A tactile directory -> its adapted feature (D,) float32 on the
    encoder's device."""
    frames = load_video_frames(video_dir, max_frames=max_frames)
    pre = clip_preprocess(frames, frame_size)
    return PE.encode_tactile_video(encoder_state, pre[None], sensor)[0]


def reason_llm(encoder_state: PE.TactileEncoderState, llm: LLMInterface, projector,
               rows: list, output_dir: str, *, reasoning_sampling_num: int = 1,
               reasoning_temperature: float = 0.7,
               reasoning_selection_type: str = "majority_voting", generate_idx=(0,),
               answer_step_idx: Optional[int] = None, frame_size: int = 224, seed: int = 0,
               rag_fn: Optional[Callable] = None) -> dict:
    """Scenario reasoning over chat-schema rows: walk each chat,
    greedy-generating the assistant turns whose index is in
    ``generate_idx`` and keeping the dataset's text for the rest; answer the
    FINAL turn with ``reasoning_sampling_num`` tempered samples reduced by
    :func:`select_generation` (one greedy pass when 1).  ``projector`` is a
    ``TactileProjector``.  Writes ``reason/{scenario}.json`` per scenario and
    returns ``{scenario: [records]}``."""

    def project(f):
        with torch.no_grad():
            return projector(f.float())[None].to(llm.start_embed.dtype)

    def splice(text: str, feats: list):
        text = text.replace(TACT_MARKER, TACTILE_PLACEHOLDER)
        n = text.count(TACTILE_PLACEHOLDER)
        return process_user_input(text, feats[:n], llm.embed_text, lambda f: f, project,
                                  llm.start_embed, llm.end_embed)

    if reasoning_sampling_num > 1 and llm.sample_fn is None:
        raise ValueError("reasoning_sampling_num > 1 needs an LLMInterface with sample_fn "
                         "(see make_llm_interface); got None")
    all_reason: dict = {}
    sample_no: dict = {}
    for ri, row in enumerate(rows):
        info = row.get("info", {})
        scenario = f"{info.get('scenario', 'scenario')}_{info.get('target', ri)}"
        chat = list(row["chat"])
        if answer_step_idx is not None:
            chat = chat[: int(answer_step_idx) * 2]
        feats = [_encode_video(encoder_state, v, frame_size) for v in info.get("tactile", [])]
        sample_no[scenario] = sample_no.get(scenario, 0) + 1
        generated_chat = []
        for c in range(len(chat) - 1):
            turn = dict(chat[c])
            if c % 2 == 0:                                  # user turn
                generated_chat.append(turn)
                continue
            answer_idx = (c - 1) // 2
            if answer_idx in tuple(generate_idx):
                generation = llm.generate_fn(splice(render_chat(generated_chat), feats))
                turn["generate"] = True
                turn["true_answer"] = turn["content"]
                turn["content"] = generation
            else:
                turn["generate"] = False
            if answer_idx == 0 and rag_fn is not None:
                turn["content"] += ("\nMost similar objects (in order of decreasing "
                                    "similarity):" + rag_fn(feats))
            generated_chat.append(turn)

        final_prompt = render_chat(generated_chat)
        final_true_answer = chat[-1]["content"][:1]
        option_counts: dict = {}
        option_scores: dict = {}
        if reasoning_sampling_num == 1:
            final_generation = llm.generate_fn(splice(final_prompt, feats))
        else:
            cands = llm.sample_fn(splice(final_prompt, feats), reasoning_sampling_num,
                                  reasoning_temperature, seed=seed + ri)
            letters = tuple(chr(ord("A") + i) for i in range(info.get("num_candidates", 3)))
            final_generation, _, option_counts, option_scores = select_generation(
                cands, reasoning_selection_type, valid_options=letters)
        all_reason.setdefault(scenario, []).append({
            "sample_no": sample_no[scenario],
            "sample_paths": list(info.get("tactile", [])),
            "all_objects": info.get("objects", {}),
            "num_candidates": info.get("num_candidates"),
            "chat": generated_chat,
            "generate_idx": list(generate_idx),
            "answer_step_idx": answer_step_idx,
            "reasoning_sampling_num": reasoning_sampling_num,
            "reasoning_selection_type": reasoning_selection_type,
            "final_true_answer": final_true_answer,
            "final_generation": final_generation,
            "option_counts": option_counts,
            "option_entropies": option_scores,
        })

    reason_dir = os.path.join(output_dir, "reason")
    os.makedirs(reason_dir, exist_ok=True)
    for scenario, records in all_reason.items():
        with open(os.path.join(reason_dir, f"{scenario}.json"), "w") as f:
            json.dump(records, f, indent=2)
    return all_reason
