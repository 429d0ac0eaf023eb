"""The planner's LLM interface, its training and its scenario reasoning
(counterpart of ``vla_touch_tpu/planning/run_llm.py``).

:func:`make_llm_interface` wraps the in-repo decoder (``planning/llm.py``)
in the embedding-space contract the planning entry points use, its
``loss_fn`` the teacher-forced loss of an answer after spliced prompt
embeddings.  :func:`train_projection` trains the tactile projector against
the frozen LLM (AdamW as ``optax.adamw``), :func:`train_projection_and_lora`
the projector and LoRA factors together over a frozen (for example grouped
int4) base, and :func:`test_llm` greedy-decodes a split into
``predictions.json``.  Torch cannot replay ``jax.random``, so the trainers
take their initial trainables (a ``TactileProjector``, LoRA factors) as
arguments and draw them from seeded torch generators when none are given.
The trainables are float32 masters; the LoRA factors are cast to the
activations' dtype inside the forward (on a bf16 tree: bf16, so every
quantized linear keeps its kernel route) and the projector's float32
output to the embeddings' dtype.  :func:`reason_llm` walks a scenario's
chat, greedy-generating the description turns and answering the final
turn with N tempered samples reduced by :func:`select_generation`.

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
from vla_touch_tpu_torch.planning.llm_splice import (TACTILE_PLACEHOLDER, init_tactile_projector,
                                                     process_user_input)
from vla_touch_tpu_torch.planning.qa import TACT_MARKER
from vla_touch_tpu_torch.utils import checkpoint as ckpt
from vla_touch_tpu_torch.utils.from_flax import to_flax

# optax.adamw's default weight decay, on every parameter
ADAMW_DECAY = 1e-4


@dataclasses.dataclass
class LLMInterface:
    """Embedding-space LLM contract: ``embed_text(str) -> (L, D)``,
    ``loss_fn(input_embeds, answer, lora_override=None) -> scalar`` (the
    teacher-forced loss, differentiable w.r.t. the embeddings and the
    LoRA factors), ``generate_fn(input_embeds) -> str`` (greedy), the
    delimiter embeddings (D,), and ``sample_fn(input_embeds, num,
    temperature, seed) -> list`` of ``{"text", "avg_surprisal",
    "total_surprisal"}`` dicts."""

    dim: int
    embed_text: Callable
    loss_fn: Callable
    generate_fn: Callable
    start_embed: torch.Tensor
    end_embed: torch.Tensor
    sample_fn: Optional[Callable] = None


def make_llm_interface(cfg: L.LLMConfig, params: L.LLM, tokenizer=None, lora=None,
                       max_new_tokens: int = 32) -> LLMInterface:
    """An :class:`LLMInterface` over the decoder: ``embed_text`` is a table
    lookup, ``loss_fn`` the teacher-forced loss of ``answer`` + EOS after
    the prompt embeddings (the targets written from the prompt's last
    position, which predicts the answer's first token), ``generate_fn``
    greedy-decodes (its per-token entropies kept on
    ``iface.last_entropy``), ``sample_fn`` draws N tempered samples of one
    prompt (the seed seeds torch's generator)."""
    tok = tokenizer or L.ByteTokenizer()
    emb = params.embed

    def embed_text(s):
        ids = tok.encode(s)
        if not ids:
            return emb.new_zeros((0, cfg.hidden_size))
        return L.embed_tokens(params, ids)

    def _answer_targets(input_embeds, answer):
        ans = torch.as_tensor(list(tok.encode(answer)) + [tok.EOS], device=emb.device)
        Lp = input_embeds.shape[0]
        full = torch.cat([torch.as_tensor(input_embeds, device=emb.device),
                          L.embed_tokens(params, ans[:-1])], dim=0)
        pos = torch.arange(full.shape[0], device=emb.device)
        tgt = torch.zeros(full.shape[0], dtype=torch.long, device=emb.device)
        tgt[Lp - 1:Lp - 1 + len(ans)] = ans
        return full, tgt, (pos >= Lp - 1).float()

    def loss_fn(input_embeds, answer, lora_override=None):
        full, tgt, mask = _answer_targets(input_embeds, answer)
        return L.lm_loss(cfg, params, full[None], tgt[None], mask[None],
                         lora=lora_override if lora_override is not None else lora)

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
    iface = LLMInterface(dim=cfg.hidden_size, embed_text=embed_text, loss_fn=loss_fn,
                         generate_fn=generate_fn, start_embed=delims[0], end_embed=delims[1],
                         sample_fn=sample_fn)
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


def _projected(projector, start_embed):
    """The splice's ``project_fn``: a feature (D,) through the float32
    projector, (1, llm_dim) in the embeddings' dtype (with its graph under
    autograd)."""
    return lambda f: projector(f.float())[None].to(start_embed.dtype)


def _splice(llm: LLMInterface, projector, encoder_state, row: dict, frame_size: int):
    """A dataset row's question with its tactile videos encoded (frozen
    encoder) and projected, as one (L, D) embedding sequence."""
    feats = [_encode_video(encoder_state, v, frame_size) for v in row["tactile"]]
    return process_user_input(row["question"], feats, llm.embed_text, lambda f: f,
                              _projected(projector, llm.start_embed), llm.start_embed,
                              llm.end_embed)


def _log_step(path: str, step: int, epoch: int, loss) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({"step": step, "epoch": epoch, "loss": float(loss.detach())}) + "\n")


def train_projection(encoder_state: PE.TactileEncoderState, llm: LLMInterface, dataset,
                     output_dir: str, epochs: int = 3, lr: float = 1e-4, frame_size: int = 224,
                     seed: int = 0, projector=None):
    """Train the tactile projector against the frozen LLM's loss, one row a
    step: AdamW as ``optax.adamw(lr)`` (weight decay 1e-4 on every
    parameter).  ``projector``: the initial ``TactileProjector`` (trained
    in place), default a seeded one on the LLM's device.  Appends
    ``{"step", "epoch", "loss"}`` to ``llm_training.jsonl`` every 5 steps
    and writes ``projection.msgpack`` (the flax tree, as the JAX package
    writes it).  Returns the projector."""
    from vla_touch_tpu_torch.train import optim

    if projector is None:
        projector = init_tactile_projector(encoder_state.feature_dim, llm.dim, seed=seed,
                                           device=llm.start_embed.device)
    if llm.start_embed.device.type == "cuda":
        optim.float32_math()
    os.makedirs(output_dir, exist_ok=True)
    log_path = os.path.join(output_dir, "llm_training.jsonl")
    projector.requires_grad_(True)
    opt = optim.AdamW(projector.parameters(), weight_decay=ADAMW_DECAY)
    try:
        step = 0
        for epoch in range(epochs):
            for i in range(len(dataset)):
                row = dataset[i]
                loss = llm.loss_fn(_splice(llm, projector, encoder_state, row, frame_size),
                                   row["answer"])
                loss.backward()
                opt.step(lr)
                opt.zero_grad()
                if step % 5 == 0:
                    _log_step(log_path, step, epoch, loss)
                step += 1
    finally:
        projector.requires_grad_(False)
    ckpt.save_pytree(os.path.join(output_dir, "projection.msgpack"), to_flax(projector))
    return projector


@torch.no_grad()
def test_llm(encoder_state: PE.TactileEncoderState, llm: LLMInterface, projector, dataset,
             output_dir: str, frame_size: int = 224) -> list:
    """Greedy-decode each row of ``dataset``; writes ``predictions.json``
    (``question``, ``answer``, ``prediction`` per row) and returns the
    rows."""
    preds = []
    for i in range(len(dataset)):
        row = dataset[i]
        preds.append({"question": row["question"], "answer": row.get("answer"),
                      "prediction": llm.generate_fn(
                          _splice(llm, projector, encoder_state, row, frame_size))})
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "predictions.json"), "w") as f:
        json.dump(preds, f, indent=2)
    return preds


def lora_in(lora: dict, dtype) -> dict:
    """LoRA factors cast to ``dtype`` (the activations'), the graph kept:
    the trainers' float32 masters as the forward uses them."""
    return {"layers": [{t: {k: ab[k].to(dtype) for k in ("A", "B")} for t, ab in lp.items()}
                       for lp in lora["layers"]], "scale": lora["scale"]}


def joint_loss(iface: LLMInterface, projector, lora: dict, encoder_state, row: dict,
               frame_size: int = 224):
    """One row's loss in :func:`train_projection_and_lora`: the row's videos
    encoded and projected into its question, the LoRA masters cast to the
    embeddings' dtype."""
    return iface.loss_fn(_splice(iface, projector, encoder_state, row, frame_size),
                         row["answer"], lora_override=lora_in(lora, iface.start_embed.dtype))


def train_projection_and_lora(encoder_state: PE.TactileEncoderState, cfg: L.LLMConfig,
                              params: L.LLM, dataset, output_dir: str, epochs: int = 3,
                              lr: float = 1e-3, lora_rank: int = 8, frame_size: int = 224,
                              seed: int = 0, tokenizer=None, projector=None, lora=None):
    """The projector and LoRA factors on every projection trained jointly
    through the frozen decoder (float, int8 or grouped int4), one row a
    step: AdamW as ``optax.adamw(lr)`` over both.  ``projector`` / ``lora``:
    the initial trainables (trained in place; default a seeded projector
    and ``init_lora(cfg, lora_rank, seed=seed + 1)`` on the decoder's
    device).  The factors are float32 masters, cast to the embeddings'
    dtype in the forward.  Appends every step's loss to
    ``llm_training.jsonl``; writes ``projection.msgpack`` and
    ``lora.msgpack`` (``{"layers", "scale"}``, float32) as the JAX package
    does.  Returns (projector, lora)."""
    from vla_touch_tpu_torch.train import optim
    from vla_touch_tpu_torch.utils.from_flax import llm_lora_to_flax

    dev = params.embed.device
    if projector is None:
        projector = init_tactile_projector(encoder_state.feature_dim, cfg.hidden_size,
                                           seed=seed, device=dev)
    if lora is None:
        lora = L.init_lora(cfg, rank=lora_rank, seed=seed + 1, device=dev)
    iface = make_llm_interface(cfg, params, tokenizer)
    if dev.type == "cuda":
        optim.float32_math()
    os.makedirs(output_dir, exist_ok=True)
    log_path = os.path.join(output_dir, "llm_training.jsonl")
    factors = [ab[k] for lp in lora["layers"] for ab in lp.values() for k in ("A", "B")]
    projector.requires_grad_(True)
    for t in factors:
        t.requires_grad_(True)
    opt = optim.AdamW(list(projector.parameters()) + factors, weight_decay=ADAMW_DECAY)
    try:
        step = 0
        for epoch in range(epochs):
            for i in range(len(dataset)):
                loss = joint_loss(iface, projector, lora, encoder_state, dataset[i],
                                  frame_size)
                loss.backward()
                opt.step(lr)
                opt.zero_grad()
                _log_step(log_path, step, epoch, loss)
                step += 1
    finally:
        projector.requires_grad_(False)
        for t in factors:
            t.requires_grad_(False)
    ckpt.save_pytree(os.path.join(output_dir, "projection.msgpack"), to_flax(projector))
    ckpt.save_pytree(os.path.join(output_dir, "lora.msgpack"), llm_lora_to_flax(lora))
    return projector, lora


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
