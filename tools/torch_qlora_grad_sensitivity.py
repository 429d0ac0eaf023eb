#!/usr/bin/env python3
"""How much one ``train_projection_and_lora`` step's gradient moves when the
trainables move by a little, over a grouped-int4 base and over the same
base with its quantized products replaced by the dequantized weights'
(a smooth function of x), on the CPU in float32: why the card-vs-CPU
gradient gate of ``chip_smoke.py``'s ``llm_train_phase`` cannot be as
tight as bf16's 2^-8.  The quantized product rounds x to int8 codes, so
its forward steps where a code changes and its input gradient (through
each row's amax alone) jumps where another element becomes a row's
largest.

    python3 tools/torch_qlora_grad_sensitivity.py [rel ...]

A 2-layer Qwen2-architecture base 512 wide (4 heads, MLP 1024, vocabulary
384, grouped int4, fused), a projector from 768-wide features, LoRA rank 8
on the seven targets with B drawn, a 150-token row with two seeded unit
features; the projector's weights scaled by (1 + rel x N(0, 1)) (default
rel 1e-6 and 4e-3, about bf16's rounding).  Prints, per rel and base, the
loss's and the trainables' gradient's relative change (~1 min).
"""

from __future__ import annotations

import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as CS
    from vla_touch_tpu_torch.ops import quant as Q
    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning.llm_splice import init_tactile_projector

    cfg = L.qwen2_tiny(hidden_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
                       mlp_dim=1024, vocab_size=384, tie_embeddings=False)
    tree = L.fuse_quantized_layers(L.init_llm(cfg, 0, device="cpu", dtype=torch.bfloat16,
                                              weights="int4"))
    proj = init_tactile_projector(768, cfg.hidden_size, seed=2, device="cpu")
    lora = L.init_lora(cfg, rank=CS.LLM_RANK, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for lp in lora["layers"]:
        for ab in lp.values():
            ab["B"].normal_(0.0, 0.01, generator=gen)
    row = {"question": "Describe the objects.\n\nObject 1: <tact>\n\nObject 2: <tact> in "
                       "detail please, and rank them",
           "answer": "Object 1: soft, smooth, textured, hard, squishy. Object 2: hard and "
                     "glossy.", "tactile": ["a", "b"]}
    rng = np.random.default_rng(0)
    feats = []
    for _ in row["tactile"]:
        f = rng.normal(size=768).astype(np.float32)
        feats.append(torch.as_tensor(f / np.linalg.norm(f)))

    def step(p):
        return CS.qlora_step_grads(cfg, *CS.qlora_to(tree, p, lora, "cpu", torch.float32),
                                   feats, row)

    def dequantized(x, qp, out_dtype=torch.bfloat16):
        y = x.float() @ Q.dequantize_w4(qp).t()
        return (y if qp.bias is None else y + qp.bias).to(out_dtype)

    quantized = Q.qdense_w4
    for rel in map(float, argv or ["1e-6", "4e-3"]):
        moved = copy.deepcopy(proj)
        with torch.no_grad():
            for t in moved.parameters():
                t.mul_(1 + rel * torch.randn(t.shape, generator=gen))
        for base, fn in (("quantized", quantized), ("dequantized", dequantized)):
            Q.qdense_w4 = fn
            try:
                (la, a), (lb, b) = step(proj), step(moved)
            finally:
                Q.qdense_w4 = quantized
            print(json.dumps(dict(rel=rel, base=base, loss_rel_change=abs(la - lb) / abs(la),
                                  grad_l2_rel_change=float((a - b).norm() / a.norm()))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
