#!/usr/bin/env python3
"""How far one ``train_projection_and_lora`` step's loss and gradient move
when the grouped-int4 Qwen2.5-7B base runs its activations in bf16 (the
card's recipe: bf16 embeddings, the LoRA masters cast to bf16, every
quantized linear through ``W4A8MatmulFn``) against float32 activations
(the plain quantized products), both on the CPU, and how far the bf16 step
moves when its inputs move by about a bf16 rounding: the yardsticks of the
card-vs-CPU gates of ``chip_smoke.py``'s ``llm_train_phase``.

    python3 tools/torch_qlora_bf16_step.py [seed ...]

The model is the phase's depth-2 cut (``chip_smoke.qlora_depth2``: full
widths, 2 layers, the vocabulary cut to ``LLM_CUT_VOCAB``; the projector
and LoRA factors, B drawn), the row the phase's (the first short row, 22
tokens, its recording from the seeded tree written under ``build/qlora_step``
and removed), its tactile features from the phase's seeded CLIP ViT-B/16
encoder (float32 here, bf16 on the card).  Prints, per seed of the
weights' draw (default 0, 1, 2), for bf16 against float32 and for bf16
against bf16 with the projector's weights scaled by (1 + PERTURB x N(0,
1)), the loss's relative error, the trainables' gradient's relative L2
error and their correlation (~1.5 min a seed).
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the projector's relative perturbation of the third step: about half a bf16
# rounding step, the size of the differences between two bf16 programs
PERTURB = 2e-3


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as CS
    from vla_touch_tpu_torch.planning import encoder as PE
    from vla_touch_tpu_torch.planning import run_llm as RL
    from vla_touch_tpu_torch.planning.llm import ByteTokenizer

    root = os.path.join(ROOT, "build", "qlora_step")
    shutil.rmtree(root, ignore_errors=True)
    try:
        CS.tactile_data(os.path.join(root, "tree"))
        row = CS.llm_rows(os.path.join(root, "tree"), root)["short"][0]
        enc = PE.init_tactile_encoder(seed=1, device="cpu", dtype=torch.float32)
        with torch.no_grad():
            feats = [RL._encode_video(enc, v, 224) for v in row["tactile"]]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    def compare(x, y):
        (lx, a), (ly, b) = x, y
        return dict(loss_rel_err=abs(lx - ly) / abs(ly),
                    grad_l2_rel=float((a - b).norm() / b.norm()),
                    grad_corr=float(torch.corrcoef(torch.stack([a, b]))[0, 1]))

    gen = torch.Generator().manual_seed(7)
    for seed in map(int, argv or ["0", "1", "2"]):
        cfg, tree, proj, lora = CS.qlora_depth2(seed, device="cpu")
        moved = copy.deepcopy(proj)
        with torch.no_grad():
            for t in moved.parameters():
                t.mul_(1 + PERTURB * torch.randn(t.shape, generator=gen))
        out = {name: CS.qlora_step_grads(cfg, *CS.qlora_to(tree, p, lora, "cpu", dt), feats,
                                         row)
               for name, p, dt in (("bf16", proj, torch.bfloat16),
                                   ("float32", proj, torch.float32),
                                   ("bf16_moved", moved, torch.bfloat16))}
        print(json.dumps(dict(seed=seed, rows=CS.llm_row_tokens(row, ByteTokenizer())[1],
                              loss_bf16=out["bf16"][0], loss_float32=out["float32"][0],
                              bf16_vs_float32=compare(out["bf16"], out["float32"]),
                              bf16_vs_bf16_moved=compare(out["bf16_moved"], out["bf16"]))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
