#!/usr/bin/env python3
"""Controls for the loss-fall gate of ``chip_smoke.py``'s
``llm_train_phase``, on the CPU: the phase's data (``tactile_data``,
``llm_rows``) and its LoRA run (``train_projection_and_lora``: rank 8 on
the seven targets, lr 1e-3, LLM_EPOCHS epochs of the LLM_ROWS rows) on the
depth-2 cut of the grouped-int4 Qwen2.5-7B base in bf16 (full widths, the
vocabulary cut to LLM_CUT_VOCAB), the frozen CLIP ViT-B/16 encoder in
float32; prints each run's losses and ``epoch_fall`` beside
``LLM_FALL_MIN``.

    python3 tools/torch_qlora_loss_fall.py [run ...]

Runs (default: all): ``sound``; ``lr_zero``, the learning rate 0;
``same_rows``, every row the first row (one question, answer and
recording to learn).  The data goes under ``build/qlora_fall`` and is
removed.  ~10-20 min a run (the CPU's int32 products).
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = ("sound", "lr_zero", "same_rows")


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as CS
    from vla_touch_tpu_torch.planning import encoder as PE
    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning import run_llm as RL

    root = os.path.join(ROOT, "build", "qlora_fall")
    shutil.rmtree(root, ignore_errors=True)
    try:
        CS.tactile_data(os.path.join(root, "tree"))
        rows = CS.llm_rows(os.path.join(root, "tree"), root)["long"]
        rows = [rows[i] for i in range(len(rows))]
        enc = PE.init_tactile_encoder(seed=1, device="cpu", dtype=torch.float32)
        cfg, tree, proj, _ = CS.qlora_depth2(device="cpu")
        for run in argv or RUNS:
            data = [rows[0]] * len(rows) if run == "same_rows" else rows
            lora = L.init_lora(cfg, rank=CS.LLM_RANK, seed=5, device="cpu")
            out = os.path.join(root, run)
            RL.train_projection_and_lora(enc, cfg, tree, data, out, epochs=CS.LLM_EPOCHS,
                                         lr=0.0 if run == "lr_zero" else CS.LLM_LR,
                                         lora_rank=CS.LLM_RANK, projector=copy.deepcopy(proj),
                                         lora=lora)
            losses = CS.read_losses(os.path.join(out, "llm_training.jsonl"))
            print(run, json.dumps({"losses": [round(x, 4) for x in losses],
                                   "fall": CS.epoch_fall(losses, CS.LLM_EPOCHS),
                                   "gate": CS.LLM_FALL_MIN}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
