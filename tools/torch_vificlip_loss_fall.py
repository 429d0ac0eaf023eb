#!/usr/bin/env python3
"""Controls for the loss-fall gate of ``chip_smoke.py``'s
``tactile_encoder_phase``, on the CPU: the phase's data pipeline
(``tactile_data``, ``contrastive_batches``) and its contrastive trainer
(20 steps, lr 1e-4, text frozen) on a depth-cut model (CLIP ViT-B/16 and
the B/16 text tower at 2 layers, float32), printing each run's losses and
``loss_fall`` beside ``TACT_FALL_MIN``.

    python3 tools/torch_vificlip_loss_fall.py [run ...]

Runs (default: all): ``sound``; ``same_recordings``, every object's
recordings the same synthetic press (``write_video`` without ``varied``,
patched in this process), so no video can be told from another;
``lr_zero``, the learning rate 0.  The data goes under
``build/tactile_fall`` and is removed.  ~1.5 min a run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = ("sound", "same_recordings", "lr_zero")


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as CS
    from vla_touch_tpu_torch.models.encoders import clip_text as CT
    from vla_touch_tpu_torch.models.encoders import vit as V
    from vla_touch_tpu_torch.planning import encoder as PE
    from vla_touch_tpu_torch.planning import train_encoder as TE

    write_video = CS.write_video
    for run in argv or RUNS:
        root = os.path.join(ROOT, "build", "tactile_fall")
        shutil.rmtree(root, ignore_errors=True)
        if run == "same_recordings":
            CS.write_video = lambda *a, **k: write_video(*a, **dict(k, varied=False))
        try:
            batches = CS.contrastive_batches(CS.tactile_data(root)["samples"])
        finally:
            CS.write_video = write_video
            shutil.rmtree(root, ignore_errors=True)
        model = PE.init_vificlip_model(
            dataclasses.replace(V.CLIP_VIT_B16, num_layers=2),
            dataclasses.replace(CT.CLIP_TEXT_B16, num_layers=2), seed=0, device="cpu",
            prompt_learning=True, num_prompts=CS.TACT_PROMPTS,
            prompt_depth_vision=CS.TACT_DEPTH, prompt_depth_text=CS.TACT_DEPTH,
            projection_dim=CS.TACT_PROJ)
        _, losses = TE.train_vificlip_contrastive(
            batches, model=model, epochs=CS.TACT_EPOCHS,
            lr=0.0 if run == "lr_zero" else CS.TACT_LR, compute_dtype=torch.float32)
        print(run, json.dumps({"losses": [round(x, 4) for x in losses],
                               "fall": CS.loss_fall(losses), "min": CS.TACT_FALL_MIN}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
