#!/usr/bin/env python3
"""Fault controls for the loss-fall gate of ``chip_smoke.py``'s ``rdt_train``
phase: train RDT-1B as the phase's main path does (RDT_STEPS steps of batch
4 x accumulation 4 on the seeded npz episodes, SigLIP So400m), sound and
with a planted fault, and print each run's probe loss fall beside
``RDT_FALL_MIN``.

    python3 tools/torch_rdt_train_fault_control.py [fault ...]

Faults (default: all): ``none``; ``skip_step``, the optimizer's updates
zeroed (``RDTOptimizer.update`` patched in this process); ``lr_zero``, the
learning rate 0.  The checkout is never edited; the episodes and
checkpoints go under ``build/rdt_fault`` and are removed.  Needs one NVIDIA
GPU (~1.5 min a fault).
"""

from __future__ import annotations

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("none", "skip_step", "lr_zero")


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.models.encoders.vit import (SIGLIP_SO400M,
                                                         SiglipVisionEncoder, init_vit)

    build.build_all()
    root = os.path.join(ROOT, "build", "rdt_fault")
    shutil.rmtree(root, ignore_errors=True)
    try:
        files = CS.rdt_episodes(os.path.join(root, "episodes"))
        vision = init_vit(SiglipVisionEncoder, SIGLIP_SO400M, CS.RDT_SEED + 1, "cuda")
        for fault in sys.argv[1:] or FAULTS:
            out = os.path.join(root, fault)
            res = CS.rdt_fall_run(vision, files, out,
                                  learning_rate=0.0 if fault == "lr_zero" else None,
                                  skip_step=fault == "skip_step")
            shutil.rmtree(out, ignore_errors=True)
            print(f"{fault}: " + json.dumps(res) + f" (gate: fall at least {CS.RDT_FALL_MIN})",
                  flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
