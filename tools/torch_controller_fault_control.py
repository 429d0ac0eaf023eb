#!/usr/bin/env python3
"""Fault controls for the training gates of ``chip_smoke.py``'s controllers
phase: train BRIDGeR and the LSTM controller as the phase does, sound and
with a planted fault, and print each run's loss fall beside
``CTRL_FALL_MIN``.

    python3 tools/torch_controller_fault_control.py [fault ...]

Faults (default: all): ``none``; ``skip_step``, the optimizer step a no-op
(``AdamW.step`` patched in this process); ``lr_zero``, the learning rate
0.  The checkout is never edited.  Needs one NVIDIA GPU (~1 min).
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("none", "skip_step", "lr_zero")


def run(fault: str, data, lstm_data) -> dict:
    import dataclasses

    import chip_smoke as CS
    from vla_touch_tpu_torch.config import (BridgeControllerConfig, BridgeTrainConfig,
                                            LSTMControllerConfig, LSTMTrainConfig)
    from vla_touch_tpu_torch.train import bridge_train as BT
    from vla_touch_tpu_torch.train import lstm_train as LT
    from vla_touch_tpu_torch.train.optim import AdamW

    lr = 0.0 if fault == "lr_zero" else CS.CTRL_LR
    step = AdamW.step
    if fault == "skip_step":
        AdamW.step = lambda self, lr: None
    try:
        btc = BridgeTrainConfig(horizon=CS.CTRL_HORIZON, learning_rate=lr)
        bt = BT.DiffusionControllerTrainer(BridgeControllerConfig(horizon=CS.CTRL_HORIZON), btc,
                                           os.path.join(ROOT, "build", "fault_ctrl"),
                                           data.stats, seed=0)
        b = CS.train_loop(bt, data, CS.CTRL_STEPS, lr, False)
        ltc = dataclasses.replace(LSTMTrainConfig(horizon=CS.CTRL_HORIZON), learning_rate=lr)
        lt = LT.LSTMControllerTrainer(LSTMControllerConfig(), ltc,
                                      os.path.join(ROOT, "build", "fault_ctrl"), data.stats,
                                      image_encoder=bt.img, seed=0)
        lr_ = CS.train_loop(lt, lstm_data, CS.CTRL_STEPS, lr, True)
    finally:
        AdamW.step = step
    return {"bridger": CS.loss_fall(b["losses"]), "lstm": CS.loss_fall(lr_["losses"])}


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from vla_touch_tpu_torch.csrc import build

    build.build_all()
    data = CS.MemoryEpisodes(128 * CS.CTRL_STEPS, CS.CTRL_HORIZON, seed=11)
    lstm_data = CS.MemoryEpisodes(256 * CS.CTRL_STEPS, CS.CTRL_HORIZON, seed=13)
    for fault in sys.argv[1:] or FAULTS:
        fall = run(fault, data, lstm_data)
        print(f"{fault}: loss fall " + json.dumps(fall) + " (gate: at least "
              + json.dumps(CS.CTRL_FALL_MIN) + ")", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
