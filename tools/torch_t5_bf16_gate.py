#!/usr/bin/env python3
"""How far T5-XXL's hidden states move when the encoder computes in bf16,
against float32 on the same (bf16-valued) weights, both on the CPU: the
yardstick of ``chip_smoke.py``'s T5 gate (bf16 on the card against float32
on the CPU), with the two planted faults the gate must see.

    python3 tools/torch_t5_bf16_gate.py [seed ...]

The model is the phase's (``chip_smoke.t5_phase_encoder``: seeded, q
scaled by d_kv^-0.5, the bucket table N(0, 1)) at full width (d_model
4096, 64 heads of 64, d_ff 10240) cut to ``T5_GATE_LAYERS`` layers, on the
phase's gate instruction (``T5_GATE_TOKENS`` byte tokens).  Prints one JSON
line per seed: the relative L2 error and corr of bf16 against float32, and
the relative L2 error of bf16 under each fault (~2 GB of memory, ~1 min a
seed).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from vla_touch_tpu_torch.models.encoders import t5_native as TT

    for seed in [int(a) for a in argv] or [0]:
        cfg = dataclasses.replace(TT.t5_v1_1_xxl(), num_layers=CS.T5_GATE_LAYERS)
        enc = CS.t5_phase_encoder(cfg, seed, "cpu")
        tok = CS.ByteT5Tokenizer(cfg.vocab_size, seed)
        ids = torch.as_tensor([tok(CS.byte_text(CS.T5_GATE_TOKENS - 1, seed=1))["input_ids"]])
        print(json.dumps(dict(seed=seed, **CS.t5_bf16_vs_float32(enc, ids))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
