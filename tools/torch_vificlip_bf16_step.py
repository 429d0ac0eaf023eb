#!/usr/bin/env python3
"""How far one contrastive loss and gradient of the ViFiCLIP model moves
when its towers compute in bf16 over float32 master weights, against the
same step in float32, both on the CPU: the yardstick for the card-vs-CPU
gates of ``tests/test_torch_cuda.py`` and of ``chip_smoke.py``'s
``tactile_encoder_phase`` (bf16 on the card against float32 on the CPU).

    python3 tools/torch_vificlip_bf16_step.py [tiny] [full]

``tiny``: the card test's model (prompt-learned, 2 layers, 128 wide, 2
heads of 64, 4 videos x 2 frames of 32^2).  ``full``: the phase's
depth-cut model (CLIP ViT-B/16 and text B/16 at 2 layers, 4 prompts,
projections to 512, 8 videos x 4 frames of 224^2; ~1 min).  Prints, per
model, the loss's relative error, the gradient's relative L2 error and
their correlation, the text tower frozen.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def models():
    from vla_touch_tpu_torch.models.encoders import clip_text as CT
    from vla_touch_tpu_torch.models.encoders import vit as V

    tiny_v = V.ViTConfig(hidden_size=128, num_layers=2, num_heads=2, mlp_dim=256,
                         patch_size=16, image_size=32, use_layerscale=False, quick_gelu=True,
                         use_pre_norm=True, layernorm_eps=1e-5, patch_bias=False)
    tiny_t = CT.CLIPTextConfig(vocab_size=64, hidden_size=128, num_layers=2, num_heads=2,
                               mlp_dim=256, max_positions=16, eos_token_id=63)
    return {
        "tiny": (tiny_v, tiny_t, dict(prompt_learning=True, num_prompts=2,
                                      prompt_depth_vision=1, prompt_depth_text=1,
                                      projection_dim=64), (4, 2, 32, 12)),
        "full": (dataclasses.replace(V.CLIP_VIT_B16, num_layers=2),
                 dataclasses.replace(CT.CLIP_TEXT_B16, num_layers=2),
                 dict(prompt_learning=True, num_prompts=4, prompt_depth_vision=9,
                      prompt_depth_text=9, projection_dim=512), (8, 4, 224, 77)),
    }


def bf16_vs_float32(vc, tc, kw, shape) -> dict:
    import numpy as np
    import torch

    from vla_touch_tpu_torch.models.encoders import vit as V
    from vla_touch_tpu_torch.planning import encoder as PE
    from vla_touch_tpu_torch.planning import train_encoder as TE

    B, L, S, Lt = shape
    rng = np.random.default_rng(0)
    ids = rng.integers(0, tc.eos_token_id, (B, Lt))
    ids[:, -1] = tc.eos_token_id
    batch = {"frames": rng.normal(size=(B, L, S, S, 3)).astype(np.float32), "input_ids": ids}
    base = PE.init_vificlip_model(vc, tc, seed=0, device="cpu", **kw)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        m = V.master_weights_(copy.deepcopy(base), dt).requires_grad_(True)
        m.text.requires_grad_(False)
        loss = TE.contrastive_loss(m, batch, "cpu")
        loss.backward()
        grads = [p.grad.double().flatten() for p in m.parameters() if p.grad is not None]
        out[dt] = (float(loss.detach()), torch.cat(grads))
    (l32, a), (l16, b) = out[torch.float32], out[torch.bfloat16]
    return dict(loss_rel_err=abs(l16 - l32) / abs(l32),
                grad_l2_rel=float((b - a).norm() / a.norm()),
                grad_corr=float(torch.corrcoef(torch.stack([a, b]))[0, 1]))


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    table = models()
    for name in argv or ["tiny", "full"]:
        print(name, json.dumps(bf16_vs_float32(*table[name])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
