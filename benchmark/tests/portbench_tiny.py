"""Tiny cells for the benchmark's CPU tests: the serving and finetuning
mixes at ``rdt_tiny``'s widths with a one-layer SigLIP of 28^2 frames (4
patches a frame, 24 image tokens over 6 frames), computing in float32."""

from __future__ import annotations

import copy

from benchmark import harness as HN

FAKE_DEVICE = {"platform": "gpu", "kind": "none (CPU test)", "count": 1,
               "memory_peak_bytes": 0}


def tiny_config() -> dict:
    cfg = copy.deepcopy(HN.read_json(f"{HN.HERE}/configs/rdt1b.json"))
    cfg["rdt"].update(hidden_size=128, depth=2, num_heads=4, horizon=8, max_lang_cond_len=16,
                      img_cond_len=24, lang_token_dim=32, img_token_dim=48,
                      img_pos_embed_grid=[2, -3, 4], dtype="float32")
    cfg["vision"].update(hidden_size=48, num_layers=1, num_heads=4, mlp_dim=96, image_size=28,
                         dtype="float32")
    cfg["policy"]["image_size"] = 28
    return cfg


def tiny_cell(workload: str) -> dict:
    """``workload``'s cell (its limits and metrics) at the tiny size."""
    cell = HN.cell(workload)
    cell["config"] = tiny_config()
    tr = cell["traffic"]
    tr["lang_len"] = [4, 16]
    if tr["kind"] == "serve":
        tr.update(robots=3, requests_per_robot=2)
        tr["pool"].update(max_batch=4, buckets=[1, 2, 4])
        tr["check"]["sample"] = 4
    else:
        tr["distinct_batches"] = 3
        tr["data"]["image_size"] = 28
    return cell
