"""End-to-end Octopi planning workflow on synthetic data at tiny scale, on
the PyTorch port (``vla_touch_tpu_torch``): ``examples/planning_pipeline.py``'s
stages at its configurations, on the GPU unless told otherwise.

 1. synthetic tactile "videos" (two objects with distinct appearance)
 2. tiny CLIP video encoder init (the ViFiCLIP stand-in)
 3. projection + LoRA training through the real in-repo decoder
    (``planning/run_llm.py::train_projection_and_lora``)
 4. greedy test split -> predictions.json (``test_llm``)
 5. scenario reasoning with N tempered samples + best-of-n selection
    (``reason_llm``), dumping reason/*.json

Usage:  python examples/torch_planning_pipeline.py [workdir] [--epochs N]
        [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def synthetic_videos(workdir: str) -> dict:
    """Two 3-frame 32 x 32 JPEG "videos", sponge and brick, under
    ``workdir``: name -> directory."""
    import cv2

    videos = {}
    for i, name in enumerate(["sponge", "brick"]):
        vdir = os.path.join(workdir, f"video_{name}")
        os.makedirs(vdir, exist_ok=True)
        for t in range(3):
            img = np.full((32, 32, 3), 60 + 120 * i, np.uint8)
            img[8 * i: 8 * i + 8, :, 0] = 255  # a sensor-ish stripe
            cv2.imwrite(os.path.join(vdir, f"{t:03d}.jpg"), img)
        videos[name] = vdir
    return videos


def reasoning_chat() -> list:
    return [
        {"role": "user", "content":
         "Describe the object in the following tactile video(s).\n\n"
         "Object 1: <tact_tokens>"},
        {"role": "assistant", "content": "Object 1: soft, squishy."},
        {"role": "user", "content":
         "Which object is the soft one, A) sponge, B) brick? "
         "End with 'Answer: <letter>'."},
        {"role": "assistant", "content": "A) sponge"},
    ]


def qa_rows(videos: dict, reason_prompt: str) -> list:
    return [
        {"split": "train", "question": "the surface is <tact>",
         "tactile": [videos["sponge"]], "answer": "soft"},
        {"split": "train", "question": "the surface is <tact>",
         "tactile": [videos["brick"]], "answer": "hard"},
        {"split": "train", "question": reason_prompt,
         "tactile": [videos["sponge"]], "answer": "A) sponge"},
        {"split": "test", "question": "the surface is <tact>",
         "tactile": [videos["sponge"]], "answer": "soft"},
    ]


def main(workdir: str = "/tmp/vla_touch_torch_planning_demo", epochs: int = 100,
         device=None):
    """Every stage on ``device`` (None: the GPU)."""
    import torch

    from vla_touch_tpu_torch.models.encoders.vit import ViTConfig
    from vla_touch_tpu_torch.planning import encoder as PE
    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning.datasets import TactileLLMDataset
    from vla_touch_tpu_torch.planning.run_llm import (
        make_llm_interface, reason_llm, render_chat, test_llm, train_projection_and_lora)

    os.makedirs(workdir, exist_ok=True)

    print("== 1. synthetic tactile videos")
    videos = synthetic_videos(workdir)
    reason_chat = reasoning_chat()
    # Train the final reasoning turn on its exact rendered-chat prompt so
    # the tiny model's sampled candidates parse to an option letter.
    reason_prompt = render_chat(reason_chat[:-1]).replace("<tact_tokens>", "<tact>")
    qa_path = os.path.join(workdir, "qa.json")
    with open(qa_path, "w") as f:
        json.dump(qa_rows(videos, reason_prompt), f)

    print("== 2. tiny encoder + tiny real decoder")
    tiny_clip = ViTConfig(hidden_size=32, num_layers=1, num_heads=4,
                          mlp_dim=64, patch_size=16, image_size=32,
                          use_layerscale=False, quick_gelu=True,
                          use_pre_norm=True, layernorm_eps=1e-5,
                          patch_bias=False)
    enc_state = PE.init_tactile_encoder(tiny_clip, seed=0, device=device,
                                        dtype=torch.float32)
    cfg = L.qwen2_tiny(vocab_size=384, hidden_size=64, num_layers=2,
                       num_heads=4, num_kv_heads=2, mlp_dim=128)
    params = L.init_llm(cfg, seed=1, device=device)

    print("== 3. projection + LoRA training through the real decoder")
    train_ds = TactileLLMDataset([qa_path], split_name="train")
    out_dir = os.path.join(workdir, "llm_out")
    proj, lora = train_projection_and_lora(
        enc_state, cfg, params, train_ds, out_dir, epochs=epochs, lr=3e-3,
        lora_rank=8, frame_size=32)
    with open(os.path.join(out_dir, "llm_training.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    print(f"projection+LoRA training: loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    print("== 4. greedy test dump")
    iface = make_llm_interface(cfg, params, lora=lora, max_new_tokens=12)
    test_ds = TactileLLMDataset([qa_path], split_name="test")
    preds = test_llm(enc_state, iface, proj, test_ds, out_dir, frame_size=32)
    print(f"test predictions: {[p['prediction'] for p in preds]!r} -> "
          f"{os.path.join(out_dir, 'predictions.json')}")

    print("== 5. scenario reasoning with sampled best-of-n")
    reason_rows = [{
        "info": {"scenario": "sorting", "target": "sponge",
                 "tactile": [videos["sponge"]],
                 "objects": {"Object 1": "sponge"}, "num_candidates": 2},
        "chat": reason_chat,
    }]
    # generate_idx=() keeps the dataset description turn, so the final
    # prompt matches the trained one exactly at this toy scale.
    res = reason_llm(enc_state, iface, proj, reason_rows, out_dir,
                     reasoning_sampling_num=4, reasoning_temperature=0.15,
                     reasoning_selection_type="best_of_n",
                     generate_idx=(), frame_size=32)
    rec = res["sorting_sponge"][0]
    print("reasoning record: true answer "
          f"{rec['final_true_answer']!r}, option counts "
          f"{rec['option_counts']}, final generation "
          f"{rec['final_generation'][:48]!r}")
    print(f"reason dumps -> {os.path.join(out_dir, 'reason')}")
    print("== done; planning pipeline OK")
    return {"losses": losses, "predictions": preds, "reasoning": rec}


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workdir", nargs="?", default="/tmp/vla_touch_torch_planning_demo")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args()
    main(a.workdir, epochs=a.epochs, device=a.device)
