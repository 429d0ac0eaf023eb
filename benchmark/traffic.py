"""The one generator of the benchmark's inputs.  A traffic mix is a data
file, ``traffic/<mix>.json``; its ``kind`` says which driver runs it
(``drivers/<kind>.py``) and the rest are the parameters read here.

Every seed gets the same set of sizes (language lengths spread evenly over
the mix's range), in its own order, so that two seeds do the same work.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load(mix: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{mix}.json")) as f:
        return json.load(f)


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use, from the run's seed and a tag."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [
        int.from_bytes(str(t).encode()[:8].ljust(8, b"\0"), "little") & 0xFFFFFFFF
        for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def lang_lengths(lo: int, hi: int, n: int, rng) -> np.ndarray:
    """``n`` lengths spread evenly over [lo, hi], in a seeded order."""
    return rng.permutation(np.linspace(lo, hi, n).round().astype(int))


def frames(rng, n: int, size: int) -> np.ndarray:
    return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def serve_requests(traffic: dict, config: dict, seed: int) -> list:
    """The distinct requests the robots cycle through; request i belongs
    to robot i mod robots.  Each: the robot's state (drawn N(0, 1) in
    the policy's units, times its scale), its camera frames (all present),
    an instruction of 4096-wide embeddings."""
    rng = np.random.default_rng(sub_seed(seed, "requests"))
    pol = config["policy"]
    n = traffic["robots"] * traffic["requests_per_robot"]
    nf = pol["img_history_size"] * pol["num_cameras"]
    lens = lang_lengths(*traffic["lang_len"], n, rng)
    scale = np.asarray(pol["state_scale"], np.float32)
    out = []
    for i in range(n):
        L = int(lens[i])
        out.append(dict(
            proprio=(rng.standard_normal(len(scale)).astype(np.float32) * scale),
            images=frames(rng, nf, pol["image_size"]),
            image_mask=np.ones((nf,), bool),
            text_embeds=(traffic["text_std"] * rng.standard_normal(
                (L, config["rdt"]["lang_token_dim"]))).astype(np.float32),
            text_mask=np.ones((L,), bool)))
    return out


def train_samples(traffic: dict, config: dict, seed: int, n: int, rng) -> list:
    """``n`` finetuning samples as the consumer dataset emits them: the
    unified 128-wide state and action chunk, each condition masked with
    ``cond_mask_prob`` (control frequency to 0, state to the data's mean,
    the state's availability to 0, each frame to the background)."""
    data, pol, cfg = traffic["data"], config["policy"], config["rdt"]
    p = data["cond_mask_prob"]
    idx = np.asarray(pol["state_indices"])
    S, H = cfg["state_token_dim"], cfg["horizon"]
    nf = pol["img_history_size"] * pol["num_cameras"]
    lens = lang_lengths(*traffic["lang_len"], n, rng)
    mean = np.zeros((1, S), np.float32)
    mean[0, idx] = np.random.default_rng(sub_seed(seed, "state_mean")).standard_normal(len(idx))
    out = []
    for i in range(n):
        state = np.zeros((1, S), np.float32)
        state[0, idx] = rng.standard_normal(len(idx))
        actions = np.zeros((H, S), np.float32)
        actions[:, idx] = rng.standard_normal((H, len(idx)))
        indicator = np.zeros((S,), np.float32)
        indicator[idx] = 1.0
        imgs = frames(rng, nf, pol["image_size"])
        present = rng.random(nf) > p
        imgs[~present] = data["background"]
        out.append({
            "dataset_name": "benchmark",
            "ctrl_freq": float(pol["control_frequency"]) if rng.random() > p else 0.0,
            "states": state if rng.random() > p else mean.copy(),
            "actions": actions,
            "state_elem_mask": indicator if rng.random() > p else np.zeros_like(indicator),
            "state_norm": np.abs(rng.standard_normal(S)).astype(np.float32),
            "images": imgs,
            "image_mask": present,
            "lang_embed": (traffic["text_std"] * rng.standard_normal(
                (int(lens[i]), cfg["lang_token_dim"]))).astype(np.float32),
        })
    return out


def train_batches(traffic: dict, config: dict, seed: int, collate) -> list:
    """The mix's distinct collated batches (``collate``: the program's
    collator, padding language to the model's length); every row of
    every batch differs."""
    rng = np.random.default_rng(sub_seed(seed, "batches"))
    n = traffic["recipe"]["batch_size"] * traffic["recipe"]["grad_accum"]
    return [collate(train_samples(traffic, config, seed, n, rng),
                    max_lang_len=config["rdt"]["max_lang_cond_len"])
            for _ in range(traffic["distinct_batches"])]
