"""Plain reference of one served action chunk: the robot state packed into
RDT's 128-wide unified vector, SigLIP over the request's frames, the two
conditions adapted once, DPM-Solver++ (2M, "linspace" steps, first order at
the first and the last step, the final sigma 0; Lu et al.,
arXiv:2211.01095) over the chunk, and the chunk unpacked to robot units.

Float32 throughout; the schedule's tables in float64.  The language
condition is the request's own tokens, unpadded: padding is the program's
business and must not change a row.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model as M


def alphas_cumprod(noise_cfg: dict) -> np.ndarray:
    """float64 cumulative alphas of the ``squaredcos_cap_v2`` betas (capped at 0.999)."""
    if noise_cfg["beta_schedule"] != "squaredcos_cap_v2":
        raise ValueError(noise_cfg["beta_schedule"])
    T = noise_cfg["num_train_timesteps"]

    def alpha_bar(t):
        return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

    i = np.arange(T, dtype=np.float64)
    betas = np.minimum(1.0 - alpha_bar((i + 1) / T) / alpha_bar(i / T), 0.999)
    return np.cumprod(1.0 - betas)


def dpm_tables(noise_cfg: dict) -> dict:
    """Solver timesteps, alpha, sigma, lambda (entry i: before step i) and
    the first-order flags."""
    T, steps = noise_cfg["num_train_timesteps"], noise_cfg["num_inference_timesteps"]
    acp = alphas_cumprod(noise_cfg)
    ts = np.linspace(0, T - 1, steps + 1).round()[::-1][:-1].astype(np.int64)
    sig = np.interp(ts, np.arange(T), np.sqrt((1 - acp) / acp))
    sig = np.concatenate([sig, [0.0]])
    alpha = 1.0 / np.sqrt(1.0 + sig ** 2)
    sigma = sig * alpha
    lam = np.log(np.maximum(alpha, 1e-20)) - np.log(np.maximum(sigma, 1e-20))
    first = np.zeros(steps, bool)
    first[0] = True
    if steps < 15:
        first[-1] = True
    return dict(timesteps=ts, alpha=alpha, sigma=sigma, lam=lam, first=first)


def dpm_solve(model_fn, x, noise_cfg: dict):
    """DPM-Solver++ 2M in data-prediction space from pure noise ``x``."""
    if noise_cfg["prediction_type"] != "sample":
        raise ValueError(noise_cfg["prediction_type"])
    tb = dpm_tables(noise_cfg)
    x0_prev = None
    for i, t in enumerate(tb["timesteps"]):
        x0 = model_fn(x, torch.full((x.shape[0],), int(t), dtype=torch.int32,
                                    device=x.device))
        h = tb["lam"][i + 1] - tb["lam"][i]
        phi = np.expm1(-h)
        x_next = (float(tb["sigma"][i + 1] / tb["sigma"][i]) * x
                  - float(tb["alpha"][i + 1] * phi) * x0)
        if not tb["first"][i]:
            r = float((tb["lam"][i] - tb["lam"][i - 1]) / h)
            x_next = x_next - float(0.5 * tb["alpha"][i + 1] * phi) * (x0 - x0_prev) / r
        x, x0_prev = x_next, x0
    return x


def pack_state(policy: dict, proprio, state_dim: int):
    """Robot state (B, d) -> the unified (B, 1, state_dim) vector and its
    availability mask: each value over its scale at its index."""
    idx = torch.tensor(policy["state_indices"], device=proprio.device)
    scale = torch.tensor(policy["state_scale"], dtype=torch.float32, device=proprio.device)
    B = proprio.shape[0]
    state = torch.zeros((B, state_dim), device=proprio.device)
    mask = torch.zeros((B, state_dim), device=proprio.device)
    state[:, idx] = proprio.float() / scale
    mask[:, idx] = 1.0
    return state[:, None], mask[:, None]


def unpack_chunk(policy: dict, chunk):
    """(B, horizon, state_dim) -> (B, horizon, d) robot units."""
    idx = torch.tensor(policy["state_indices"], device=chunk.device)
    scale = policy.get("action_scale") or policy["state_scale"]
    return chunk[:, :, idx] * torch.tensor(scale, dtype=torch.float32, device=chunk.device)


@torch.no_grad()
def served_chunk(ref: M.Ref, config: dict, request: dict, noise):
    """One request's chunk in robot units.  ``request``: proprio (d,),
    images (F, S, S, 3) uint8, image_mask (F,), text_embeds (L, Dl) (its
    real tokens); ``noise`` (horizon, state_dim) float32: the solver's
    starting point."""
    cfg, policy = config["rdt"], config["policy"]
    dev = noise.device
    proprio = torch.as_tensor(request["proprio"], device=dev)[None]
    images = torch.as_tensor(request["images"], device=dev)[None]
    image_mask = torch.as_tensor(request["image_mask"], device=dev)[None]
    text = torch.as_tensor(request["text_embeds"], device=dev)[None].float()
    img_tokens = M.encode_frames(ref, config["vision"], images, image_mask)
    state, mask = pack_state(policy, proprio, cfg["state_token_dim"])
    lang_c, img_c = M.adapt_conditions(ref, cfg, text, img_tokens)
    state_traj = M.adaptor(ref, "state_adaptor", cfg["state_adaptor"],
                           torch.cat([state, mask], dim=2))
    mask_h = mask.expand(1, cfg["horizon"], cfg["state_token_dim"])
    freq = torch.full((1,), float(policy["control_frequency"]), device=dev)

    def model_fn(x, t):
        a = M.adaptor(ref, "state_adaptor", cfg["state_adaptor"], torch.cat([x, mask_h], dim=2))
        return M.rdt_forward(ref, cfg, torch.cat([state_traj, a], dim=1), freq, t,
                             lang_c, img_c)

    chunk = dpm_solve(model_fn, noise.float()[None], config["noise"]) * mask_h
    return unpack_chunk(policy, chunk)[0]
