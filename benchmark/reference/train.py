"""Plain reference of RDT finetuning steps: the frozen SigLIP encode, the
diffusion loss (the chunk noised to a timestep, the clean chunk as the
target, the mean squared error), its gradients through autograd, the
micro-batches' gradients averaged, then optax's order: clip by the global
norm, AdamW (bias-corrected moments, decoupled weight decay) at the rate
the warm-up schedule gives the step's count.

Float32 with TF32 off.  The parameters are a dict of checkpoint names; the
language condition of a micro-batch is cut to its longest instruction (the
rest is masked padding).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model as M
from benchmark.reference.serve import alphas_cumprod


def diffusion_loss(ref: M.Ref, config: dict, mb: dict, img_tokens, noise, timesteps):
    """One micro-batch's loss: ``mb`` holds lang_tokens, lang_mask,
    state_tokens (B, 1, S), action_gt (B, horizon, S), action_mask (B, 1,
    S), ctrl_freqs (B,), all on the device."""
    cfg = config["rdt"]
    acp = torch.as_tensor(alphas_cumprod(config["noise"]), device=noise.device)
    t = timesteps.long()
    sa = acp[t].sqrt().float()[:, None, None]
    sn = (1.0 - acp[t]).sqrt().float()[:, None, None]
    x0 = mb["action_gt"].float()
    noisy = sa * x0 + sn * noise
    traj = torch.cat([mb["state_tokens"].float(), noisy], dim=1)
    traj = torch.cat([traj, mb["action_mask"].float().expand(traj.shape)], dim=2)
    L = int(mb["lang_mask"].sum(dim=1).max())
    lang_c, img_c = M.adapt_conditions(ref, cfg, mb["lang_tokens"][:, :L].float(), img_tokens)
    x = M.adaptor(ref, "state_adaptor", cfg["state_adaptor"], traj)
    pred = M.rdt_forward(ref, cfg, x, mb["ctrl_freqs"].float(), timesteps, lang_c, img_c,
                         mb["lang_mask"][:, :L])
    if config["noise"]["prediction_type"] != "sample":
        raise ValueError(config["noise"]["prediction_type"])
    return torch.mean(torch.square(pred - x0))


def warmup_lr(recipe: dict, count: int) -> float:
    """The rate at update ``count`` (0-based): linear from 0 over the
    warm-up steps, then constant."""
    lr, warm = recipe["learning_rate"], recipe["lr_warmup_steps"]
    if recipe["lr_scheduler"] not in ("constant", "constant_with_warmup"):
        raise ValueError(recipe["lr_scheduler"])
    return lr if warm <= 0 or count >= warm else lr * count / warm


class AdamW:
    """optax.chain(clip_by_global_norm, adamw): the state by name."""

    def __init__(self, recipe: dict, params: dict):
        self.recipe = recipe
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Updates ``params`` in place; returns the clipped gradients."""
        r = self.recipe
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())).float()
        if float(norm) >= r["max_grad_norm"]:
            grads = {n: g / norm * r["max_grad_norm"] for n, g in grads.items()}
        lr = warmup_lr(r, self.count)
        self.count += 1
        b1, b2 = r["adam_beta1"], r["adam_beta2"]
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for n, p in params.items():
            g = grads[n]
            self.mu[n] = (1 - b1) * g + b1 * self.mu[n]
            self.nu[n] = (1 - b2) * g * g + b2 * self.nu[n]
            u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + r["adam_epsilon"])
            p.add_(-lr * (u + r["weight_decay"] * p))
        return grads


def train_steps(ref: M.Ref, vision: M.Ref, config: dict, recipe: dict, batches: list,
                draws: list, micro_batch: int) -> dict:
    """``len(batches)`` optimizer steps from ``ref``'s weights (updated in
    place; float32 leaves).  ``batches``: dicts of device tensors with
    images (N, F, S, S, 3) uint8 and image_mask beside the loss's keys;
    ``draws``: per step (noise (N, horizon, S), timesteps (N,)).  Returns
    per step the loss, and after the first step the clipped gradients (as
    the optimizer took them)."""
    params = ref.weights
    opt = AdamW(recipe, params)
    out = {"loss": [], "first_grads": None}
    for batch, (noise, timesteps) in zip(batches, draws):
        tokens = M.encode_frames(vision, config["vision"], batch["images"], batch["image_mask"])
        n = noise.shape[0]
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        loss_sum = 0.0
        for s in range(0, n, micro_batch):
            sl = slice(s, s + micro_batch)
            mb = {k: v[sl] for k, v in batch.items()}
            with torch.enable_grad():
                leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
                loss = diffusion_loss(M.Ref(leaves, ref.precision), config, mb, tokens[sl],
                                      noise[sl], timesteps[sl])
                g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            for (k, _), gi in zip(leaves.items(), g):
                if gi is not None:
                    grads[k] += gi
            loss_sum += float(loss.detach())
            del g, loss, leaves
        n_micro = -(-n // micro_batch)
        grads = {k: v / n_micro for k, v in grads.items()}
        clipped = opt.step(params, grads)
        out["loss"].append(loss_sum / n_micro)
        if out["first_grads"] is None:
            out["first_grads"] = clipped
        del grads, clipped
    return out


def worst_leaf_gap(got: dict, want: dict, keep=None, own=False) -> tuple:
    """The gap between two sets of leaf norms by the worst leaf, each gap
    over the larger of the reference's norm of that leaf and its median
    leaf's (``own``: over that leaf's alone): (gap, leaf)."""
    names = [k for k in want if keep is None or k in keep]
    median = 0.0 if own else float(np.median([want[k] for k in names]))
    worst, at = 0.0, None
    for k in names:
        gap = abs(got[k] - want[k]) / max(want[k], median, 1e-30)
        if gap > worst:
            worst, at = gap, k
    return worst, at
