"""AdamW in optax's order (``optax.adamw``: b1 0.9, b2 0.999, eps 1e-8,
decay on every parameter), over multi-tensor ``torch._foreach`` operations:

    mu <- (1 - b1) g + b1 mu,   nu <- (1 - b2) g^2 + b2 nu,   n <- n + 1
    u  <- (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps) + wd p
    p  <- p + (-lr) u

``torch.optim.AdamW`` decays the parameter before the moment step and folds
the bias corrections differently; its default decay is 1e-2.  The learning
rate is an argument of each step (the trainers compute it on the host).
"""

from __future__ import annotations

import numpy as np
import torch


class AdamW:
    def __init__(self, params, weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr: float) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        b1, b2 = self.b1, self.b2
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        n = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(b1) ** n)
        bc2 = float(np.float32(1) - np.float32(b2) ** n)
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(u, -float(np.float32(lr)))
        torch._foreach_add_(self.params, u)


def float32_math() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions.  The trainers
    run in float32, as the JAX package's do; PyTorch's default lets cuDNN's
    convolutions (the UNet's ``F.conv1d``, forward and backward) take TF32
    inputs.  Process-wide: these are global switches of ``torch.backends``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
