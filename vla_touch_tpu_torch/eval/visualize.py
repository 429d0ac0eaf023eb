"""Plots for the controller evaluations and the GelSight tracker
(counterpart of ``vla_touch_tpu/eval/visualize.py``): expert vs VLA vs
refined trajectories per action dimension with an error panel, and the
marker displacement field.  Inputs are numpy arrays or tensors (moved to
the host).  ``matplotlib`` is optional: it is imported when a function
draws, and its absence raises ``RuntimeError``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _pyplot():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError("matplotlib not installed; visualization is optional") from e
    return plt


def _host(a) -> np.ndarray:
    """A numpy array of ``a`` (a tensor is detached and moved to the CPU)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def plot_trajectory_comparison(expert, vla, refined, out_path: str,
                               dims: Optional[Sequence[int]] = None,
                               dim_names: Optional[Sequence[str]] = None) -> str:
    """Save a 4-panel figure for one sample: three trajectory panels
    (selected dims) and the per-step error norms.  expert/vla/refined:
    (T, D)."""
    plt = _pyplot()
    expert, vla, refined = (_host(a) for a in (expert, vla, refined))
    T, D = expert.shape
    dims = list(dims) if dims is not None else list(range(min(3, D)))
    names = list(dim_names) if dim_names is not None else [f"dim {d}" for d in dims]

    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    t = np.arange(T)
    for ax, d, name in zip(axes.flat[:3], dims, names):
        ax.plot(t, expert[:, d], "k-", label="expert")
        ax.plot(t, vla[:, d], "b--", label="VLA")
        ax.plot(t, refined[:, d], "r-", label="refined")
        ax.set_title(name)
        ax.legend(fontsize=8)
    err_ax = axes.flat[3]
    err_ax.plot(t, np.linalg.norm(vla - expert, axis=-1), "b--", label="VLA error")
    err_ax.plot(t, np.linalg.norm(refined - expert, axis=-1), "r-", label="refined error")
    err_ax.set_title("per-step L2 error")
    err_ax.legend(fontsize=8)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_marker_field(frame, baseline: dict, result: dict, out_path: str) -> str:
    """The GelSight frame with displacement arrows from the calibration
    grid (valid cells) and the mean-force vector."""
    plt = _pyplot()
    frame = _host(frame)
    cents = _host(baseline["centroids"])
    disp = _host(result["displacement"])
    valid = _host(result["valid"]).astype(bool)
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.imshow(frame, cmap="gray" if frame.ndim == 2 else None)
    ax.quiver(cents[valid, 0], cents[valid, 1], disp[valid, 0], disp[valid, 1],
              color="lime", angles="xy", scale_units="xy", scale=0.3, width=0.004)
    md = _host(result["mean_disp"])
    cx, cy = frame.shape[1] / 2, frame.shape[0] / 2
    ax.arrow(cx, cy, float(md[0]) * 5, float(md[1]) * 5, color="red", width=1.0,
             length_includes_head=True)
    ax.set_title(f"|F| = {float(_host(result['magnitude'])):.2f}")
    ax.set_axis_off()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_samples(expert_b, vla_b, refined_b, out_dir: str, max_samples: int = 4) -> list:
    """``trajectory_{i}.png`` for the first ``max_samples`` rows of a batch
    (the evaluations' ``visualize_dir``)."""
    expert_b, vla_b, refined_b = (_host(a) for a in (expert_b, vla_b, refined_b))
    return [plot_trajectory_comparison(expert_b[i], vla_b[i], refined_b[i],
                                       os.path.join(out_dir, f"trajectory_{i}.png"))
            for i in range(min(max_samples, expert_b.shape[0]))]
