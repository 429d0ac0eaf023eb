"""Capture labeling and GelSight review in the terminal (counterpart of
``vla_touch_tpu/data/label_tool.py``).

- :func:`run_labeler` steps through unlabeled episode directories, shows a
  frame contact sheet, prompts for the instruction (with reusable numbered
  suggestions) and writes ``instruction.txt``;
- :func:`review_gelsight` renders the tracked marker field (baseline grid,
  displacement arrows, force readout) over each GelSight frame into an
  image sequence, ``forces.csv`` and an html index.

Both run headless: the labeler takes an ``input_fn`` / ``print_fn`` pair
(tests drive it with scripted answers), the reviewer writes plain files.

    python -m vla_touch_tpu_torch.data.label_tool label CAPTURE_ROOT [--relabel]
    python -m vla_touch_tpu_torch.data.label_tool review EPISODE_DIR [--device cpu]
"""

from __future__ import annotations

import html
import os
from typing import Callable, Optional, Sequence

import numpy as np

from vla_touch_tpu_torch.data.capture import _load_frames, _sorted_frames


def episode_dirs(capture_root: str) -> list:
    out = []
    for name in sorted(os.listdir(capture_root)):
        d = os.path.join(capture_root, name)
        if os.path.isdir(d) and os.path.isdir(os.path.join(d, "camera1")):
            out.append(d)
    return out


def contact_sheet(episode_dir: str, camera: str = "camera1", n_frames: int = 6,
                  tile: int = 160) -> np.ndarray:
    """Evenly sampled frames tiled into one (tile, n * tile, 3) RGB strip."""
    import cv2

    paths = _sorted_frames(os.path.join(episode_dir, camera))
    if not paths:
        raise FileNotFoundError(f"no frames under {episode_dir}/{camera}")
    idx = np.linspace(0, len(paths) - 1, min(n_frames, len(paths)), dtype=int)
    tiles = [cv2.resize(cv2.imread(paths[int(i)])[:, :, ::-1], (tile, tile)) for i in idx]
    return np.concatenate(tiles, axis=1)


def _ascii_preview(sheet: np.ndarray, width: int = 72, height: int = 9) -> str:
    """Luma -> an ascii ramp, so the operator sees the sheet over a plain
    terminal (the png is written beside the episode too)."""
    ramp = " .:-=+*#%@"
    g = sheet.astype(np.float32).mean(-1)
    ys = np.linspace(0, g.shape[0] - 1, height, dtype=int)
    xs = np.linspace(0, g.shape[1] - 1, width, dtype=int)
    q = (g[np.ix_(ys, xs)] / 255.0 * (len(ramp) - 1)).round().astype(int)
    return "\n".join("".join(ramp[v] for v in row) for row in q)


def run_labeler(capture_root: str, *, relabel: bool = False,
                input_fn: Optional[Callable[[str], str]] = None,
                print_fn: Callable[[str], None] = print, camera: str = "camera1",
                save_sheets: bool = True) -> dict:
    """Step through episodes, prompt for instructions, write
    ``instruction.txt`` per episode; returns {episode_dir: instruction}.

    Answers: free text (the instruction), ``<number>`` (reuse a numbered
    earlier instruction), ``=`` (repeat the last), ``-`` (skip the
    episode), ``q`` (stop; the remaining episodes stay untouched)."""
    input_fn = input_fn or input          # bound late so tests can patch builtins
    seen: list = []
    labeled: dict = {}
    last: Optional[str] = None
    for d in episode_dirs(capture_root):
        path = os.path.join(d, "instruction.txt")
        if os.path.exists(path) and not relabel:
            continue
        try:
            sheet = contact_sheet(d, camera=camera)
            if save_sheets:
                import cv2

                cv2.imwrite(os.path.join(d, "contact_sheet.png"), sheet[:, :, ::-1])
            print_fn(_ascii_preview(sheet))
        except Exception as e:  # no camera frames: the episode can still be labeled
            print_fn(f"[no preview: {e}]")
        print_fn(f"episode: {os.path.basename(d)}")
        for i, s in enumerate(seen):
            print_fn(f"  {i}: {s}")
        text = None
        while text is None:
            ans = input_fn("instruction (text | #num | = | - | q): ").strip()
            if ans in ("q", "-"):
                break
            if ans == "=":
                if last is None:
                    print_fn("no previous instruction to repeat")
                    continue
                text = last
            elif ans.isdigit():
                if int(ans) < len(seen):
                    text = seen[int(ans)]
                else:
                    # bare digits are command syntax, never a label
                    print_fn(f"no suggestion #{ans} ({len(seen)} available)")
            elif ans:
                text = ans
        if text is None:
            if ans == "q":
                break
            continue
        with open(path, "w") as f:
            f.write(text + "\n")
        labeled[d] = text
        last = text
        if text not in seen:
            seen.append(text)
    return labeled


def review_gelsight(episode_dir: str, out_dir: Optional[str] = None, tracker_cfg=None,
                    stride: int = 1, max_frames: int = 200, device=None) -> dict:
    """Render the marker tracking (on ``device``, default CUDA) over each
    GelSight frame: ``marker_XXXXXX.png`` overlays, ``index.html`` and
    ``forces.csv`` in ``out_dir`` (default ``episode_dir/gelsight_review``).
    Returns summary statistics."""
    import torch

    from vla_touch_tpu_torch.eval.visualize import plot_marker_field
    from vla_touch_tpu_torch.ops import marker_tracking as MT
    from vla_touch_tpu_torch.utils.device import resolve_device

    cfg = tracker_cfg or MT.TrackerConfig()
    gel_dir = os.path.join(episode_dir, "gelsight")
    paths = _sorted_frames(gel_dir)[::stride][:max_frames]
    if not paths:
        raise FileNotFoundError(f"no gelsight frames under {gel_dir}")
    host = _load_frames(paths)
    frames = torch.as_tensor(host, device=resolve_device(device))
    out_dir = out_dir or os.path.join(episode_dir, "gelsight_review")
    os.makedirs(out_dir, exist_ok=True)

    baseline = MT.calibrate(frames[0], cfg)
    rows, pngs = [], []
    for i in range(len(paths)):
        res = MT.estimate_force(frames[i], baseline, cfg)
        name = f"marker_{i:06d}.png"
        plot_marker_field(host[i], baseline, res, out_path=os.path.join(out_dir, name))
        pngs.append(name)
        f = res["force"].cpu().numpy().reshape(-1)
        rows.append((i,) + tuple(float(v) for v in f))

    with open(os.path.join(out_dir, "forces.csv"), "w") as f:
        f.write("frame,fx,fy,mag\n")
        for r in rows:
            f.write(",".join(f"{v}" for v in r) + "\n")
    items = "\n".join(f'<div><h4>frame {i}</h4><img src="{html.escape(p)}" width="480"/></div>'
                      for i, p in enumerate(pngs))
    with open(os.path.join(out_dir, "index.html"), "w") as f:
        f.write(f"<html><body><h2>{html.escape(episode_dir)}</h2>{items}</body></html>")
    mags = np.array([r[3] for r in rows])
    return {"frames": len(rows), "out_dir": out_dir,
            "max_force": float(mags.max()), "mean_force": float(mags.mean())}


def main(argv: Optional[Sequence[str]] = None):
    import argparse

    p = argparse.ArgumentParser(description="Label captured episodes / review GelSight tracking")
    sub = p.add_subparsers(dest="cmd", required=True)
    pl = sub.add_parser("label")
    pl.add_argument("capture_root")
    pl.add_argument("--relabel", action="store_true")
    pl.add_argument("--camera", default="camera1")
    pr = sub.add_parser("review")
    pr.add_argument("episode_dir")
    pr.add_argument("--out_dir", default=None)
    pr.add_argument("--stride", type=int, default=1)
    pr.add_argument("--device", default=None, help="default CUDA")
    args = p.parse_args(argv)
    if args.cmd == "label":
        labeled = run_labeler(args.capture_root, relabel=args.relabel, camera=args.camera)
        print(f"labeled {len(labeled)} episodes")
    else:
        print(review_gelsight(args.episode_dir, out_dir=args.out_dir, stride=args.stride,
                              device=args.device))


if __name__ == "__main__":
    main()
