"""Pack episodes into native ``.epc`` caches for training IO (counterpart of
``vla_touch_tpu/data/pack_epc.py``).

One-time conversion feeding ``--data_format epc`` (``train/rdt_loop.py``,
``train/bridge_train.py``, ``train/lstm_train.py``): the trainers then read
episodes through the mmap'd C++ cache (``runtime/native/episode_cache.cpp``).

Usage:
    python -m vla_touch_tpu_torch.data.pack_epc DATASET_DIR [--out OUT_DIR]
        [--codec jpeg|raw] [--quality 90] [--use_resized]

``--codec raw`` stores frames losslessly (the samples drawn from the cache
are those of the source files, bit for bit); the default ``jpeg``
re-encodes at ``--quality`` (far smaller files; the deployment loop
JPEG-round-trips frames anyway).  Episodes are ``.h5`` (needs ``h5py``) or
the port's ``.npz`` files.
"""

from __future__ import annotations

import argparse
import os

from vla_touch_tpu_torch.data.episode import list_episode_files
from vla_touch_tpu_torch.runtime.native_loader import pack_episode


def pack_dataset(data_dir: str, out_dir: str | None = None, codec: str = "jpeg",
                 quality: int = 90, use_resized: bool = False) -> list:
    """Every episode under ``data_dir`` into ``out_dir`` (default
    ``data_dir``) as ``<stem>.epc``.  ``use_resized`` packs the distillation
    pass's ``camera{N}_resized`` frames as the camera streams: the layout
    the controller trainers read (``ControllerDataset(data_format='epc')``)."""
    out_dir = out_dir or data_dir
    os.makedirs(out_dir, exist_ok=True)
    outs = []
    for p in list_episode_files(data_dir, pattern=(".h5", ".npz")):
        stem = os.path.splitext(os.path.basename(p))[0]
        out = os.path.join(out_dir, stem + ".epc")
        pack_episode(p, out, jpeg_quality=quality, codec=codec, use_resized=use_resized)
        outs.append(out)
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("data_dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--codec", default="jpeg", choices=("jpeg", "raw"))
    ap.add_argument("--quality", type=int, default=90)
    ap.add_argument("--use_resized", action="store_true",
                    help="pack camera{N}_resized (the controller trainers' layout)")
    args = ap.parse_args(argv)
    outs = pack_dataset(args.data_dir, args.out, args.codec, args.quality,
                        use_resized=args.use_resized)
    for o in outs:
        print(o)
    print(f"packed {len(outs)} episodes")


if __name__ == "__main__":
    main()
