"""Level-1 zstd through libzstd (``vla_touch_tpu_torch/utils/zstd.py``) per
byte over chunk sizes, on one thread, and the port's orbax writer and reader
over a tree of float32 leaves on the thread pool they use: the measurement
behind ``utils/zarr2.py::CHUNK_BYTES``.

    python3 tools/torch_orbax_chunk_rate.py [--tree-gib G] [--dir DIR]

Data: seeded float32 normals (Adam-moment-like values compress little).
Prints one JSON line per measurement.  Host only: no card is used.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vla_touch_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from vla_touch_tpu_torch.utils import zstd  # noqa: E402

SIZES_MB = (0.25, 1, 4, 16, 64, 256)


def chunk_rates(rng) -> None:
    for mb in SIZES_MB:
        data = rng.standard_normal(int(mb * 2 ** 20) // 4).astype(np.float32)
        reps = max(1, int(256 // mb))
        t0 = time.perf_counter()
        for _ in range(reps):
            frame = zstd.compress(data)
        c_s = (time.perf_counter() - t0) / reps
        out = np.empty_like(data)
        t0 = time.perf_counter()
        for _ in range(reps):
            zstd.decompress(frame, into=out)
        d_s = (time.perf_counter() - t0) / reps
        assert np.array_equal(out, data)
        print(json.dumps({"chunk_mb": mb, "compress_gb_s": data.nbytes / c_s / 1e9,
                          "decompress_gb_s": data.nbytes / d_s / 1e9,
                          "ratio": len(frame) / data.nbytes}), flush=True)


def tree_rates(rng, gib: float, where: str) -> None:
    leaf = 36 << 20   # RDT-1B's largest leaf
    n = max(1, int(gib * 2 ** 30) // leaf)
    tree = {f"l{i}": rng.standard_normal(leaf // 4).astype(np.float32) for i in range(n)}
    path = tempfile.mkdtemp(dir=where)
    try:
        t0 = time.perf_counter()
        nbytes = ckpt.save_pytree_orbax(os.path.join(path, "state.orbax"), tree)
        w_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ckpt.load_pytree_orbax(os.path.join(path, "state.orbax"))
        r_s = time.perf_counter() - t0
        assert all(np.array_equal(back[k], v) for k, v in tree.items())
        raw = sum(v.nbytes for v in tree.values())
        print(json.dumps({"tree_bytes": raw, "file_bytes": nbytes, "threads": ckpt._io_threads(),
                          "write_s": w_s, "read_s": r_s, "write_gb_s": raw / w_s / 1e9,
                          "read_gb_s": raw / r_s / 1e9}), flush=True)
    finally:
        shutil.rmtree(path, ignore_errors=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree-gib", type=float, default=1.0)
    p.add_argument("--dir", default=None, help="where the tree is written (a temp dir)")
    args = p.parse_args()
    rng = np.random.default_rng(0)
    print(json.dumps({"zstd_version": zstd.version_number(), "library": zstd.find_library(),
                      "cpus": os.cpu_count()}), flush=True)
    chunk_rates(rng)
    tree_rates(rng, args.tree_gib, args.dir)


if __name__ == "__main__":
    main()
