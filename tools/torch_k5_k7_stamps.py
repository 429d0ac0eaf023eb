#!/usr/bin/env python3
"""Where K5 (w8a16) and K7 (a8w8, large M) spend their time on one card:
per-CTA ``%globaltimer`` stamps in copies of this tree's kernels.

    python3 tools/torch_k5_k7_stamps.py

Builds copies of ``csrc/w8a16_matmul.cu`` and ``csrc/a8w8_matmul_large.cu``
under the ignored ``build/kernels/`` with a stamp written at each phase
boundary (one thread per CTA; the checkout is never edited), runs each at
its main shapes after a warm-up, and prints one JSON line per case:

- K5, per CTA: start -> first stage landed (0->1), the rest of the ring
  (1->2), the partials stored and pushed to their owners (2->3), the
  cluster barrier (3->4), the owner's sum and epilogue (4->5), as median and
  max over the CTAs, the spread of their starts and the SMs they ran on;
  under the plan the card takes and two others at (67, 2048, 2048); the
  clusters CUDA's occupancy calculator places for each (mt, wn, splits);
  and the device time of an empty grid of the same launch (a copy that
  returns at once), the floor a graph-replayed call cannot go under;
- K7, per CTA of the persistent grid: start -> its first stage landed, the
  main loops and epilogues of its tiles summed, its tiles, start -> end;
  the busiest SM's share of the span.

Needs one NVIDIA GPU.  No module of the package imports this script.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# a slot of 8 per CTA: 0..6 stamps or sums, 7 the SM
STAMP = r'''
__device__ unsigned long long vtt_stamps[16384 * 8];
__device__ __forceinline__ unsigned long long vtt_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void vtt_put(int k, unsigned long long v) {
  const unsigned b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (b < 16384) vtt_stamps[b * 8 + k] = v;
}
__device__ __forceinline__ void stamp(int k) { vtt_put(k, vtt_now()); }
__device__ __forceinline__ void stamp_sm() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  vtt_put(7, s);
}
'''
READ = r'''
extern "C" int read_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, vtt_stamps, (size_t)n * 64);
}
'''
K5_STAMPS = [
    ("namespace {\n", STAMP + "namespace {\n"),
    ("  const int nst = (c1 - c0 + WK - 1) / WK;\n",
     "  const int nst = (c1 - c0 + WK - 1) / WK;\n  if (tid == 0) { stamp(0); stamp_sm(); }\n"),
    ("    __syncthreads();                                // every thread is past stage s - 1\n",
     "    __syncthreads();                                // every thread is past stage s - 1\n"
     "    if (tid == 0 && s == 0) stamp(1);\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();                                  "
     "// the ring is free for the partials\n",
     "  cp_async_wait<0>();\n  __syncthreads();                                  "
     "// the ring is free for the partials\n  if (tid == 0) stamp(2);\n"),
    ("  cluster.sync();\n  const int e1 = min(groups, (q + 1) * slice);\n",
     "  if (tid == 0) stamp(3);\n  cluster.sync();\n  if (tid == 0) stamp(4);\n"
     "  const int e1 = min(groups, (q + 1) * slice);\n"),
    ("                   *reinterpret_cast<const unsigned*>(&hi));\n  }\n}\n",
     "                   *reinterpret_cast<const unsigned*>(&hi));\n  }\n"
     "  if (tid == 0) stamp(5);\n}\n"),
]
# K5 that returns at once: the launch of the same grid and clusters
K5_EMPTY = [("  const int M = a.M, N = a.N, K = a.K;\n  const int tid = threadIdx.x;\n",
             "  if (a.splits > 0) return;\n  const int M = a.M, N = a.N, K = a.K;\n"
             "  const int tid = threadIdx.x;\n")]
K7_STAMPS = [
    ("namespace {\n", STAMP + "namespace {\n"),
    ("  const int tiles = row_tiles * (a.N / BN);\n",
     "  const int tiles = row_tiles * (a.N / BN);\n  if (tid == 128) { stamp(0); stamp_sm(); }\n"),
    ("  int it = 0;                                      // stages consumed so far\n",
     "  int it = 0;                                      // stages consumed so far\n"
     "  unsigned long long t_main = 0, t_epi = 0, sum_main = 0, sum_epi = 0;\n"
     "  int done = 0;\n"),
    ("      mbar_wait(&full[s], (it / STAGES) & 1);\n",
     "      mbar_wait(&full[s], (it / STAGES) & 1);\n"
     "      if (tid == 128 && kb == 0) {\n        t_main = vtt_now();\n"
     "        if (done == 0) vtt_put(1, t_main);\n      }\n"),
    ("    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);\n",
     "    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);\n"
     "    if (tid == 128) {\n      t_epi = vtt_now();\n      sum_main += t_epi - t_main;\n    }\n"),
    ("            *reinterpret_cast<const int4*>(staged + row * ROW + ((c ^ (row & 7)) << 4));\n"
     "    }\n  }\n}\n",
     "            *reinterpret_cast<const int4*>(staged + row * ROW + ((c ^ (row & 7)) << 4));\n"
     "    }\n    if (tid == 128) {\n      sum_epi += vtt_now() - t_epi;\n      ++done;\n    }\n  }\n"
     "  if (tid == 128) {\n    vtt_put(2, sum_main);\n    vtt_put(3, sum_epi);\n"
     "    vtt_put(5, done);\n    stamp(4);\n  }\n}\n"),
]


def stamps_of(lib, n):
    buf = np.zeros((n, 8), np.uint64)
    f = lib.read_stamps
    f.argtypes = [_P, _I]
    f.restype = _I
    if f(buf.ctypes.data, n) != 0:
        raise RuntimeError("read_stamps failed")
    return buf.astype(np.int64)


def us(v):
    return round(float(v) / 1e3, 3)


def k5_case(CS, lib, gen, M, K, N, plan):
    import torch

    from vla_touch_tpu_torch.csrc import build

    f = lib.w8a16_matmul
    f.argtypes = [_P] * 5 + [_I] * 6 + [_P]
    f.restype = _I
    x, (w, s, b), _, _, _ = CS.qmm_check(gen, "K5", M, K, N)
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    for _ in range(3):
        build.check(lib, f(x.data_ptr(), w.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
                           M, N, K, *plan, torch.cuda.current_stream().cuda_stream), "k5 stamps")
    torch.cuda.synchronize()
    mt, wn, splits = plan
    st = stamps_of(lib, -(-N // (32 * wn)) * -(-M // (16 * mt)) * splits)
    row = dict(kernel="K5", M=M, K=K, N=N, plan=plan, ctas=len(st),
               span_us=us(st[:, 5].max() - st[:, 0].min()),
               start_spread_us=us(st[:, 0].max() - st[:, 0].min()), sms=int(len(np.unique(st[:, 7]))))
    for a, c in zip(range(5), range(1, 6)):
        d = st[:, c] - st[:, a]
        row[f"{a}->{c}_us"] = [us(np.median(d)), us(d.max())]
    return row


def k5_floor(CS, lib, gen, M, K, N, plan):
    """Device ms of a call of the K5 copy that returns at once."""
    import torch

    from vla_touch_tpu_torch.csrc import build

    f = lib.w8a16_matmul
    f.argtypes = [_P] * 5 + [_I] * 6 + [_P]
    f.restype = _I
    x, (w, s, b), _, _, _ = CS.qmm_check(gen, "K5", M, K, N)
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")

    def run():
        build.check(lib, f(x.data_ptr(), w.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
                           M, N, K, *plan, torch.cuda.current_stream().cuda_stream), "k5 empty")

    return CS.graph_time_ms(run)


def k7_case(CS, lib, gen, M, K, N):
    import torch

    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    f = lib.a8w8_matmul_large
    f.argtypes = [_P, _I, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    f.restype = _I
    x, (w, s, b), _, _, _ = CS.qmm_check(gen, "K7", M, K, N)
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    xq = torch.empty((M, K), dtype=torch.int8, device="cuda")
    rs = torch.empty((M,), dtype=torch.float32, device="cuda")
    for _ in range(3):
        build.check(lib, f(x.data_ptr(), 0, x.stride(0), w.data_ptr(), s.data_ptr(), b.data_ptr(),
                           xq.data_ptr(), rs.data_ptr(), out.data_ptr(), M, N, K,
                           torch.cuda.current_stream().cuda_stream), "k7 stamps")
    torch.cuda.synchronize()
    tiles = QM.k7_tiles(M, N)
    st = stamps_of(lib, min(tiles, torch.cuda.get_device_properties(0).multi_processor_count))
    span = st[:, 4].max() - st[:, 0].min()
    return dict(kernel="K7", M=M, K=K, N=N, tile=(QM.K7_BM, QM.K7_BN), ctas=len(st), tiles=tiles,
                span_us=us(span), first_stage_us=[us(np.median(st[:, 1] - st[:, 0])),
                                                  us((st[:, 1] - st[:, 0]).max())],
                main_us_per_tile=us(st[:, 2].sum() / st[:, 5].sum()),
                epilogue_us_per_tile=us(st[:, 3].sum() / st[:, 5].sum()),
                tiles_per_cta=[int(st[:, 5].min()), int(st[:, 5].max())],
                busiest_share=float((st[:, 4] - st[:, 0]).max() / span))


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch

    if not torch.cuda.is_available():
        print("torch_k5_k7_stamps: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as CS
    import torch_quant_ab as AB
    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    build.build_all()
    gpu = CS.gpu_line()
    gen = torch.Generator(device="cuda").manual_seed(7)
    k5 = AB.build_cut("w8a16_matmul", K5_STAMPS, "stamps", READ)
    k5_empty = AB.build_cut("w8a16_matmul", K5_EMPTY, "empty")
    k7 = AB.build_cut("a8w8_matmul_large", K7_STAMPS, "stamps", READ)
    placed = {f"{mt},{wn},{sp}": QM._k5_active_clusters(0, mt, wn, sp)
              for mt in (1, 4, 5) for wn in (4, 8) for sp in (1, 2, 4, 6, 7, 8)}
    print(json.dumps(dict(gpu=gpu, k5_clusters_placed=placed)), flush=True)
    for M, K, N, plan in [(67, 2048, 2048, None), (67, 2048, 2048, (5, 4, 8)),
                          (67, 2048, 2048, (5, 8, 8)), (67, 2048, 6144, None),
                          (1, 2048, 2048, None)]:
        plan = plan or QM.k5_card_plan(M, N, K, 0)
        row = k5_case(CS, k5, gen, M, K, N, plan)
        row["empty_grid_ms"] = k5_floor(CS, k5_empty, gen, M, K, N, plan)
        print(json.dumps(dict(gpu=gpu, **row)), flush=True)
    for M, K, N in [(4374, 2048, 4096), (4374, 1152, 2048)]:
        print(json.dumps(dict(gpu=gpu, **k7_case(CS, k7, gen, M, K, N))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
