// K6: fused a8w8 matmul, int8 tensor cores, bf16 out.
//
// Replaces the TPU kernel vla_touch_tpu/ops/pallas_matmul.py::a8w8_matmul
// (the pl.pallas_call at :192, body _a8w8_kernel :134):
//   y[m, n] = (sum_k x_i8[m, k] * w_i8[n, k]) * rs[m] * scale[n] + bias[n]
// with x quantized per token (int8_mma.cuh) and exact int32 accumulation.
//
// The TPU kernel quantizes x once, at grid step 0, because a TPU grid runs
// in order.  CUDA CTAs run at once, so quantization is its own launch
// (one CTA per row, writing x_i8 and rs to a scratch buffer the wrapper
// allocates) before the GEMM launch; the wrapper counts the pair as one.
// The GEMM is launched as a programmatic dependent of the quantize launch:
// its CTAs start while the quantizer runs, put their first weight stages
// in flight, and wait (griddepcontrol.wait) only before loading x's codes.
//
// What bounds it on an H100: at the serving shapes (M = 1..67 tokens, K
// and N 128..18944) it streams the int8 weights once, ~0.5 operations per
// byte, far under the ~590 int8 operations per byte where the tensor cores
// would bound it.  So the design is about keeping enough weight bytes in
// flight on every SM:
//
//   - the plan (ops/quant_matmul.py::k6_plan) gives a CTA BN = 32 * WN
//     output columns, up to 80 rows (MT 16-row tiles) and one of `splits`
//     contiguous ranges of 64-wide K chunks (split-K across CTAs), so that
//     a call fills the SMs at every serving shape;
//   - a CTA streams its weight tile and its rows of x's codes through a
//     3- or 4-deep ring in shared memory, 16-byte cp.async pieces from every
//     thread (the Tensor Memory Accelerator's bulk copies, one per row of
//     128-256 bytes, streamed slower on the card), so two or three stages
//     of loads are in flight while the tensor cores work on another; each
//     x code is loaded once per CTA;
//   - 8 warps: WN across the columns (32 each, four 8-column mma tiles) by
//     WK = 8 / WN across K (a stage holds WK chunks, one per warp row);
//     ring rows are an odd multiple of 64 bytes apart, so the 16-byte
//     fragment loads of a quarter-warp hit 32 distinct banks;
//   - the WK warps of a column block meet in shared memory, summed in warp
//     order; the splits of a tile are one thread-block cluster (up to 8
//     CTAs, Hopper's distributed shared memory), and after a cluster
//     barrier each CTA sums one slice of the tile over the cluster's int32
//     partials, in rank order, straight from its peers' shared memory: no
//     global workspace or counter, so nothing is left to reset between
//     calls or CUDA-graph replays (global atomics for the same sums cost
//     more than the split saved on the card);
//   - the epilogue (acc * rs) * scale + bias runs once per element in
//     float32, in the plain version's order: the bf16 out is exact.
//
// Not yet done (later work): wgmma.

#include "int8_mma.cuh"
#include "splitk.cuh"

using namespace vtt_int8;
using vtt_splitk::cp_async16;
using vtt_splitk::cp_async_commit;
using vtt_splitk::cp_async_wait;
using vtt_splitk::KC;
using vtt_splitk::MAX_SPLITS;
using vtt_splitk::rank_sum;
using vtt_splitk::split_chunk;

namespace {

constexpr int NWARPS = GEMM_WARPS;
constexpr int NTHREADS = GEMM_THREADS;
constexpr int NT = 4;             // 8-column mma tiles per warp (a chunk: two m16n8k32 steps)
// ring depth and CTAs per SM: two CTAs of at most two row tiles share an
// SM (three stages, at most 128 registers), so that a wide product's one
// or two hundred unsplit CTAs run in one wave; taller tiles keep four
// stages, one CTA per SM
template <int MT>
struct Depth {
  static constexpr int STAGES = MT <= 2 ? 3 : 4;
  static constexpr int CTAS = MT <= 2 ? 2 : 1;
};

struct K6Args {
  const int8_t* xq;
  const float* rs;
  const int8_t* w;
  const float* scale;
  const float* bias;              // (N,) or null
  __nv_bfloat16* out;
  int M, N, K, splits;
};

template <int MT, int WN>
struct Ring {
  static constexpr int WK = NWARPS / WN;
  static constexpr int BN = WN * NT * 8;
  static constexpr int L = WK * KC;                 // bytes of K per stage and row
  // a row's pitch in the ring: an odd multiple of 64 bytes, so that rows g
  // and g + 1 of a quarter-warp's 16-byte fragment loads fall in opposite
  // halves of the 32 banks
  static constexpr int PITCH = L + 64;
  static constexpr int W_BYTES = BN * PITCH;
  static constexpr int STAGE = (BN + MT * 16) * PITCH;
  static constexpr int TILE = MT * 16 * BN;
  static constexpr int RED = WK * TILE * 4;         // the warps' int32 partials
  static constexpr int STAGES = Depth<MT>::STAGES;
  static constexpr int SMEM = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  static_assert(BN + MT * 16 <= NTHREADS, "one copying thread per ring row");
};

// Grid (column tiles, row blocks, splits), clusters of (1, 1, splits).
template <int MT, int WN>
__global__ void __launch_bounds__(NTHREADS, Depth<MT>::CTAS) a8w8_gemm_kernel(K6Args a) {
  using R = Ring<MT, WN>;
  constexpr int STAGES = R::STAGES;
  constexpr int WK = R::WK, BN = R::BN, L = R::L, PITCH = R::PITCH, TILE = R::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  const int M = a.M, N = a.N, K = a.K;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % WN, wk = warp / WN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * MT * 16;
  const int nc = (K + KC - 1) / KC;
  const int c0 = split_chunk(blockIdx.z, nc, a.splits);
  const int c1 = split_chunk(blockIdx.z + 1, nc, a.splits);
  const int kend = min(K, c1 * KC);                 // K % 16 == 0: whole pieces or none
  const int nst = (c1 - c0 + WK - 1) / WK;

  // the tile's column scales and bias, and after the quantize launch its
  // row scales, staged once: the epilogue then reads shared memory only
  __shared__ float s_rs[MAX_MT * 16], s_scale[4 * NT * 8], s_bias[4 * NT * 8];
  for (int i = tid; i < BN; i += NTHREADS) {
    s_scale[i] = n0 + i < N ? a.scale[n0 + i] : 0.f;
    s_bias[i] = a.bias && n0 + i < N ? a.bias[n0 + i] : 0.f;
  }

  // Stage s into slot q, 16-byte pieces: the weight rows n0 + [0, BN), then
  // the code rows m0 + [0, MT*16), each the stage's L bytes of K; pieces
  // past the split, K or a row the product has are zero-filled.  `what` 1:
  // weights, 2: codes, 3: both.
  auto load = [&](int s, int q, int what) {
    const int kb = (c0 + s * WK) * KC;
    unsigned char* slot = smem + q * R::STAGE;
    constexpr int PR = L / 16;
    if (what & 1)
      for (int i = tid; i < BN * PR; i += NTHREADS) {
        const int row = i / PR, k = kb + (i % PR) * 16;
        const bool in = n0 + row < N && k < kend;
        cp_async16(slot + row * PITCH + (i % PR) * 16,
                   in ? a.w + (long long)(n0 + row) * K + k : a.w, in ? 16 : 0);
      }
    if (what & 2)
      for (int i = tid; i < MT * 16 * PR; i += NTHREADS) {
        const int row = i / PR, k = kb + (i % PR) * 16;
        const bool in = m0 + row < M && k < kend;
        cp_async16(slot + (BN + row) * PITCH + (i % PR) * 16,
                   in ? a.xq + (long long)(m0 + row) * K + k : a.xq, in ? 16 : 0);
      }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // the weights need nothing of the quantize launch: their first stages go
  // out before the wait for it, the codes after
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < nst) load(s, s, 1);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int i = tid; i < MT * 16; i += NTHREADS) s_rs[i] = m0 + i < M ? a.rs[m0 + i] : 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s, s, 2);
    cp_async_commit();                              // group s: stage s (and group 0 the weights)
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();                    // stage s has landed
    __syncthreads();                                // every thread is past stage s - 1
    if (s + STAGES - 1 < nst) load(s + STAGES - 1, (s + STAGES - 1) % STAGES, 3);
    cp_async_commit();
    const int c = c0 + s * WK + wk;                 // this warp's chunk
    if (c >= c1) continue;
    const int kc = wk * KC + t * 16;                // the thread's 16 bytes of a stage row
    const bool kin = c * KC + t * 16 < kend;
    const unsigned char* sw = smem + (s % STAGES) * R::STAGE;
    const unsigned char* sx = sw + R::W_BYTES;
    const int4 zero = make_int4(0, 0, 0, 0);
    int4 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = wn * NT * 8 + j * 8 + g;
      b[j] = kin && n0 + row < N ? *reinterpret_cast<const int4*>(sw + row * PITCH + kc) : zero;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r0 = i * 16 + g;
      const int4 a_lo =
          kin && m0 + r0 < M ? *reinterpret_cast<const int4*>(sx + r0 * PITCH + kc) : zero;
      const int4 a_hi = kin && m0 + r0 + 8 < M
                            ? *reinterpret_cast<const int4*>(sx + (r0 + 8) * PITCH + kc)
                            : zero;
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_chunk64(acc[i][j], a_lo, a_hi, b[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                                  // the ring is free for the partials

  // the WK warps of each column block, summed in warp order into slot 0
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wk * MT * 16 + i * 16 + g + h * 8;
        const int col = wn * NT * 8 + j * 8 + t * 2;
        *reinterpret_cast<int2*>(red + row * BN + col) =
            make_int2(acc[i][j][h * 2], acc[i][j][h * 2 + 1]);
      }
  __syncthreads();
  for (int e = 4 * tid; e < TILE; e += 4 * NTHREADS) {      // TILE % 4 == 0
    int4 s = *reinterpret_cast<const int4*>(red + e);
#pragma unroll
    for (int q = 1; q < WK; ++q) {
      const int4 v = *reinterpret_cast<const int4*>(red + q * TILE + e);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<int4*>(red + e) = s;
  }

  // the cluster's splits: CTA z finishes elements [z, z + 1) * slice of the
  // tile, summing the splits' partials in rank order, then (acc * rs) *
  // scale + bias in float32, the plain version's order; four elements a
  // thread at a time, their loads first
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int S = a.splits;
  const int z = (int)cluster.block_rank();
  const int slice = (TILE + S - 1) / S;
  const int e1 = min(TILE, (z + 1) * slice);
  for (int e0 = z * slice + tid; e0 < e1; e0 += 4 * NTHREADS) {
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * NTHREADS;
      v[u] = 0;
      if (e >= e1) continue;
      v[u] = rank_sum(cluster, red, e, S);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * NTHREADS;
      const int r = e / BN, col = e % BN;
      if (e >= e1 || m0 + r >= M || n0 + col >= N) continue;
      float y = __fmul_rn(__fmul_rn((float)v[u], s_rs[r]), s_scale[col]);
      if (a.bias) y = __fadd_rn(y, s_bias[col]);
      a.out[(long long)(m0 + r) * N + n0 + col] = __float2bfloat16(y);
    }
  }
  cluster.sync();                                   // no CTA leaves while a peer reads it
}

template <int MT, int WN>
cudaError_t launch(const K6Args& a, dim3 grid, cudaStream_t stream) {
  constexpr int smem = Ring<MT, WN>::SMEM;
  // raised once, outside any CUDA-graph capture that follows
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(a8w8_gemm_kernel<MT, WN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = grid.z > 1 ? 2 : 1;              // a cluster only where it splits
  cudaError_t err = cudaLaunchKernelEx(&cfg, a8w8_gemm_kernel<MT, WN>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int WN>
cudaError_t launch_wn(const K6Args& a, int mt, dim3 grid, cudaStream_t stream) {
  switch (mt) {
    case 1: return launch<1, WN>(a, grid, stream);
    case 2: return launch<2, WN>(a, grid, stream);
    case 3: return launch<3, WN>(a, grid, stream);
    case 4: return launch<4, WN>(a, grid, stream);
    case 5: return launch<5, WN>(a, grid, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (M, K) bf16 (x_f32 == 0) or float32 with row stride x_sm elements;
// w (N, K) int8 contiguous and 16-byte aligned, K % 16 == 0; scale (N,)
// float32; bias (N,) float32 or null; xq (M, K) int8 and rs (M,) float32
// scratch; out (M, N) bf16 contiguous.  The plan (mt 16-row tiles per CTA,
// 1..5; wn warps across columns, 2 or 4; splits of K, 1..min(8, ceil(K /
// 64))) comes from ops/quant_matmul.py::k6_plan.
extern "C" int a8w8_matmul(const void* x, int x_f32, long long x_sm, const void* w,
                           const void* scale, const void* bias, void* xq, void* rs,
                           void* out, int M, int N, int K, int mt, int wn, int splits,
                           void* stream) {
  const int nc = (K + KC - 1) / KC;
  if (mt < 1 || mt > MAX_MT || (wn != 2 && wn != 4) || splits < 1 || splits > nc ||
      splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = quantize_rows<true>(x, x_f32, x_sm, M, K, (int8_t*)xq, (float*)rs, st);
  if (err != cudaSuccess) return (int)err;
  K6Args a{(const int8_t*)xq, (const float*)rs, (const int8_t*)w, (const float*)scale,
           (const float*)bias, (__nv_bfloat16*)out, M, N, K, splits};
  const int bn = 32 * wn;
  const dim3 grid((N + bn - 1) / bn, (M + mt * 16 - 1) / (mt * 16), splits);
  err = wn == 2 ? launch_wn<2>(a, mt, grid, st) : launch_wn<4>(a, mt, grid, st);
  return (int)err;
}
