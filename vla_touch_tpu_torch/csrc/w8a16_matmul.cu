// K5: weight-only int8 matmul (w8a16), bf16 tensor cores, bf16 out.
//
// Replaces the TPU kernel vla_touch_tpu/ops/pallas_matmul.py::w8a16_matmul
// (the pl.pallas_call at :98, body _w8a16_kernel :59):
//   y[m, n] = (sum_k x[m, k] * w_i8[n, k]) * scale[n] + bias[n]
// with x in bf16 (the wrapper rounds a float32 x to bf16 first, as the JAX
// wrapper does), the int8 weights widened to bf16 in registers (exact for
// |v| <= 127), float32 accumulation and a float32 epilogue.  x is never
// quantized, so there is no activation-quantization error.
//
// What bounds it on an H100: at the small M it serves (the RDT twin's ~67
// tokens, the planner's 1) it streams the int8 weights once; (67, 2048,
// 2048) moves 4.5 MB, 1.4 us at 3.35 TB/s, against 0.6 us of bf16
// tensor-core work.  The design is K6's split-K skeleton (a8w8_matmul.cu,
// splitk.cuh) with bf16 x:
//
//   - the plan (ops/quant_matmul.py::k5_plan) gives a CTA BN = 32 * WN
//     output columns (128 or 256, so x's K slice is read from L2 N / BN
//     times), up to 80 rows (MT 16-row tiles; taller products take more
//     row blocks) and one of `splits` contiguous ranges of 64-wide K
//     chunks, so that a call fills the SMs;
//   - a CTA streams its weight tile and its rows of bf16 x through a 3- or
//     4-deep cp.async ring in shared memory, 16-byte pieces from every
//     thread, zero-filled past M, N and the split; each x element is
//     loaded once per CTA;
//   - 8 warps: WN across the columns (32 each, four 8-column mma tiles) by
//     WK = 8 / WN across K (a stage holds WK chunks, one per warp row).
//     Thread (g, t) reads the 16 weights w[n][k + t*16 .. +15] and the 16
//     bf16 of x rows g and g + 8 at the same K; mma.sync m16n8k16 gives it
//     the fragment positions {2t, 2t+1, 2t+8, 2t+9} of a 16-deep step, and
//     step s of the chunk maps them to t*16 + 4s + {0, 1, 2, 3} of x and of
//     w alike, a permutation of K that leaves the sum unchanged.  Weight
//     rows are an odd multiple of 64 bytes apart and x rows 16 bytes off a
//     multiple of 32, so a quarter-warp's 16-byte loads hit 32 banks;
//   - the weights are widened by byte permutes into the mantissa of 2^23
//     (one subtraction each, exact) and the top halves of two floats taken
//     as a bf16 pair, where a cvt pair per two weights costs more;
//   - the WK warps of a column block meet in shared memory in warp order;
//     the splits of a tile are one thread-block cluster, summed in rank
//     order from distributed shared memory (splitk.cuh), then
//     acc * scale + bias in float32 in the plain version's order: the same
//     bits on every run and under CUDA-graph replay.

#include "int8_mma.cuh"
#include "splitk.cuh"

using vtt_splitk::cp_async16;
using vtt_splitk::cp_async_commit;
using vtt_splitk::cp_async_wait;
using vtt_splitk::KC;
using vtt_splitk::MAX_SPLITS;
using vtt_splitk::accumulate;
using vtt_splitk::cluster_arrive_relaxed;
using vtt_splitk::cluster_wait;
using vtt_splitk::split_chunk;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NT = 4;             // 8-column mma tiles per warp
constexpr int W8_MAX_MT = 5;      // 16-row tiles per CTA, at most

// ring depth and CTAs per SM: two CTAs of at most two row tiles share an
// SM (three stages, at most 128 registers); taller tiles keep four stages,
// one CTA per SM
template <int MT>
struct Depth {
  static constexpr int STAGES = MT <= 2 ? 3 : 4;
  static constexpr int CTAS = MT <= 2 ? 2 : 1;
};

struct W8Args {
  const __nv_bfloat16* x;          // (M, K) contiguous
  const int8_t* w;                 // (N, K) contiguous
  const float* scale;              // (N,)
  const float* bias;               // (N,) or null
  __nv_bfloat16* out;              // (M, N) contiguous
  int M, N, K, splits;
};

template <int MT, int WN>
struct Ring {
  static constexpr int WK = NWARPS / WN;
  static constexpr int BN = WN * NT * 8;
  static constexpr int L = WK * KC;                 // K elements per stage
  // a weight row's pitch: an odd multiple of 64 bytes (rows g and g + 1 of
  // a quarter-warp's loads in opposite halves of the banks); an x row's: 16
  // bytes past a multiple of 32 (its four 32-byte-apart loads interleave
  // with the next row's)
  static constexpr int PITCH_W = L % 128 ? L : L + 64;
  static constexpr int PITCH_X = 2 * L + 16;
  static constexpr int W_BYTES = BN * PITCH_W;
  static constexpr int STAGE = W_BYTES + MT * 16 * PITCH_X;
  // the partials' rows: BN + 8 floats apart, so that a half-warp's float2
  // stores to rows g .. g + 3 fall in distinct banks
  static constexpr int RS = BN + 8;
  static constexpr int TILE = MT * 16 * RS;
  static constexpr int RED = WK * TILE * 4;         // the warps' float32 partials
  static constexpr int STAGES = Depth<MT>::STAGES;
  static constexpr int RING = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  // past the ring: the receive slots of the splits' float4 groups
  static constexpr int RECV = (MT * 16 * BN / 4 + MAX_SPLITS) * 16;
  static constexpr int SMEM = RING + RECV;
};

// c (16x8 f32) += a (16x16 bf16, 4 regs) . b (16x8 bf16, 2 regs)
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four int8 of wd -> two bf16x2 registers (bytes 0, 1 in o0; 2, 3 in o1):
// byte b + 128 becomes the low mantissa byte of 2^23, 2^23 + 128 is taken
// off (exact), and each value, an integer of at most 8 bits, is the top
// half of its float
__device__ __forceinline__ void widen4(unsigned wd, unsigned& o0, unsigned& o1) {
  const unsigned u = wd ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b)) - 8388736.0f;
  o0 = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  o1 = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// the 16 int8 of v -> 8 bf16x2 registers, bytes 2q and 2q + 1 in o[q]
__device__ __forceinline__ void widen16(const int4& v, unsigned (&o)[8]) {
  widen4((unsigned)v.x, o[0], o[1]);
  widen4((unsigned)v.y, o[2], o[3]);
  widen4((unsigned)v.z, o[4], o[5]);
  widen4((unsigned)v.w, o[6], o[7]);
}

__device__ __forceinline__ void as_words(const int4& lo, const int4& hi, unsigned (&o)[8]) {
  o[0] = lo.x; o[1] = lo.y; o[2] = lo.z; o[3] = lo.w;
  o[4] = hi.x; o[5] = hi.y; o[6] = hi.z; o[7] = hi.w;
}

// Grid (column tiles, row blocks, splits), clusters of (1, 1, splits).
template <int MT, int WN>
__global__ void __launch_bounds__(NTHREADS, Depth<MT>::CTAS) w8a16_gemm_kernel(W8Args a) {
  using R = Ring<MT, WN>;
  constexpr int STAGES = R::STAGES;
  constexpr int WK = R::WK, BN = R::BN, L = R::L, RS = R::RS, TILE = R::TILE;
  constexpr int PITCH_W = R::PITCH_W, PITCH_X = R::PITCH_X;
  extern __shared__ __align__(128) unsigned char smem[];
  const int M = a.M, N = a.N, K = a.K;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % WN, wk = warp / WN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * MT * 16;
  const int nc = K / KC;                            // K % 128 == 0
  const int c0 = split_chunk(blockIdx.z, nc, a.splits);
  const int c1 = split_chunk(blockIdx.z + 1, nc, a.splits);
  const int kend = c1 * KC;
  const int nst = (c1 - c0 + WK - 1) / WK;
  // a split CTA stores into its peers' shared memory after the main loop:
  // its arrive here, its wait before those stores (every peer has started)
  if (a.splits > 1) cluster_arrive_relaxed();

  // the tile's column scales and bias, staged once
  __shared__ float s_scale[256], s_bias[256];
  for (int i = tid; i < BN; i += NTHREADS) {
    s_scale[i] = n0 + i < N ? a.scale[n0 + i] : 0.f;
    s_bias[i] = a.bias && n0 + i < N ? a.bias[n0 + i] : 0.f;
  }

  // Stage s into slot q, 16-byte pieces: the weight rows n0 + [0, BN) (L
  // bytes each), then the x rows m0 + [0, MT*16) (2L bytes each); pieces
  // past the split, N or M are zero-filled.
  auto load = [&](int s, int q) {
    const int kb = (c0 + s * WK) * KC;
    unsigned char* slot = smem + q * R::STAGE;
    constexpr int PW = L / 16, PX = 2 * L / 16;
    for (int i = tid; i < BN * PW; i += NTHREADS) {
      const int row = i / PW, k = kb + (i % PW) * 16;
      const bool in = n0 + row < N && k < kend;
      cp_async16(slot + row * PITCH_W + (i % PW) * 16,
                 in ? a.w + (long long)(n0 + row) * K + k : a.w, in ? 16 : 0);
    }
    for (int i = tid; i < MT * 16 * PX; i += NTHREADS) {
      const int row = i / PX, k = kb + (i % PX) * 8;
      const bool in = m0 + row < M && k < kend;
      cp_async16(slot + R::W_BYTES + row * PITCH_X + (i % PX) * 16,
                 in ? a.x + (long long)(m0 + row) * K + k : a.x, in ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s, s);
    cp_async_commit();                              // group s: stage s
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();                    // stage s has landed
    __syncthreads();                                // every thread is past stage s - 1
    if (s + STAGES - 1 < nst) load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();
    const int c = c0 + s * WK + wk;                 // this warp's chunk
    if (c >= c1) continue;
    const unsigned char* sw = smem + (s % STAGES) * R::STAGE;
    const unsigned char* sx = sw + R::W_BYTES;
    unsigned wb[NT][8];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = wn * NT * 8 + j * 8 + g;
      widen16(*reinterpret_cast<const int4*>(sw + row * PITCH_W + wk * KC + t * 16), wb[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const unsigned char* x0 = sx + (i * 16 + g) * PITCH_X + wk * 2 * KC + t * 32;
      const unsigned char* x1 = x0 + 8 * PITCH_X;
      unsigned xa[8], xb[8];
      as_words(*reinterpret_cast<const int4*>(x0), *reinterpret_cast<const int4*>(x0 + 16), xa);
      as_words(*reinterpret_cast<const int4*>(x1), *reinterpret_cast<const int4*>(x1 + 16), xb);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], xa[2 * q], xb[2 * q], xa[2 * q + 1], xb[2 * q + 1], wb[j][2 * q],
                   wb[j][2 * q + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                                  // the ring is free for the partials

  // the warps' partials, WK slots of TILE floats, rows RS apart
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wk * MT * 16 + i * 16 + g + h * 8;
        const int col = wn * NT * 8 + j * 8 + t * 2;
        *reinterpret_cast<float2*>(red + row * RS + col) =
            make_float2(acc[i][j][h * 2], acc[i][j][h * 2 + 1]);
      }
  __syncthreads();

  // The cluster's splits.  The tile's rows below M are cut into float4
  // groups (four columns); CTA z finishes groups [z, z + 1) * slice.  Each
  // CTA sums its WK warp rows' partials of every group in warp order and
  // stores the sum into the owner's receive slot for its own rank, in the
  // owner's shared memory past the ring (so a peer may store there while
  // this CTA still computes; the barrier begun at the kernel's start has
  // seen every peer start); after one cluster barrier each CTA sums its
  // slots in rank order from its own shared memory, then acc * scale + bias
  // in float32, the plain version's order.
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int S = a.splits;
  const int q = (int)cluster.block_rank();
  constexpr int GR = BN / 4;                        // groups per row
  const int groups = min(MT * 16, M - m0) * GR;
  const int slice = (groups + S - 1) / S;
  float4* recv = reinterpret_cast<float4*>(smem + R::RING);
  if (S > 1) cluster_wait();                        // every peer has started
  for (int e = tid; e < groups; e += NTHREADS) {
    const float4* p = reinterpret_cast<const float4*>(red + (e / GR) * RS) + e % GR;
    float4 v = p[0];
#pragma unroll
    for (int w = 1; w < WK; ++w) accumulate(v, p[w * TILE / 4]);
    const int z = e / slice;
    *cluster.map_shared_rank(recv + q * slice + e - z * slice, z) = v;
  }
  cluster.sync();
  const int e1 = min(groups, (q + 1) * slice);
  for (int e = q * slice + tid; e < e1; e += NTHREADS) {
    const int i = e - q * slice;
    float4 v = recv[i];
    for (int w = 1; w < S; ++w) accumulate(v, recv[w * slice + i]);
    const int r = e / GR, col = (e % GR) * 4;
    if (n0 + col >= N) continue;
    const float f[4] = {v.x, v.y, v.z, v.w};
    float y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      y[c] = __fmul_rn(f[c], s_scale[col + c]);
      if (a.bias) y[c] = __fadd_rn(y[c], s_bias[col + c]);
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
    *reinterpret_cast<uint2*>(a.out + (long long)(m0 + r) * N + n0 + col) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                   *reinterpret_cast<const unsigned*>(&hi));
  }
}

// The launch configuration of a grid (clusters of (1, 1, grid.z) where it
// splits); the kernel's shared-memory limit raised once, outside any
// CUDA-graph capture that follows.
template <int MT, int WN>
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = cudaSuccess;

  Launch(dim3 grid, cudaStream_t stream) {
    constexpr int smem = Ring<MT, WN>::SMEM;
    static bool raised = false;
    if (!raised) {
      err = cudaFuncSetAttribute(w8a16_gemm_kernel<MT, WN>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      raised = err == cudaSuccess;
    }
    cfg.gridDim = grid;
    cfg.blockDim = dim3(NTHREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = grid.z;
    cfg.attrs = attr;
    cfg.numAttrs = grid.z > 1 ? 1 : 0;            // a cluster only where it splits
  }
};

// op 0: launch the grid; op 1: the number of its clusters the card holds at
// once, in *clusters
template <int MT, int WN>
cudaError_t run(int op, const W8Args& a, dim3 grid, cudaStream_t stream, int* clusters) {
  Launch<MT, WN> l(grid, stream);
  if (l.err != cudaSuccess) return l.err;
  if (op) l.cfg.numAttrs = 1;                     // the calculator counts clusters of any size
  cudaError_t err =
      op ? cudaOccupancyMaxActiveClusters(clusters, (void*)w8a16_gemm_kernel<MT, WN>, &l.cfg)
         : cudaLaunchKernelEx(&l.cfg, w8a16_gemm_kernel<MT, WN>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int WN>
cudaError_t dispatch_wn(int op, const W8Args& a, int mt, dim3 grid, cudaStream_t stream,
                        int* clusters) {
  switch (mt) {
    case 1: return run<1, WN>(op, a, grid, stream, clusters);
    case 2: return run<2, WN>(op, a, grid, stream, clusters);
    case 3: return run<3, WN>(op, a, grid, stream, clusters);
    case 4: return run<4, WN>(op, a, grid, stream, clusters);
    case 5: return run<5, WN>(op, a, grid, stream, clusters);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int op, const W8Args& a, int mt, int wn, dim3 grid, cudaStream_t stream,
                     int* clusters) {
  return wn == 4 ? dispatch_wn<4>(op, a, mt, grid, stream, clusters)
                 : dispatch_wn<8>(op, a, mt, grid, stream, clusters);
}

bool plan_ok(int K, int mt, int wn, int splits) {
  return K % 128 == 0 && mt >= 1 && mt <= W8_MAX_MT && (wn == 4 || wn == 8) && splits >= 1 &&
         splits <= K / KC && splits <= MAX_SPLITS;
}

}  // namespace

// x (M, K) bf16 contiguous and 16-byte aligned; w (N, K) int8 contiguous
// and 16-byte aligned, K % 128 == 0; scale (N,) float32; bias (N,) float32
// or null; out (M, N) bf16 contiguous.  The plan (mt 16-row tiles per CTA,
// 1..5; wn warps across columns, 4 or 8; splits of K, 1..min(8, K / 64))
// comes from ops/quant_matmul.py::k5_plan.  One launch.
extern "C" int w8a16_matmul(const void* x, const void* w, const void* scale, const void* bias,
                            void* out, int M, int N, int K, int mt, int wn, int splits,
                            void* stream) {
  if (!plan_ok(K, mt, wn, splits)) return (int)cudaErrorInvalidValue;
  W8Args a{(const __nv_bfloat16*)x, (const int8_t*)w, (const float*)scale, (const float*)bias,
           (__nv_bfloat16*)out, M, N, K, splits};
  const int bn = 32 * wn;
  const dim3 grid((N + bn - 1) / bn, (M + mt * 16 - 1) / (mt * 16), splits);
  return (int)dispatch(0, a, mt, wn, grid, (cudaStream_t)stream, nullptr);
}

// How many clusters of `splits` CTAs under plan (mt, wn, splits) the card
// holds at once (CUDA's occupancy calculator), in *clusters: the plan
// (ops/quant_matmul.py::k5_card_plan) counts its waves in them.
extern "C" int w8a16_active_clusters(int mt, int wn, int splits, int* clusters) {
  if (!plan_ok(128 * MAX_SPLITS, mt, wn, splits)) return (int)cudaErrorInvalidValue;
  W8Args a{};
  return (int)dispatch(1, a, mt, wn, dim3(1, 1, splits), nullptr, clusters);
}
