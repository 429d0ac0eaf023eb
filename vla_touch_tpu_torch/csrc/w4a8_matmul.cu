// K8: fused w4a8 matmul: grouped int4 weights unpacked in registers, int8
// activations, int8 tensor cores, bf16 out.
//
// Replaces the TPU kernel vla_touch_tpu/ops/pallas_matmul.py::w4a8_matmul
// (the pl.pallas_call at :395, body _w4a8_kernel :313), forward only:
//   y[m, n] = rs[m] * sum_g scale4[g, n] * (sum_{k in g} x_i8[m, k] w[n, k])
//             + bias[n]
// with x quantized per token (int8_mma.cuh, its own launch), the int32 sum
// of each input group scaled BEFORE the float32 sum across groups.  The
// weight layout and the nibble unpacking are in w4_group.cuh, shared with
// K9 (w4_swiglu.cu) and K10 (w4_postattn.cu).
//
// Two bodies, chosen by ops/quant_matmul.py::k8_plan:
//
// M <= 80 (decode, the tick's 64-67 rows, the 72-token prompt pass): the
// warp loop of w4_group.cuh (w4_warp_units, shared with K9/K10).  A CTA
// owns W4_BN = 16 columns and all the rows (up to five 16-row tiles); its 8
// warps split the G/2 units and meet in shared memory in warp order.  Each
// weight byte is read once; measured faster than the tile body there
// (PERF.md).
//
// 80 < M <= 512 (long prompt passes): the tile body.  There the warp loop
// re-reads the weights once per 80 rows and the x codes once per 16
// columns, from L2 (about 4 GB of L2 loads for the 442-token gate|up).
// The tile body:
//   - a CTA owns BM = 64 rows by TB_BN = 128 columns, and one of `splits`
//     contiguous ranges of units (split-K); 8 warps as 2 (rows) x 4 (32
//     columns each), so a warp holds 2 x 4 m16n8k32 tiles;
//   - a 128-byte stage of the packed weights (128 rows) and of the x codes
//     of both planes (BM rows at K offsets k and K/2 + k) streams through
//     a 4-slot cp.async ring in shared memory (64-byte stages measured
//     22 % slower); four producer warps only stream it, each slot handed
//     over by mbarriers (full: its copies landed; empty: the 8 consumer
//     warps are done with it), in place of a block-wide barrier per stage
//     (measured 3 % faster; two producer warps could not issue the copies
//     fast enough); ring rows are 144 bytes apart, so the ldmatrix phases
//     hit 8 distinct 16-byte bank groups;
//   - operands come out of shared memory with ldmatrix and feed mma.sync
//     m16n8k32 s8: one packed B fragment unpacks in registers into the low-
//     and high-plane fragments at the same K positions (as 16 * w, one or
//     two operations a word: w4_group.cuh's *_x16), each multiplied with
//     the x tile of its own plane into its own int32 set; where a 32-byte
//     step ends a group (gs % 32 == 0) both sets fold into the float32 set
//     with that unit's scale4 (staged in the ring with the stage where the
//     unit ends: global loads there stalled every warp at once), int32 to
//     float by a magic-number add, not the quarter-rate I2F; the 1/16 is
//     applied to the tile's sums at the end;
//   - the splits of a tile are one thread-block cluster: each CTA leaves its
//     float32 tile in its shared memory, and after a cluster barrier CTA z
//     finishes slice z of the tile, summing the splits in rank order from
//     its peers' shared memory (no workspace, no atomics: the output is
//     the same bits on every call and graph replay);
//   - the GEMM is a programmatic dependent launch of the quantize launch:
//     it starts while the quantizer runs and waits for it before loading
//     the codes.
//
// Not yet done (later work): fusing the quantize launch, wgmma, the
// backward of the JAX custom_vjp (training).

#include <cooperative_groups.h>

#include "w4_group.cuh"

using namespace vtt_int8;

namespace {

constexpr int NWARPS = GEMM_WARPS;
constexpr int NTHREADS = GEMM_THREADS;

// ---- the warp loop ------------------------------------------------------------

template <int MT>
__global__ void __launch_bounds__(NTHREADS, 1) w4a8_gemm_kernel(GemmArgs a) {
  __shared__ float red[NWARPS * MT * 16 * W4_BN];
  const int warp = threadIdx.x >> 5;
  const int n0[1] = {(int)blockIdx.x * W4_BN};
  const int m0 = blockIdx.y * MT * 16;
  float accf[1][MT][W4_NT][4] = {};
  w4_warp_units<MT, 1, GlobalCodes>(accf, a.xq, a.K, a.M, a.w, a.scale, a.N, a.K, a.G, n0, m0,
                                    warp, a.G / 2, NWARPS);
  w4_store_partials<MT>(red, accf[0], warp);
  __syncthreads();

  for (int i = threadIdx.x; i < MT * 16 * W4_BN; i += NTHREADS) {
    const int r = i / W4_BN, col = i - r * W4_BN;
    const int m = m0 + r, n = n0[0] + col;
    if (m >= a.M || n >= a.N) continue;
    float y = __fmul_rn(w4_sum_partials<MT>(red, NWARPS, r, col), a.rs[m]);
    if (a.bias) y = __fadd_rn(y, a.bias[n]);
    a.out[(long long)m * a.N + n] = __float2bfloat16(y);
  }
}

// A CTA owns W4_BN columns and MT = min(MAX_MT, ceil(M / 16)) 16-row tiles.
cudaError_t launch_warp_loop(const GemmArgs& a, cudaStream_t stream) {
  const int MT = a.M >= MAX_MT * 16 ? MAX_MT : (a.M + 15) / 16;
  const dim3 grid((a.N + W4_BN - 1) / W4_BN, (a.M + MT * 16 - 1) / (MT * 16));
  switch (MT) {
    case 1: w4a8_gemm_kernel<1><<<grid, NTHREADS, 0, stream>>>(a); break;
    case 2: w4a8_gemm_kernel<2><<<grid, NTHREADS, 0, stream>>>(a); break;
    case 3: w4a8_gemm_kernel<3><<<grid, NTHREADS, 0, stream>>>(a); break;
    case 4: w4a8_gemm_kernel<4><<<grid, NTHREADS, 0, stream>>>(a); break;
    default: w4a8_gemm_kernel<5><<<grid, NTHREADS, 0, stream>>>(a); break;
  }
  return cudaGetLastError();
}

// ---- 80 < M <= 512: the tile body -------------------------------------------

constexpr int TB_BN = 128;              // columns of a CTA tile
constexpr int TB_WN = 4;                // warps across the columns (32 each)
constexpr int TB_WM = 2;                // warps across the rows
constexpr int TB_NT = 4;                // 8-column mma tiles per warp
constexpr int TB_KC = 128;              // packed bytes of K per stage (64: 22 % slower)
constexpr int TB_PITCH = TB_KC + 16;    // a ring row's bytes
constexpr int TB_STAGES = 4;
constexpr int TB_MAX_SPLITS = 8;        // CTAs of a cluster (the portable limit)
constexpr int TB_PRODUCERS = 128;       // four warps that only stream the ring
constexpr int TB_THREADS = NTHREADS + TB_PRODUCERS;

constexpr int TB_MT = 2;                // 16-row mma tiles per warp
struct Tile {
  static constexpr int BM = TB_WM * TB_MT * 16;
  static constexpr int ROWS = TB_BN + 2 * BM;          // weights, low-plane x, high-plane x
  // then, per 32-byte step of the stage, the scale4 rows (low and high
  // plane, TB_BN columns) of the unit that ends at that step
  static constexpr int SCALES = TB_KC / 32 * 2 * TB_BN * 4;
  static constexpr int STAGE = ROWS * TB_PITCH + SCALES;
  static constexpr int RING = TB_STAGES * STAGE;
  static constexpr int TILE = BM * TB_BN;
  static constexpr int SMEM = RING > TILE * 4 ? RING : TILE * 4;
};

struct K8Args {
  const int8_t* xq;
  const float* rs;
  const int8_t* w;                      // (N, K/2) plane-packed
  const float* scale4;                  // (G, N)
  const float* bias;                    // (N,) or null
  __nv_bfloat16* out;
  int M, N, K, G, splits;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  // copies src_bytes (0 or 16) and zero-fills the rest of the 16
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrives on bar when every cp.async this thread issued before has landed
__device__ __forceinline__ void cp_async_mbar_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// waits for the phase of bar with this parity to complete
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// first unit of split z of `units`: the splits differ by at most one unit
// (ops/quant_matmul.py::k8_split_units)
__device__ __forceinline__ int split_unit(int z, int units, int splits) {
  return (int)((long long)z * units / splits);
}

// int32 -> float.  SMALL: |v| < 2^22, exactly, by the magic-number add at
// full rate (I2F runs at a quarter of it, and the fold converts every
// accumulator once a unit); else I2F.
template <bool SMALL>
__device__ __forceinline__ float acc_to_float(int v) {
  return SMALL ? __int_as_float(v + 0x4B400000) - 12582912.f : (float)v;
}

// Grid (row blocks, column tiles, splits), clusters of (1, 1, splits).
// SMALL: group size <= 256, so a group's int32 sum of 16 * w * x stays
// under 2^22 (16 * 8 * 127 * 256 < 2^22).
template <bool SMALL>
__global__ void __launch_bounds__(TB_THREADS, 1) w4a8_tile_kernel(K8Args a) {
  using T = Tile;
  constexpr int MT = TB_MT;
  constexpr int BM = T::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / TB_WN, wn = warp % TB_WN;
  const int M = a.M, N = a.N, KH = a.K / 2, gs = a.K / a.G, HG = a.G / 2;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * TB_BN;
  const int u0 = split_unit(blockIdx.z, HG, a.splits);
  const int u1 = split_unit(blockIdx.z + 1, HG, a.splits);
  const int kb0 = u0 * gs, kb1 = u1 * gs;          // this split's packed bytes
  const int nst = (kb1 - kb0 + TB_KC - 1) / TB_KC;

  // Stage s into slot q, 16-byte pieces over the producer threads (p their
  // index): the weight rows n0 + [0, 128) and the scale4 rows of the units
  // that end in the stage, then the low-plane and the high-plane code rows
  // m0 + [0, BM); pieces past the split, or of a row the product lacks, are
  // zero-filled.
  auto load = [&](int s, int q, int p) {
    const int kb = kb0 + s * TB_KC;
    unsigned char* slot = smem + q * T::STAGE;
    constexpr int PR = TB_KC / 16;
    {
      for (int i = p; i < TB_BN * PR; i += TB_PRODUCERS) {
        const int row = i / PR, k = kb + (i % PR) * 16;
        const bool in = n0 + row < N && k < kb1;
        cp_async16(slot + row * TB_PITCH + (i % PR) * 16,
                   in ? a.w + (long long)(n0 + row) * KH + k : a.w, in ? 16 : 0);
      }
      constexpr int SP = 2 * TB_BN / 4;               // 16-byte pieces of a step's scales
      for (int i = p; i < TB_KC / 32 * SP; i += TB_PRODUCERS) {
        const int ks = i / SP, plane = (i % SP) / (SP / 2), c = (i % (SP / 2)) * 4;
        const int kend = kb + ks * 32 + 32;             // a unit ends here when gs divides it
        if (kend > kb1 || (kend - kb0) % gs) continue;
        const int n = n0 + c;
        const bool in = n < N;                          // N % 4 == 0: whole pieces or none
        cp_async16(slot + T::ROWS * TB_PITCH + (ks * 2 + plane) * TB_BN * 4 + c * 4,
                   in ? a.scale4 + (long long)(kend / gs - 1 + plane * HG) * N + n : a.scale4,
                   in ? 16 : 0);
      }
    }
    for (int i = p; i < 2 * BM * PR; i += TB_PRODUCERS) {
      const int row = i / PR, k = kb + (i % PR) * 16;
      const int plane = row >= BM, r = row - plane * BM;
      const bool in = m0 + r < M && k < kb1;
      cp_async16(slot + (TB_BN + row) * TB_PITCH + (i % PR) * 16,
                 in ? a.xq + (long long)(m0 + r) * a.K + plane * KH + k : a.xq, in ? 16 : 0);
    }
  };

  int acc_lo[MT][TB_NT][4], acc_hi[MT][TB_NT][4];
  float accf[MT][TB_NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < TB_NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc_lo[i][j][r] = acc_hi[i][j][r] = 0;
        accf[i][j][r] = 0.f;
      }

  // the ring's slots: full[q] completes when a stage's copies have landed
  // in slot q, empty[q] when every consumer warp is done with it
  __shared__ __align__(8) unsigned long long full[TB_STAGES], empty[TB_STAGES];
  if (tid == 0)
    for (int q = 0; q < TB_STAGES; ++q) {
      mbar_init(&full[q], TB_PRODUCERS);
      mbar_init(&empty[q], NWARPS);
    }
  __syncthreads();

  if (warp >= NWARPS) {
    // the producer warps stream every stage into a slot as soon as the
    // consumers have freed it; the codes come from the quantize launch
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int s = 0; s < nst; ++s) {
      const int q = s % TB_STAGES;
      if (s >= TB_STAGES) mbar_wait(&empty[q], (s / TB_STAGES - 1) & 1);
      load(s, q, tid - NTHREADS);
      cp_async_mbar_arrive(&full[q]);
    }
  }
  int kg = kb0 + gs;                                // where the unit being summed ends
  // this lane's ldmatrix rows and byte offsets in a stage
  const int a_row = wm * MT * 16 + (lane & 15), a_col = (lane >> 4) * 16;
  const int b_row = wn * 32 + (lane >> 4) * 8 + (lane & 7), b_col = ((lane >> 3) & 1) * 16;
  for (int s = 0; warp < NWARPS && s < nst; ++s) {
    mbar_wait(&full[s % TB_STAGES], (s / TB_STAGES) & 1);    // stage s has landed
    const unsigned char* sw = smem + (s % TB_STAGES) * T::STAGE;
    const unsigned char* sxl = sw + TB_BN * TB_PITCH;
    const unsigned char* sxh = sxl + BM * TB_PITCH;
#pragma unroll
    for (int ks = 0; ks < TB_KC / 32; ++ks) {
      const int kb = kb0 + s * TB_KC + ks * 32;
      if (kb >= kb1) break;                         // the split's last stage ends early
      unsigned b[TB_NT][2];
#pragma unroll
      for (int jp = 0; jp < TB_NT / 2; ++jp) {
        unsigned r4[4];
        ldmatrix_x4(r4, sw + (b_row + jp * 16) * TB_PITCH + ks * 32 + b_col);
        b[2 * jp][0] = r4[0];
        b[2 * jp][1] = r4[1];
        b[2 * jp + 1][0] = r4[2];
        b[2 * jp + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        unsigned xl[4], xh[4];
        ldmatrix_x4(xl, sxl + (a_row + i * 16) * TB_PITCH + ks * 32 + a_col);
        ldmatrix_x4(xh, sxh + (a_row + i * 16) * TB_PITCH + ks * 32 + a_col);
#pragma unroll
        for (int j = 0; j < TB_NT; ++j) {
          mma_s8(acc_lo[i][j], xl[0], xl[1], xl[2], xl[3], low_nibbles_x16(b[j][0]),
                 low_nibbles_x16(b[j][1]));
          mma_s8(acc_hi[i][j], xh[0], xh[1], xh[2], xh[3], high_nibbles_x16(b[j][0]),
                 high_nibbles_x16(b[j][1]));
        }
      }
      if (kb + 32 == kg) {
        // a unit ends here: fold its two groups into the float32 sums with
        // its scale4 rows, staged with this stage
        const float* sc = reinterpret_cast<const float*>(sw + T::ROWS * TB_PITCH) +
                          ks * 2 * TB_BN + wn * 32 + t * 2;
#pragma unroll
        for (int j = 0; j < TB_NT; ++j) {
          const float2 s_lo = *reinterpret_cast<const float2*>(sc + j * 8);
          const float2 s_hi = *reinterpret_cast<const float2*>(sc + TB_BN + j * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float& acc = accf[i][j][r];
              acc = fmaf(acc_to_float<SMALL>(acc_lo[i][j][r]), r & 1 ? s_lo.y : s_lo.x, acc);
              acc = fmaf(acc_to_float<SMALL>(acc_hi[i][j][r]), r & 1 ? s_hi.y : s_hi.x, acc);
              acc_lo[i][j][r] = acc_hi[i][j][r] = 0;
            }
        }
        kg += gs;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s % TB_STAGES]);  // this warp is done with the slot
  }
  cp_async_wait<0>();
  __syncthreads();                                  // the ring is free for the tile
  asm volatile("griddepcontrol.wait;\n" ::: "memory");    // rs comes from the quantize launch

  // this CTA's float32 tile, [row][column], from the consumer warps
  float* red = reinterpret_cast<float*>(smem);
  if (warp < NWARPS) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < TB_NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * MT * 16 + i * 16 + g + h * 8;
          const int col = wn * 32 + j * 8 + t * 2;
          *reinterpret_cast<float2*>(red + row * TB_BN + col) =
              make_float2(accf[i][j][h * 2] * 0.0625f, accf[i][j][h * 2 + 1] * 0.0625f);
        }
  }

  // the cluster's splits: CTA z finishes elements [z, z + 1) * slice of the
  // tile, summing the splits in rank order, then * rs + bias in float32
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int S = a.splits;
  const int z = (int)cluster.block_rank();
  const int slice = (T::TILE + S - 1) / S;
  const int e1 = min(T::TILE, (z + 1) * slice);
  for (int e = z * slice + tid; e < e1; e += TB_THREADS) {
    const int r = e / TB_BN, col = e % TB_BN;
    if (m0 + r >= M || n0 + col >= N) continue;
    float v = S == 1 ? red[e] : *cluster.map_shared_rank(red + e, 0);
    for (int q = 1; q < S; ++q) v = __fadd_rn(v, *cluster.map_shared_rank(red + e, q));
    float y = __fmul_rn(v, a.rs[m0 + r]);
    if (a.bias) y = __fadd_rn(y, a.bias[n0 + col]);
    a.out[(long long)(m0 + r) * N + n0 + col] = __float2bfloat16(y);
  }
  cluster.sync();                                   // no CTA leaves while a peer reads it
}

template <bool SMALL>
cudaError_t launch_tile(const K8Args& a, cudaStream_t stream) {
  constexpr int smem = Tile::SMEM;
  // raised once, outside any CUDA-graph capture that follows (one size per
  // instantiation)
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(w4a8_tile_kernel<SMALL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const dim3 grid((a.M + Tile::BM - 1) / Tile::BM, (a.N + TB_BN - 1) / TB_BN, a.splits);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(TB_THREADS);
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, w4a8_tile_kernel<SMALL>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 (x_f32 == 0) or float32 with row stride x_sm elements;
// w4_pack (N, K/2) int8 contiguous and 16-byte aligned, K % 32 == 0; scale4
// (G, N) float32, G even, (K / G) % 32 == 0 (and N % 4 == 0 for the tile
// body); bias (N,) float32 or null; xq
// (M, K) int8 and rs (M,) float32 scratch; out (M, N) bf16 contiguous.  The
// plan (ops/quant_matmul.py::k8_plan): mt 0, the warp loop (splits 1), or
// mt 2 (TB_MT), the tile body of 64 rows with `splits` ranges of units
// (1..min(8, G/2)); M <= 512.
extern "C" int w4a8_matmul(const void* x, int x_f32, long long x_sm, const void* w4_pack,
                           const void* scale4, const void* bias, void* xq, void* rs,
                           void* out, int M, int N, int K, int G, int mt, int splits,
                           void* stream) {
  const bool warp_loop = mt == 0 && splits == 1 && M <= 512;
  const bool tile = mt == TB_MT && M <= 512 && N % 4 == 0 && splits >= 1 &&
                    splits <= TB_MAX_SPLITS && splits <= G / 2;
  if (!warp_loop && !tile) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      warp_loop ? quantize_rows(x, x_f32, x_sm, M, K, (int8_t*)xq, (float*)rs, st)
                : quantize_rows<true>(x, x_f32, x_sm, M, K, (int8_t*)xq, (float*)rs, st);
  if (err != cudaSuccess) return (int)err;
  if (warp_loop) {
    GemmArgs a{(const int8_t*)xq, (const float*)rs, (const int8_t*)w4_pack,
               (const float*)scale4, (const float*)bias, (__nv_bfloat16*)out, M, N, K, G};
    return (int)launch_warp_loop(a, st);
  }
  K8Args a{(const int8_t*)xq, (const float*)rs, (const int8_t*)w4_pack, (const float*)scale4,
           (const float*)bias, (__nv_bfloat16*)out, M, N, K, G, splits};
  const bool small = K / G <= 256;
  return (int)(small ? launch_tile<true>(a, st) : launch_tile<false>(a, st));
}
