// The phases of the w4 megakernels, shared by K9 (w4_swiglu.cu) and K10
// (w4_postattn.cu).  Every block of one cooperative launch runs every
// phase; a grid barrier (cooperative_groups::this_grid().sync()) separates
// two phases where the later one needs all of the earlier one's output.
//
// Numerics follow the Pallas megakernels (vla_touch_tpu/ops/
// pallas_matmul.py:526-567, 697-762), which differ from qdense_w4 in one
// place: a row's dequantization scale is amax * (1/127), not amax / 127.
//   x codes   x_i8 = clip(rint(x * (127 / amax)), -127, 127), amax floored at 1e-8
//   g, u      bf16(acc * rs + bias)  (columns c and F + c of the gate|up leaf)
//   act       bf16(bf16(g * sigmoid(g)) * u), the logistic in float32 (_silu_mul)
//   act codes per-row amax over all F columns, then as x
//   out       bf16(acc * rs + bias)
// with IEEE division and square root, rintf, and no contraction into FMA.

#pragma once

#include <cooperative_groups.h>

#include "w4_group.cuh"

namespace vtt_int8 {

constexpr int MK_WARPS = GEMM_WARPS;
constexpr int MK_THREADS = GEMM_THREADS;
constexpr int MK_MAX_M = 32;                 // rows: two 16-row mma tiles
constexpr float INV127 = 1.0f / 127.0f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// a bf16 that other blocks of this launch wrote before a grid barrier
__device__ __forceinline__ float ld_bf16_l2(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the butterfly leaves the same sum in every lane (float + is commutative)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int quant_code(float v, float inv) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
  return bf16_round(__fmul_rn(bf16_round(__fmul_rn(g, sig)), u));
}

// eight bf16 (16 bytes) -> float
__device__ __forceinline__ void bf16x8(const int4& v, float (&f)[8]) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int q = 0; q < 8; ++q) f[q] = __bfloat162float(h[q]);
}

// eight codes of f at 127 / amax, packed into 8 bytes
__device__ __forceinline__ int2 codes8(const float (&f)[8], float inv) {
  unsigned lo = 0, hi = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    lo |= (unsigned)(quant_code(f[q], inv) & 0xFF) << (8 * q);
    hi |= (unsigned)(quant_code(f[4 + q], inv) & 0xFF) << (8 * q);
  }
  return make_int2((int)lo, (int)hi);
}

// Rows [0, M) of a bf16 (M, K) input (row stride ld, K % 8 == 0, rows 16-byte
// aligned) -> int8 codes in this block's shared memory (row stride sld) and
// rs[m] = amax * (1/127).  One warp per row, 16 bytes a lane at a time;
// every block computes the same codes.
__device__ __forceinline__ void quantize_rows_shared(const __nv_bfloat16* __restrict__ x,
                                                     long long ld, int M, int K, int8_t* codes,
                                                     int sld, float* rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < M; m += MK_WARPS) {
    const int4* row = reinterpret_cast<const int4*>(x + m * ld);
    float amax = 0.f;
    for (int i = lane; i < K / 8; i += 32) {
      float f[8];
      bf16x8(__ldg(row + i), f);
#pragma unroll
      for (int q = 0; q < 8; ++q) amax = fmaxf(amax, fabsf(f[q]));
    }
    amax = fmaxf(warp_max(amax), 1e-8f);
    const float inv = 127.0f / amax;
    for (int i = lane; i < K / 8; i += 32) {
      float f[8];
      bf16x8(__ldg(row + i), f);
      *reinterpret_cast<int2*>(codes + m * sld + i * 8) = codes8(f, inv);
    }
    if (lane == 0) rs[m] = __fmul_rn(amax, INV127);
  }
  __syncthreads();
}

// act[m, c] = silu_mul(g, u) for c in [0, F): g, u from columns c and F + c
// of the fused gate|up leaf (2F, K/2) over the codes xq (M, K) in shared
// memory (row stride ldx) with row scales xrs.
// The work item is 16 act columns, its gate and up tiles in one pass; each
// block walks items blockIdx.x, blockIdx.x + gridDim.x, ...  The per-row
// max |act| of the block folds into amax[m] with atomicMax on the float
// bits (non-negative floats order as their bits), which no order of blocks
// changes.
template <int MT>
__device__ __forceinline__ void gate_up_phase(const int8_t* xq, int ldx, const float* xrs,
                                              const int8_t* __restrict__ gu_w,
                                              const float* __restrict__ gu_s,
                                              const float* __restrict__ gu_b, int M, int K,
                                              int F, int G, __nv_bfloat16* act, unsigned* amax,
                                              float* red_g, float* red_u) {
  const int warp = threadIdx.x >> 5;
  float rmax[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) rmax[j] = 0.f;
  const int items = F / W4_BN;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int c0 = item * W4_BN;
    const int cols[2] = {c0, F + c0};                 // the gate and the up tile, one pass
    float acc[2][MT][W4_NT][4] = {};
    w4_warp_units<MT, 2, SharedCodes>(acc, xq, ldx, M, gu_w, gu_s, 2 * F, K, G, cols, 0,
                                      warp, G / 2, MK_WARPS);
    w4_store_partials<MT>(red_g, acc[0], warp);
    w4_store_partials<MT>(red_u, acc[1], warp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int i = threadIdx.x + j * MK_THREADS;
      const int r = i / W4_BN, col = i % W4_BN;
      if (r < M) {
        const int c = c0 + col;
        float g = __fmul_rn(w4_sum_partials<MT>(red_g, MK_WARPS, r, col), xrs[r]);
        float u = __fmul_rn(w4_sum_partials<MT>(red_u, MK_WARPS, r, col), xrs[r]);
        if (gu_b) {
          g = __fadd_rn(g, gu_b[c]);
          u = __fadd_rn(u, gu_b[F + c]);
        }
        const float a = silu_mul(bf16_round(g), bf16_round(u));
        act[(long long)r * F + c] = __float2bfloat16(a);
        rmax[j] = fmaxf(rmax[j], fabsf(a));
      }
    }
    __syncthreads();
  }
  // the 16 threads of a half-warp share one row
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    float v = rmax[j];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int r = (threadIdx.x + j * MK_THREADS) / W4_BN;
    if ((threadIdx.x & 15) == 0 && r < M) atomicMax(amax + r, __float_as_uint(v));
  }
}

// The per-row scale of the act codes, from the folded amax.
__device__ __forceinline__ float act_scale(const unsigned* amax, int m) {
  return __fmul_rn(fmaxf(__uint_as_float(__ldcg(amax + m)), 1e-8f), INV127);
}

// aq = the int8 codes of act (M, F) at each row's amax; a grid-stride share
// per block, 8 values per step (F % 8 == 0).
__device__ __forceinline__ void quantize_act_phase(const __nv_bfloat16* act,
                                                   const unsigned* amax, int M, int F,
                                                   int8_t* aq) {
  const long long n8 = (long long)M * F / 8;
  const long long step = (long long)gridDim.x * MK_THREADS;
  for (long long i = (long long)blockIdx.x * MK_THREADS + threadIdx.x; i < n8; i += step) {
    const long long e = i * 8;
    const int m = (int)(e / F);
    const float inv = 127.0f / fmaxf(__uint_as_float(__ldcg(amax + m)), 1e-8f);
    const int4 v = __ldcg(reinterpret_cast<const int4*>(act + e));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo |= (unsigned)(quant_code(__bfloat162float(h[q]), inv) & 0xFF) << (8 * q);
      hi |= (unsigned)(quant_code(__bfloat162float(h[4 + q]), inv) & 0xFF) << (8 * q);
    }
    *reinterpret_cast<int2*>(aq + e) = make_int2((int)lo, (int)hi);
  }
}

// One w4 product over the codes xq (M, K) (row stride ldx, read through
// Codes::load): each block walks the 16-column tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... of the (N, K/2) leaf; its 8 warps split the
// tile's G/2 units and their partials are summed in a fixed warp order;
// epi(m, n, sum) finishes element (m, n) from the float32 sum before the
// row scale.
template <int MT, typename Codes, typename Epi>
__device__ __forceinline__ void w4_dense_phase(const int8_t* xq, int ldx,
                                               const int8_t* __restrict__ w,
                                               const float* __restrict__ s, int M, int N, int K,
                                               int G, float* red, const Epi& epi) {
  const int warp = threadIdx.x >> 5;
  for (int tile = blockIdx.x; tile < N / W4_BN; tile += gridDim.x) {
    const int n0[1] = {tile * W4_BN};
    float acc[1][MT][W4_NT][4] = {};
    w4_warp_units<MT, 1, Codes>(acc, xq, ldx, M, w, s, N, K, G, n0, 0, warp, G / 2, MK_WARPS);
    w4_store_partials<MT>(red, acc[0], warp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int i = threadIdx.x + j * MK_THREADS;
      const int r = i / W4_BN, col = i % W4_BN;
      if (r < M) epi(r, n0[0] + col, w4_sum_partials<MT>(red, MK_WARPS, r, col));
    }
    __syncthreads();
  }
}

// Shared memory of a megakernel: the codes of up to MT*16 rows of width K
// (row stride K + 16 bytes, which staggers the rows across banks), two
// partial-sum buffers and 32 row scales.
inline size_t megakernel_smem(int MT, int K) {
  return (size_t)MT * 16 * (K + 16) + (2 * (size_t)MK_WARPS * MT * 16 * W4_BN + MK_MAX_M) * 4;
}

// 16-row tiles of a megakernel over M rows
inline int megakernel_mt(int M) { return M <= 16 ? 1 : 2; }

// *fits = whether a megakernel can serve M rows of codes of width K: 1 <= M
// <= MK_MAX_M and one block's shared memory within the card's opt-in limit.
// The only copy of this budget: ops/w4_fused.py routes on it
// (w4_megakernel_fits), and the launches size their blocks by it.
inline cudaError_t megakernel_fits(int M, int K, int* fits) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  *fits = M >= 1 && M <= MK_MAX_M && megakernel_smem(megakernel_mt(M), K) <= (size_t)limit;
  return cudaSuccess;
}

// The grid of a megakernel: every block resident at once (the occupancy
// API), as the grid barriers need; 0 when not one block fits an SM.  The
// attribute and occupancy calls run once per (kernel, shared memory) and
// are kept, so that a launch inside CUDA-graph capture makes none of them.
// The kernel's shared-memory limit only ever rises (the largest size any
// launch of it has asked for), so a narrow call does not lower it under a
// wider one's cached launch.
inline cudaError_t megakernel_grid(const void* fn, size_t smem, int* grid) {
  struct Entry { const void* fn; size_t smem; int grid; };
  static Entry cache[16];
  static int n = 0;
  size_t limit = smem;
  for (int i = 0; i < n; ++i) {
    if (cache[i].fn != fn) continue;
    if (cache[i].smem == smem) {
      *grid = cache[i].grid;
      return cudaSuccess;
    }
    if (cache[i].smem > limit) limit = cache[i].smem;
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)limit);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, MK_THREADS, smem)) !=
      cudaSuccess)
    return err;
  *grid = per_sm * sms;
  if (n < 16) cache[n++] = Entry{fn, smem, *grid};
  return cudaSuccess;
}

// Zero the amax words and launch cooperatively on megakernel_grid's grid.
// A card that refuses (no block fits, or the launch) returns the error.
inline int launch_megakernel(const void* fn, size_t smem, void* args, unsigned* amax, int M,
                             cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = megakernel_grid(fn, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaMemsetAsync(amax, 0, M * sizeof(unsigned), stream)) != cudaSuccess)
    return (int)err;
  void* params[] = {args};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(MK_THREADS), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace vtt_int8
