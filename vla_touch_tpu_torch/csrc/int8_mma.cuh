// Shared by the int8 matmul kernels (a8w8_matmul.cu, w4a8_matmul.cu,
// a8w8_matmul_large.cu; w8a16_matmul.cu takes ld128 and the error string):
// the per-token activation quantization launch and the int8 tensor-core
// step.  Each including .cu is a library of its own, so the header also
// defines that library's vtt_error_string.
//
// Quantization follows vla_touch_tpu/ops/quant.py::qdense exactly, so the
// codes are those of the plain version and of the JAX package:
//   amax = max(max_k |x[m, k]|, 1e-8)                (float32)
//   x_i8 = clip(rint(x * (127 / amax)), -127, 127)   (round half to even)
//   rs   = amax / 127                                 (the row's scale)
// with IEEE division (nvcc's default -prec-div=true) and rintf, never roundf.
// With rs_recip the row's scale is amax * (1/127) instead, as
// pallas_matmul.py::a8w8_matmul_large computes it (:260): one ulp from
// amax / 127 for some amax.
//
// The tensor-core step is mma.sync m16n8k32 s8 x s8 -> s32.  Both operands
// are K-contiguous rows (x_i8 (M, K), w (N, K)), and each thread loads 16
// consecutive bytes of a row with one 128-bit load.  That hands thread
// (group g = lane / 4, t = lane % 4) the K positions t*16 .. t*16+15 of a
// 64-wide K chunk, where the mma fragment layout wants t*4 .. t*4+3 and
// 16 + t*4 .. 16 + t*4+3 of a 32-wide step.  Since the product sums over K,
// any permutation of K applied to both operands alike leaves it unchanged:
// mma #1 takes bytes 0..7 of every thread's 16 (A regs {row g: .x, row g+8:
// .x, row g: .y, row g+8: .y}, B regs {.x, .y}) and mma #2 bytes 8..15
// (.z, .w).  So a 64-wide K chunk is two mma per (16-row, 8-column) tile
// with no shared-memory staging or shuffles.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace vtt_int8 {

constexpr int QUANT_THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One CTA per row m: x (M, K) with row stride x_sm elements -> xq (M, K)
// int8 contiguous and rs[m] = amax / 127 (rs_recip: amax * (1/127)).
// EARLY_LAUNCH lets a launch that follows with programmatic dependent
// launch start at once (K6: its weight loads overlap this launch).
template <typename T, bool EARLY_LAUNCH = false>
__global__ void __launch_bounds__(QUANT_THREADS)
quantize_rows_kernel(const T* __restrict__ x, long long x_sm, int K,
                     int8_t* __restrict__ xq, float* __restrict__ rs, int rs_recip) {
  __shared__ float red[QUANT_THREADS / 32];
  if (EARLY_LAUNCH) asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int m = blockIdx.x;
  const T* row = x + (long long)m * x_sm;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += QUANT_THREADS)
    amax = fmaxf(amax, fabsf(to_float(row[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < QUANT_THREADS / 32; ++w) amax = fmaxf(amax, red[w]);
  amax = fmaxf(amax, 1e-8f);
  const float inv = 127.0f / amax;
  int8_t* out = xq + (long long)m * K;
  for (int k = threadIdx.x; k < K; k += QUANT_THREADS) {
    const float q = fminf(fmaxf(rintf(__fmul_rn(to_float(row[k]), inv)), -127.f), 127.f);
    out[k] = (int8_t)(int)q;
  }
  if (threadIdx.x == 0) rs[m] = rs_recip ? __fmul_rn(amax, 1.0f / 127.0f) : amax / 127.0f;
}

// Launch the quantization of x (bf16 when x_f32 == 0, else float32).
template <bool EARLY_LAUNCH = false>
inline cudaError_t quantize_rows(const void* x, int x_f32, long long x_sm, int M,
                                 int K, int8_t* xq, float* rs, cudaStream_t stream,
                                 int rs_recip = 0) {
  if (x_f32)
    quantize_rows_kernel<float, EARLY_LAUNCH><<<M, QUANT_THREADS, 0, stream>>>(
        (const float*)x, x_sm, K, xq, rs, rs_recip);
  else
    quantize_rows_kernel<__nv_bfloat16, EARLY_LAUNCH><<<M, QUANT_THREADS, 0, stream>>>(
        (const __nv_bfloat16*)x, x_sm, K, xq, rs, rs_recip);
  return cudaGetLastError();
}

__device__ __forceinline__ int4 ld128(const int8_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// c (16x8 s32) += a (16x32 s8, 4 regs) . b (32x8 s8, 2 regs)
__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3,
                                       int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One 64-wide K chunk for one (16-row, 8-column) tile: a_lo / a_hi are the
// thread's 16 bytes of rows g and g + 8, b its 16 bytes of column g.
__device__ __forceinline__ void mma_chunk64(int (&c)[4], const int4& a_lo,
                                            const int4& a_hi, const int4& b) {
  mma_s8(c, a_lo.x, a_hi.x, a_lo.y, a_hi.y, b.x, b.y);
  mma_s8(c, a_lo.z, a_hi.z, a_lo.w, a_hi.w, b.z, b.w);
}

constexpr int GEMM_WARPS = 8;
constexpr int GEMM_THREADS = GEMM_WARPS * 32;
constexpr int MAX_MT = 5;          // 16-row tiles per CTA, at most

// The operands of one product.  w and scale are the layout's own: int8
// (N, K) and scale (N,) for K6, packed int4 (N, K/2) and scale4 (G, N) for
// K8.  out (M, N) bf16 contiguous.
struct GemmArgs {
  const int8_t* xq;
  const float* rs;
  const int8_t* w;
  const float* scale;
  const float* bias;               // (N,) or null
  __nv_bfloat16* out;
  int M, N, K, G;
};

}  // namespace vtt_int8

extern "C" const char* vtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
