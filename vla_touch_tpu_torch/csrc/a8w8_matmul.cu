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
//
// What bounds it on an H100: at the serving shapes (M = 1..67 tokens, K
// and N 128..6144) it streams the int8 weights once, ~0.5 operations per
// byte, far under the ~590 int8 operations per byte where the tensor cores
// would bound it.  The design reads each weight byte once with 128-bit
// loads straight into mma fragments:
//
//   - a CTA owns BN = 32 output columns and a chunk of up to 80 rows (MT
//     16-row tiles, MT = 1..5 chosen from M); 8 warps split K between them
//     in 64-wide chunks (split-K inside the CTA), so every weight byte and
//     every x_i8 byte of the chunk is loaded by exactly one warp;
//   - each warp keeps MT x 4 int32 accumulator tiles in registers; the 8
//     warps' partial sums meet in shared memory through int32 atomics
//     (exact, so the order does not matter), then the epilogue applies
//     rs, scale and bias in float32 in the plain version's order.
//
// Not yet done (later work): cp.async / TMA pipelining of the weight
// stream, split-K across CTAs for N = 2048 (64 CTAs on 132 SMs), wgmma.

#include "int8_mma.cuh"

using namespace vtt_int8;

namespace {

constexpr int NWARPS = GEMM_WARPS;
constexpr int NTHREADS = GEMM_THREADS;
constexpr int NT = 4;             // 8-column tiles per warp
constexpr int BN = NT * 8;        // output columns per CTA
constexpr int KC = 64;            // K per chunk

template <int MT>
__global__ void __launch_bounds__(NTHREADS) a8w8_gemm_kernel(GemmArgs a) {
  const int8_t* __restrict__ xq = a.xq;
  const float* __restrict__ rs = a.rs;
  const int8_t* __restrict__ w = a.w;
  const float* __restrict__ scale = a.scale;
  const float* __restrict__ bias = a.bias;
  const int M = a.M, N = a.N, K = a.K;
  __shared__ int red[MT * 16][BN];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * MT * 16;

  for (int i = tid; i < MT * 16 * BN; i += NTHREADS) (&red[0][0])[i] = 0;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int4 zero = make_int4(0, 0, 0, 0);
  const int n_chunks = (K + KC - 1) / KC;
  for (int c = warp; c < n_chunks; c += NWARPS) {
    const int k = c * KC + t * 16;
    const bool kin = k < K;            // K % 16 == 0: all 16 bytes or none
    int4 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + j * 8 + g;
      b[j] = (kin && n < N) ? ld128(w + (long long)n * K + k) : zero;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r0 = m0 + i * 16 + g, r1 = r0 + 8;
      const int4 a_lo = (kin && r0 < M) ? ld128(xq + (long long)r0 * K + k) : zero;
      const int4 a_hi = (kin && r1 < M) ? ld128(xq + (long long)r1 * K + k) : zero;
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_chunk64(acc[i][j], a_lo, a_hi, b[j]);
    }
  }
  __syncthreads();                     // red is zeroed
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        atomicAdd(&red[i * 16 + g + (r >> 1) * 8][j * 8 + t * 2 + (r & 1)], acc[i][j][r]);
  __syncthreads();

  for (int i = tid; i < MT * 16 * BN; i += NTHREADS) {
    const int r = i / BN, col = i - r * BN;
    const int m = m0 + r, n = n0 + col;
    if (m >= M || n >= N) continue;
    float y = __fmul_rn(__fmul_rn((float)red[r][col], rs[m]), scale[n]);
    if (bias) y = __fadd_rn(y, bias[n]);
    a.out[(long long)m * N + n] = __float2bfloat16(y);
  }
}

const GemmKernel BY_MT[MAX_MT] = {a8w8_gemm_kernel<1>, a8w8_gemm_kernel<2>,
                                  a8w8_gemm_kernel<3>, a8w8_gemm_kernel<4>,
                                  a8w8_gemm_kernel<5>};

}  // namespace

// x (M, K) bf16 (x_f32 == 0) or float32 with row stride x_sm elements;
// w (N, K) int8 contiguous, K % 16 == 0; scale (N,) float32; bias (N,)
// float32 or null; xq (M, K) int8 and rs (M,) float32 scratch; out (M, N)
// bf16 contiguous.
extern "C" int a8w8_matmul(const void* x, int x_f32, long long x_sm, const void* w,
                           const void* scale, const void* bias, void* xq, void* rs,
                           void* out, int M, int N, int K, void* stream) {
  GemmArgs a{nullptr, nullptr, (const int8_t*)w, (const float*)scale, (const float*)bias,
             (__nv_bfloat16*)out, M, N, K, 0};
  return quantize_then_gemm(x, x_f32, x_sm, (int8_t*)xq, (float*)rs, a, BY_MT, BN,
                            (cudaStream_t)stream);
}
