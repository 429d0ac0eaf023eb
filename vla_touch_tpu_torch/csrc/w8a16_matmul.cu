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
// tensor-core work.  The design is K6's (a8w8_matmul.cu) with bf16 x:
//
//   - a CTA owns BN = 32 output columns and up to 80 rows (MT 16-row tiles,
//     MT = 1..5 chosen from M); its 8 warps split K between them in 64-wide
//     chunks, so every weight byte is loaded once, by one warp, with one
//     128-bit load per thread and column;
//   - thread (g, t) holds the 16 weights w[n0 + g][k + t*16 .. +15] and the
//     16 bf16 of x rows g and g + 8 at the same K (two 128-bit loads a row).
//     mma.sync m16n8k16 gives it the fragment positions {2t, 2t+1, 2t+8,
//     2t+9} of a 16-deep step; step s of the chunk maps them to t*16 + 4s +
//     {0, 1, 2, 3} of x and of w alike, a permutation of K that leaves the
//     sum unchanged, so no shared-memory staging or shuffles are needed;
//   - each warp's MT x 4 float32 tiles meet in shared memory in warp order
//     (the same sum on every run), then the epilogue applies scale and bias
//     in float32 in the plain version's order.
//
// Not yet done (later work): split-K across CTAs (64 CTAs on 132 SMs at N =
// 2048), cp.async pipelining of the weight stream, fewer re-reads of x from
// L2 (each CTA reads all of its rows of x).

#include "int8_mma.cuh"

using namespace vtt_int8;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NT = 4;             // 8-column tiles per warp
constexpr int BN = NT * 8;        // output columns per CTA
constexpr int KC = 64;            // K per chunk
constexpr int W8_MAX_MT = 5;      // 16-row tiles per CTA, at most

struct W8Args {
  const __nv_bfloat16* x;          // (M, K) contiguous
  const int8_t* w;                 // (N, K) contiguous
  const float* scale;              // (N,)
  const float* bias;               // (N,) or null
  __nv_bfloat16* out;              // (M, N) contiguous
  int M, N, K;
};

typedef void (*W8Kernel)(W8Args);

// c (16x8 f32) += a (16x16 bf16, 4 regs) . b (16x8 bf16, 2 regs)
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two int8 values -> one bf16x2 register (the first in the low half)
__device__ __forceinline__ unsigned widen2(int lo, int hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// the 16 int8 of v -> 8 bf16x2 registers, bytes 2q and 2q + 1 in o[q]
__device__ __forceinline__ void widen16(const int4& v, unsigned (&o)[8]) {
  const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int wd = words[q];
    o[2 * q] = widen2((int8_t)wd, (int8_t)(wd >> 8));
    o[2 * q + 1] = widen2((int8_t)(wd >> 16), (int8_t)(wd >> 24));
  }
}

__device__ __forceinline__ void as_words(const int4& lo, const int4& hi, unsigned (&o)[8]) {
  o[0] = lo.x; o[1] = lo.y; o[2] = lo.z; o[3] = lo.w;
  o[4] = hi.x; o[5] = hi.y; o[6] = hi.z; o[7] = hi.w;
}

template <int MT>
__global__ void __launch_bounds__(NTHREADS) w8a16_gemm_kernel(W8Args a) {
  const int8_t* __restrict__ w = a.w;
  const int M = a.M, N = a.N, K = a.K;
  __shared__ float red[MT * 16][BN];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * MT * 16;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int4 zero = make_int4(0, 0, 0, 0);
  const int n_chunks = K / KC;
  for (int c = warp; c < n_chunks; c += NWARPS) {
    const int k = c * KC + t * 16;
    unsigned wb[NT][8];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + j * 8 + g;
      widen16(n < N ? ld128(w + (long long)n * K + k) : zero, wb[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r0 = m0 + i * 16 + g, r1 = r0 + 8;
      const int8_t* x0 = reinterpret_cast<const int8_t*>(a.x + (long long)r0 * K + k);
      const int8_t* x1 = reinterpret_cast<const int8_t*>(a.x + (long long)r1 * K + k);
      unsigned xa[8], xb[8];
      as_words(r0 < M ? ld128(x0) : zero, r0 < M ? ld128(x0 + 16) : zero, xa);
      as_words(r1 < M ? ld128(x1) : zero, r1 < M ? ld128(x1 + 16) : zero, xb);
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], xa[2 * s], xb[2 * s], xa[2 * s + 1], xb[2 * s + 1],
                   wb[j][2 * s], wb[j][2 * s + 1]);
    }
  }

  for (int i = tid; i < MT * 16 * BN; i += NTHREADS) (&red[0][0])[i] = 0.f;
  __syncthreads();
  for (int turn = 0; turn < NWARPS; ++turn) {
    if (warp == turn) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            red[i * 16 + g + (r >> 1) * 8][j * 8 + t * 2 + (r & 1)] += acc[i][j][r];
    }
    __syncthreads();
  }

  for (int i = tid; i < MT * 16 * BN; i += NTHREADS) {
    const int r = i / BN, col = i - r * BN;
    const int m = m0 + r, n = n0 + col;
    if (m >= M || n >= N) continue;
    float y = __fmul_rn(red[r][col], a.scale[n]);
    if (a.bias) y = __fadd_rn(y, a.bias[n]);
    a.out[(long long)m * N + n] = __float2bfloat16(y);
  }
}

const W8Kernel BY_MT[W8_MAX_MT] = {w8a16_gemm_kernel<1>, w8a16_gemm_kernel<2>,
                                   w8a16_gemm_kernel<3>, w8a16_gemm_kernel<4>,
                                   w8a16_gemm_kernel<5>};

}  // namespace

// x (M, K) bf16 contiguous and 16-byte aligned; w (N, K) int8 contiguous
// and 16-byte aligned, K % 64 == 0; scale (N,) float32; bias (N,) float32
// or null; out (M, N) bf16 contiguous.  One launch.
extern "C" int w8a16_matmul(const void* x, const void* w, const void* scale, const void* bias,
                            void* out, int M, int N, int K, void* stream) {
  if (K % KC) return (int)cudaErrorInvalidValue;
  W8Args a{(const __nv_bfloat16*)x, (const int8_t*)w, (const float*)scale, (const float*)bias,
           (__nv_bfloat16*)out, M, N, K};
  const int MT = M >= W8_MAX_MT * 16 ? W8_MAX_MT : (M + 15) / 16;
  dim3 grid((N + BN - 1) / BN, (M + MT * 16 - 1) / (MT * 16));
  BY_MT[MT - 1]<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
