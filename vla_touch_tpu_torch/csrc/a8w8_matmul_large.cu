// K7: tiled int8 GEMM for large M, int8 tensor cores, bf16 out.
//
// Replaces the TPU kernel vla_touch_tpu/ops/pallas_matmul.py::
// a8w8_matmul_large (the pl.pallas_call at :272, body _i8mm_kernel :230)
// together with the per-token quantization its wrapper does outside the
// kernel (:257-260):
//   amax = max(max_k |x[m, k]|, 1e-8)              x read as given: bf16 or
//   x_i8 = clip(rint(x * (127 / amax)), -127, 127)  float32, never rounded
//   y[m, n] = (sum_k x_i8[m, k] * w_i8[n, k]) * (amax * (1/127)) * scale[n]
//             + bias[n]
// The row scale is amax * (1/127), where qdense and K6 use amax / 127 (one
// ulp apart for some amax): the quantize launch of int8_mma.cuh is asked
// for it with rs_recip.
//
// What bounds it on an H100: its target, the once-per-chunk condition
// products over 4374 image tokens (the adaptor, (4374, 1152 | 2048, 2048),
// and the K/V projections, (4374, 2048, 4096)), does ~600 int8 operations
// per byte moved: 73 G operations at 4096 columns take 0.037 ms at the
// 1979 TOPS peak against 0.019 ms for its 62 MB, so the tensor cores bound
// it.  This first version is a plain tiled GEMM:
//
//   - a CTA owns a 128 x 128 output tile and walks K in 64-byte chunks
//     through shared memory, two stages deep, each thread moving two 16-byte
//     pieces of x_i8 and two of w per chunk with cp.async;
//   - its 8 warps sit 2 (M) x 4 (N), each on a 64 x 32 tile of 4 x 4
//     mma.sync m16n8k32 s8 tiles; a thread reads its fragments with one
//     128-bit shared load per row under int8_mma.cuh's K permutation
//     (mma_chunk64), and a warp's 8 rows of 64 bytes are 512 contiguous
//     bytes, so the loads are free of bank conflicts;
//   - exact int32 accumulators in registers; the epilogue applies the row
//     scale, scale and bias in float32 in the plain version's order.
//
// Not yet done (later work): wgmma, TMA, warp specialisation and a deeper
// pipeline, which the operations bound asks for.

#include "int8_mma.cuh"

using namespace vtt_int8;

namespace {

constexpr int BM = 128;           // output rows per CTA
constexpr int BN = 128;           // output columns per CTA
constexpr int KC = 64;            // K per chunk (bytes)
constexpr int STAGES = 2;
constexpr int NTHREADS = 256;
constexpr int MT = 4;             // 16-row tiles per warp
constexpr int NT = 4;             // 8-column tiles per warp
constexpr int PIECES = BM * KC / 16 / NTHREADS;   // 16-byte copies per thread and operand

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__global__ void __launch_bounds__(NTHREADS, 2) i8mm_large_kernel(GemmArgs a) {
  __shared__ __align__(16) int8_t As[STAGES][BM * KC];
  __shared__ __align__(16) int8_t Bs[STAGES][BN * KC];
  const int M = a.M, N = a.N, K = a.K;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * MT * 16, wn = (warp & 3) * NT * 8;

  // This thread's copies: piece p is row (p / 4) of the tile, bytes
  // (p % 4) * 16 .. +15 of the chunk.  Rows past M or N read the last row;
  // their results are never written.
  int soff[PIECES];
  const int8_t* asrc[PIECES];
  const int8_t* bsrc[PIECES];
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int p = tid + i * NTHREADS;
    const int r = p >> 2, col = (p & 3) * 16;
    soff[i] = r * KC + col;
    asrc[i] = a.xq + (long long)min(m0 + r, M - 1) * K + col;
    bsrc[i] = a.w + (long long)min(n0 + r, N - 1) * K + col;
  }
  auto load_chunk = [&](int stage, int chunk) {
    const long long k = (long long)chunk * KC;
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      cp_async16(&As[stage][soff[i]], asrc[i] + k);
      cp_async16(&Bs[stage][soff[i]], bsrc[i] + k);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int nk = K / KC;
  load_chunk(0, 0);
  cp_async_commit();
  for (int c = 0; c < nk; ++c) {
    if (c + 1 < nk) load_chunk((c + 1) & 1, c + 1);
    cp_async_commit();               // an empty group at the last chunk
    cp_async_wait_one();             // chunk c has landed
    __syncthreads();
    const int8_t* as = As[c & 1];
    const int8_t* bs = Bs[c & 1];
    int4 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      b[j] = *reinterpret_cast<const int4*>(bs + (wn + j * 8 + g) * KC + t * 16);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = wm + i * 16 + g;
      const int4 a_lo = *reinterpret_cast<const int4*>(as + r * KC + t * 16);
      const int4 a_hi = *reinterpret_cast<const int4*>(as + (r + 8) * KC + t * 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_chunk64(acc[i][j], a_lo, a_hi, b[j]);
    }
    __syncthreads();                 // the stage is read before it is refilled
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + h * 8;
      if (m >= M) continue;
      const float rs = a.rs[m];
      __nv_bfloat16* orow = a.out + (long long)m * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn + j * 8 + t * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= N) continue;
          float y = __fmul_rn(__fmul_rn((float)acc[i][j][h * 2 + e], rs), a.scale[n + e]);
          if (a.bias) y = __fadd_rn(y, a.bias[n + e]);
          orow[n + e] = __float2bfloat16(y);
        }
      }
    }
}

}  // namespace

// x (M, K) bf16 (x_f32 == 0) or float32 with row stride x_sm elements;
// w (N, K) int8 contiguous and 16-byte aligned, K % 64 == 0; scale (N,)
// float32; bias (N,) float32 or null; xq (M, K) int8 and rs (M,) float32
// scratch; out (M, N) bf16 contiguous.  Two launches: the quantization of
// x (rs = amax * (1/127)), then the GEMM.
extern "C" int a8w8_matmul_large(const void* x, int x_f32, long long x_sm, const void* w,
                                 const void* scale, const void* bias, void* xq, void* rs,
                                 void* out, int M, int N, int K, void* stream) {
  if (K % KC) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = quantize_rows(x, x_f32, x_sm, M, K, (int8_t*)xq, (float*)rs, st,
                                  /*rs_recip=*/1);
  if (err != cudaSuccess) return (int)err;
  GemmArgs a{(const int8_t*)xq, (const float*)rs, (const int8_t*)w, (const float*)scale,
             (const float*)bias, (__nv_bfloat16*)out, M, N, K, 0};
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  i8mm_large_kernel<<<grid, NTHREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
