// K8: fused w4a8 matmul: grouped int4 weights unpacked in registers, int8
// activations, int8 tensor cores, bf16 out.
//
// Replaces the TPU kernel vla_touch_tpu/ops/pallas_matmul.py::w4a8_matmul
// (the pl.pallas_call at :395, body _w4a8_kernel :313), forward only:
//   y[m, n] = rs[m] * sum_g scale4[g, n] * (sum_{k in g} x_i8[m, k] w[n, k])
//             + bias[n]
// with x quantized per token (int8_mma.cuh), the int32 sum of each input
// group scaled BEFORE the float32 sum across groups.
//
// Weight layout (ops/quant.py::QLinearW4): w4_pack (N, K/2) int8, K
// contiguous; byte j of row n holds w[n, j] in its low nibble and
// w[n, K/2 + j] in its high nibble (plane packing); scale4 (G, N) float32,
// G = K / gs, G even, gs % 32 == 0.  So packed bytes [u*gs, (u+1)*gs) of a
// row carry group u of the low plane and group u + G/2 of the high plane:
// one pass over them ("unit" u) feeds two int32 group accumulators.
//
// Nibbles become int8 in registers, four per 32-bit word with per-byte SIMD:
// the low nibble as (int8)(b << 4) >> 4 and the high nibble as b >> 4 are
// both "take 4 bits, sign-extend", computed as ((v ^ 8) - 8) per byte
// (__vsub4 keeps the bytes apart).  A 128-bit load of 16 packed bytes then
// gives the thread 16 low-plane and 16 high-plane values in the K order of
// int8_mma.cuh's 64-wide chunk.
//
// What bounds it on an H100: the weight stream, now 0.5 byte per
// parameter plus 4 bytes per (group, column) of scale4, read once.  Layout
// of the work, as K6's: a CTA owns BN = 16 columns and up to 80 rows; its 8
// warps split the G/2 units; each warp keeps two int32 accumulator sets
// (the unit's two groups) and one float32 set, and folds the groups into
// the float32 set with scale4 at the end of each unit; the warps' float32
// partials are summed in shared memory in a fixed order.
//
// Not yet done (later work): pipelined weight loads, split-K across CTAs,
// the backward of the JAX custom_vjp (training).

#include "int8_mma.cuh"

using namespace vtt_int8;

namespace {

constexpr int NWARPS = GEMM_WARPS;
constexpr int NTHREADS = GEMM_THREADS;
constexpr int NT = 2;             // 8-column tiles per warp
constexpr int BN = NT * 8;        // output columns per CTA

// four packed 4-bit fields (one per byte, in bits 0..3) -> four int8
__device__ __forceinline__ int sext_nibbles(unsigned v) {
  return (int)__vsub4(v ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ int4 low_plane(const int4& p) {
  return make_int4(sext_nibbles((unsigned)p.x & 0x0F0F0F0Fu),
                   sext_nibbles((unsigned)p.y & 0x0F0F0F0Fu),
                   sext_nibbles((unsigned)p.z & 0x0F0F0F0Fu),
                   sext_nibbles((unsigned)p.w & 0x0F0F0F0Fu));
}

__device__ __forceinline__ int4 high_plane(const int4& p) {
  return make_int4(sext_nibbles(((unsigned)p.x >> 4) & 0x0F0F0F0Fu),
                   sext_nibbles(((unsigned)p.y >> 4) & 0x0F0F0F0Fu),
                   sext_nibbles(((unsigned)p.z >> 4) & 0x0F0F0F0Fu),
                   sext_nibbles(((unsigned)p.w >> 4) & 0x0F0F0F0Fu));
}

template <int MT>
__global__ void __launch_bounds__(NTHREADS, 1) w4a8_gemm_kernel(GemmArgs a) {
  const int8_t* __restrict__ xq = a.xq;
  const float* __restrict__ rs = a.rs;
  const int8_t* __restrict__ wp = a.w;
  const float* __restrict__ scale4 = a.scale;
  const float* __restrict__ bias = a.bias;
  const int M = a.M, N = a.N, K = a.K, G = a.G;
  __shared__ float red[NWARPS][MT * 16][BN];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * MT * 16;
  const int KH = K / 2;               // packed bytes per row
  const int gs = K / G;
  const int HG = G / 2;

  float accf[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) accf[i][j][r] = 0.f;

  const int4 zero = make_int4(0, 0, 0, 0);
  for (int u = warp; u < HG; u += NWARPS) {
    int acc_lo[MT][NT][4], acc_hi[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc_lo[i][j][r] = acc_hi[i][j][r] = 0;

    for (int c = 0; c < gs; c += 64) {
      const bool kin = c + t * 16 < gs;   // gs % 32 == 0: whole 16 bytes or none
      const int k = u * gs + c + t * 16;  // low-plane K index = packed byte index
      int4 lo[NT], hi[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + j * 8 + g;
        const int4 p = (kin && n < N) ? ld128(wp + (long long)n * KH + k) : zero;
        lo[j] = low_plane(p);
        hi[j] = high_plane(p);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r0 = m0 + i * 16 + g, r1 = r0 + 8;
        const bool in0 = kin && r0 < M, in1 = kin && r1 < M;
        const int8_t* x0 = xq + (long long)r0 * K + k;
        const int8_t* x1 = xq + (long long)r1 * K + k;
        int4 a_lo = in0 ? ld128(x0) : zero, a_hi = in1 ? ld128(x1) : zero;
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_chunk64(acc_lo[i][j], a_lo, a_hi, lo[j]);
        a_lo = in0 ? ld128(x0 + KH) : zero;
        a_hi = in1 ? ld128(x1 + KH) : zero;
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_chunk64(acc_hi[i][j], a_lo, a_hi, hi[j]);
      }
    }
    // fold the unit's two groups into the float32 sums
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + j * 8 + t * 2 + e;
        const float s_lo = n < N ? scale4[(long long)u * N + n] : 0.f;
        const float s_hi = n < N ? scale4[(long long)(u + HG) * N + n] : 0.f;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& acc = accf[i][j][h * 2 + e];
            acc = __fadd_rn(acc, __fmul_rn((float)acc_lo[i][j][h * 2 + e], s_lo));
            acc = __fadd_rn(acc, __fmul_rn((float)acc_hi[i][j][h * 2 + e], s_hi));
          }
      }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        red[warp][i * 16 + g + (r >> 1) * 8][j * 8 + t * 2 + (r & 1)] = accf[i][j][r];
  __syncthreads();

  for (int i = tid; i < MT * 16 * BN; i += NTHREADS) {
    const int r = i / BN, col = i - r * BN;
    const int m = m0 + r, n = n0 + col;
    if (m >= M || n >= N) continue;
    float s = red[0][r][col];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) s = __fadd_rn(s, red[w][r][col]);
    float y = __fmul_rn(s, rs[m]);
    if (bias) y = __fadd_rn(y, bias[n]);
    a.out[(long long)m * N + n] = __float2bfloat16(y);
  }
}

const GemmKernel BY_MT[MAX_MT] = {w4a8_gemm_kernel<1>, w4a8_gemm_kernel<2>,
                                  w4a8_gemm_kernel<3>, w4a8_gemm_kernel<4>,
                                  w4a8_gemm_kernel<5>};

}  // namespace

// x (M, K) bf16 (x_f32 == 0) or float32 with row stride x_sm elements;
// w4_pack (N, K/2) int8 contiguous, K % 32 == 0; scale4 (G, N) float32, G
// even, (K / G) % 32 == 0; bias (N,) float32 or null; xq (M, K) int8 and rs
// (M,) float32 scratch; out (M, N) bf16 contiguous.
extern "C" int w4a8_matmul(const void* x, int x_f32, long long x_sm, const void* w4_pack,
                           const void* scale4, const void* bias, void* xq, void* rs,
                           void* out, int M, int N, int K, int G, void* stream) {
  GemmArgs a{nullptr, nullptr, (const int8_t*)w4_pack, (const float*)scale4,
             (const float*)bias, (__nv_bfloat16*)out, M, N, K, G};
  return quantize_then_gemm(x, x_f32, x_sm, (int8_t*)xq, (float*)rs, a, BY_MT, BN,
                            (cudaStream_t)stream);
}
