// K8: fused w4a8 matmul: grouped int4 weights unpacked in registers, int8
// activations, int8 tensor cores, bf16 out.
//
// Replaces the TPU kernel vla_touch_tpu/ops/pallas_matmul.py::w4a8_matmul
// (the pl.pallas_call at :395, body _w4a8_kernel :313), forward only:
//   y[m, n] = rs[m] * sum_g scale4[g, n] * (sum_{k in g} x_i8[m, k] w[n, k])
//             + bias[n]
// with x quantized per token (int8_mma.cuh), the int32 sum of each input
// group scaled BEFORE the float32 sum across groups.  The weight layout, the nibble
// unpacking and the per-warp grouped dot are in w4_group.cuh, shared with
// K9 (w4_swiglu.cu) and K10 (w4_postattn.cu).
//
// What bounds it on an H100: the weight stream, now 0.5 byte per
// parameter plus 4 bytes per (group, column) of scale4, read once.  Layout
// of the work: a CTA owns W4_BN = 16 columns and up to 80 rows; its 8
// warps split the G/2 units; each warp keeps two int32 accumulator sets
// (the unit's two groups) and one float32 set, and folds the groups into
// the float32 set with scale4 at the end of each unit; the warps' float32
// partials are summed in shared memory in a fixed order.
//
// Each warp issues a unit's scale4 values and a chunk's weight loads
// before it waits on any (w4_group.cuh::w4_warp_units, one column set).
//
// Not yet done (later work): a weight ring, split-K across CTAs, the
// backward of the JAX custom_vjp (training).

#include "w4_group.cuh"

using namespace vtt_int8;

namespace {

constexpr int NWARPS = GEMM_WARPS;
constexpr int NTHREADS = GEMM_THREADS;

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
  return quantize_then_gemm(x, x_f32, x_sm, (int8_t*)xq, (float*)rs, a, BY_MT, W4_BN,
                            (cudaStream_t)stream);
}
