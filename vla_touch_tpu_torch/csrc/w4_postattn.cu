// K10: the post-attention half of a w4 decoder layer in one launch,
//   x2 = x + o(att);  h = rmsnorm(x2) * w;  out = x2 + down(silu(gate(h)) * up(h))
// over grouped-int4 weights (o (D, Ka/2), the fused gate|up leaf (2F, D/2),
// down (D, F/2)), per-token int8 activations on att, h and the SwiGLU
// activation, bf16 out.
//
// Replaces the TPU kernel vla_touch_tpu/ops/pallas_matmul.py::
// w4_postattn_fused (the pl.pallas_call at :858, body _w4_postattn_kernel
// :697), forward only.  Numerics as w4_swiglu.cuh, plus: o's output is
// rounded to bf16 before the bf16 residual add; the norm is float32
// (mean of squares, 1 / sqrt, times the weight) and h is rounded to bf16
// BEFORE its int8 quantization (pallas_matmul.py:732); the MLP's bf16
// output adds to the bf16 x2.
//
// What bounds it on an H100: the weight stream.  At Qwen2.5-7B width (Ka =
// D = 3584, F = 18944, groups of 128) o, gate|up and down are about 115 MB
// of packed nibbles and scale4: 34 us at 3.35 TB/s.
//
// The TPU kernel runs its grid in order (o tiles into a VMEM x2, the norm
// and h's quantization at a barrier step, then K9's phases).  Here every
// block quantizes att itself into shared memory; o's tiles
// (w4_swiglu.cuh::w4_dense_phase, as K9's down) write x2 (M x D bf16) to
// wrapper-allocated scratch, which stays in L2; a grid barrier; every block
// then norms and quantizes all M rows of x2 itself (one warp per row, the
// same codes in every block) and runs K9's gate|up, amax, barrier,
// quantize, barrier and down phases, the residual added in down's
// epilogue.  Three grid barriers in one cooperative launch; a row's codes
// and norm are read 16 bytes a lane at a time.  o and down each take one
// 16-column tile per item: at Qwen2.5-7B width their 224 tiles leave 40 of
// the 264 blocks of one row tile idle, and run in two rounds on the 132 of
// two (cutting the tiles' units into segments measured slower there).

#include "w4_swiglu.cuh"

using namespace vtt_int8;

namespace {

struct PostattnArgs {
  const __nv_bfloat16* x;                                    // (M, D)
  const __nv_bfloat16* att;                                  // (M, Ka)
  const int8_t* o_w; const float* o_s; const float* o_b;     // (D, Ka/2), (Go, D), (D,)
  const float* norm_w;                                       // (D,)
  const int8_t* gu_w; const float* gu_s; const float* gu_b;  // (2F, D/2), (Gg, 2F), (2F,)
  const int8_t* dn_w; const float* dn_s; const float* dn_b;  // (D, F/2), (Gd, D), (D,)
  __nv_bfloat16* x2;                                         // scratch (M, D)
  __nv_bfloat16* act;                                        // scratch (M, F)
  int8_t* aq;                                                // scratch (M, F)
  unsigned* amax;                                            // scratch (M,)
  __nv_bfloat16* out;                                        // (M, D)
  int M, Ka, D, F, Go, Gg, Gd;
  float eps;
};

// h = bf16(x2 * (1 / sqrt(mean(x2^2) + eps)) * w) of rows [0, M) of x2 (M,
// D), written by other blocks before a grid barrier -> int8 codes in shared
// memory (row stride sld) and rs[m] = amax(h) * (1/127).  One warp per
// row, 8 values a lane at a time; the sum of squares is each lane's in
// order, then the warp's butterfly, so every block computes the same codes.
__device__ __forceinline__ void rmsnorm_quantize_shared(const __nv_bfloat16* x2, int M, int D,
                                                        const float* __restrict__ w, float eps,
                                                        int8_t* codes, int sld, float* rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  auto normed8 = [&](const int4* row, int i, float r, float (&h)[8]) {
    float f[8];
    bf16x8(__ldcg(row + i), f);
    const float4 wa = __ldg(w4 + 2 * i), wb = __ldg(w4 + 2 * i + 1);
    const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) h[q] = bf16_round(__fmul_rn(__fmul_rn(f[q], r), wv[q]));
  };
  for (int m = warp; m < M; m += MK_WARPS) {
    const int4* row = reinterpret_cast<const int4*>(x2 + (long long)m * D);
    float ss = 0.f;
    for (int i = lane; i < D / 8; i += 32) {
      float f[8];
      bf16x8(__ldcg(row + i), f);
#pragma unroll
      for (int q = 0; q < 8; ++q) ss = __fadd_rn(ss, __fmul_rn(f[q], f[q]));
    }
    ss = warp_sum(ss);
    const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)D), eps)));
    float amax = 0.f;
    for (int i = lane; i < D / 8; i += 32) {
      float h[8];
      normed8(row, i, r, h);
#pragma unroll
      for (int q = 0; q < 8; ++q) amax = fmaxf(amax, fabsf(h[q]));
    }
    amax = fmaxf(warp_max(amax), 1e-8f);
    const float inv = 127.0f / amax;
    for (int i = lane; i < D / 8; i += 32) {
      float h[8];
      normed8(row, i, r, h);
      *reinterpret_cast<int2*>(codes + m * sld + i * 8) = codes8(h, inv);
    }
    if (lane == 0) rs[m] = __fmul_rn(amax, INV127);
  }
  __syncthreads();
}

template <int MT>
__global__ void __launch_bounds__(MK_THREADS, MT == 1 ? 2 : 1) w4_postattn_kernel(PostattnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sld = (a.Ka > a.D ? a.Ka : a.D) + 16;
  int8_t* codes = reinterpret_cast<int8_t*>(smem);
  float* red_g = reinterpret_cast<float*>(smem + MT * 16 * sld);
  float* red_u = red_g + MK_WARPS * MT * 16 * W4_BN;
  float* rs = red_u + MK_WARPS * MT * 16 * W4_BN;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int M = a.M, D = a.D;

  // x2 = x + bf16(o(att))
  quantize_rows_shared(a.att, a.Ka, M, a.Ka, codes, sld, rs);
  w4_dense_phase<MT, SharedCodes>(codes, sld, a.o_w, a.o_s, M, D, a.Ka, a.Go, red_g,
                                  [&](int m, int n, float s) {
                       float o = __fmul_rn(s, rs[m]);
                       if (a.o_b) o = __fadd_rn(o, a.o_b[n]);
                       const long long e = (long long)m * D + n;
                       a.x2[e] = __float2bfloat16(
                           __fadd_rn(__bfloat162float(a.x[e]), bf16_round(o)));
                     });
  grid.sync();
  // h's codes, then the SwiGLU MLP (w4_swiglu.cu's phases)
  rmsnorm_quantize_shared(a.x2, M, D, a.norm_w, a.eps, codes, sld, rs);
  gate_up_phase<MT>(codes, sld, rs, a.gu_w, a.gu_s, a.gu_b, M, D, a.F, a.Gg,
                    a.act, a.amax, red_g, red_u);
  grid.sync();
  quantize_act_phase(a.act, a.amax, M, a.F, a.aq);
  grid.sync();
  w4_dense_phase<MT, L2Codes>(a.aq, a.F, a.dn_w, a.dn_s, M, D, a.F, a.Gd, red_g,
                              [&](int m, int n, float s) {
                       float y = __fmul_rn(s, act_scale(a.amax, m));
                       if (a.dn_b) y = __fadd_rn(y, a.dn_b[n]);
                       const long long e = (long long)m * D + n;
                       const float res = ld_bf16_l2(a.x2 + e);
                       a.out[e] = __float2bfloat16(__fadd_rn(res, bf16_round(y)));
                     });
}

}  // namespace

// x (M, D) and att (M, Ka) bf16 contiguous, 1 <= M <= 32; o_w (D, Ka/2)
// int8, o_s (Go, D), o_b (D,) or null; norm_w (D,) float32; gu_w (2F, D/2),
// gu_s (Gg, 2F), gu_b (2F,) or null; dn_w (D, F/2), dn_s (Gd, D), dn_b (D,)
// or null; x2 (M, D) bf16, act (M, F) bf16, aq (M, F) int8 and amax (M,)
// uint32 scratch; out (M, D) bf16.  Needs D and F multiples of 16, even
// group counts, group sizes multiples of 32, and w4_megakernel_fits(M,
// max(Ka, D)) (w4_swiglu.cu).
extern "C" int w4_postattn_fused(const void* x, const void* att, const void* o_w,
                                 const void* o_s, const void* o_b, const void* norm_w,
                                 const void* gu_w, const void* gu_s, const void* gu_b,
                                 const void* dn_w, const void* dn_s, const void* dn_b, void* x2,
                                 void* act, void* aq, void* amax, void* out, int M, int Ka, int D,
                                 int F, int Go, int Gg, int Gd, float eps, void* stream) {
  if (M < 1 || M > MK_MAX_M) return (int)cudaErrorInvalidValue;
  PostattnArgs a{(const __nv_bfloat16*)x, (const __nv_bfloat16*)att, (const int8_t*)o_w,
                 (const float*)o_s, (const float*)o_b, (const float*)norm_w,
                 (const int8_t*)gu_w, (const float*)gu_s, (const float*)gu_b,
                 (const int8_t*)dn_w, (const float*)dn_s, (const float*)dn_b,
                 (__nv_bfloat16*)x2, (__nv_bfloat16*)act, (int8_t*)aq, (unsigned*)amax,
                 (__nv_bfloat16*)out, M, Ka, D, F, Go, Gg, Gd, eps};
  const int MT = megakernel_mt(M);
  const void* fn =
      MT == 1 ? (const void*)w4_postattn_kernel<1> : (const void*)w4_postattn_kernel<2>;
  return launch_megakernel(fn, megakernel_smem(MT, Ka > D ? Ka : D), &a, (unsigned*)amax, M,
                           (cudaStream_t)stream);
}
