// K9: the w4 SwiGLU MLP in one launch,
//   out = down(silu(gate(x)) * up(x))
// over grouped-int4 weights: the fused gate|up leaf (2F, K/2) (columns
// [0, F) gate, [F, 2F) up) and down (N, F/2), per-token int8 activations on
// x and on the activation, bf16 out.
//
// Replaces the TPU kernel vla_touch_tpu/ops/pallas_matmul.py::w4_swiglu_mlp
// (the pl.pallas_call at :648, body _w4_swiglu_kernel :526), forward only;
// numerics in w4_swiglu.cuh.
//
// What bounds it on an H100: the weight stream.  At Qwen2.5-7B width (K =
// N = 3584, F = 18944, groups of 128) the call reads 3 * 3584 * 18944 / 2
// bytes of packed nibbles plus 4 bytes per (group, column) of scale4, about
// 108 MB: 32 us at 3.35 TB/s.  The activations (M <= 32 rows) are tiny.
//
// The TPU kernel runs its grid in order: it quantizes x at step 0, streams
// gate|up tiles into a VMEM activation, quantizes that at a barrier step,
// then streams down.  CUDA blocks run at once and in no order, so:
//   - x's codes need only x, so every block quantizes x itself into its
//     shared memory (one warp per row, the same codes in every block);
//   - the activation's per-row amax spans all F columns, written by every
//     block: blocks fold their row maxima into amax[] with atomicMax, a grid
//     barrier, a grid-stride pass writes the int8 codes, a second barrier,
//     then down.  One cooperative launch (every block resident, grid sized
//     by the occupancy API) carries both barriers.
//   - the bf16 activation (M x F) and its codes live in scratch the wrapper
//     allocates: at most 1.2 MB each, they stay in the 50 MB L2, and are
//     read back with ld.global.cg.
// A gate|up work item is 16 activation columns, its gate and up tiles in
// one pass; a down item is 16 output columns.  The 8 warps of a block
// split the item's units; each warp issues a unit's scale4 values and every
// column set's weights of a chunk before it waits on any
// (w4_group.cuh::w4_warp_units).

#include "w4_swiglu.cuh"

using namespace vtt_int8;

namespace {

struct SwigluArgs {
  const __nv_bfloat16* x;                                    // (M, K)
  const int8_t* gu_w; const float* gu_s; const float* gu_b;  // (2F, K/2), (Gg, 2F), (2F,)
  const int8_t* dn_w; const float* dn_s; const float* dn_b;  // (N, F/2), (Gd, N), (N,)
  __nv_bfloat16* act;                                        // scratch (M, F)
  int8_t* aq;                                                // scratch (M, F)
  unsigned* amax;                                            // scratch (M,)
  __nv_bfloat16* out;                                        // (M, N)
  int M, K, F, N, Gg, Gd;
};

template <int MT>
__global__ void __launch_bounds__(MK_THREADS, MT == 1 ? 2 : 1) w4_swiglu_kernel(SwigluArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sld = a.K + 16;
  int8_t* xc = reinterpret_cast<int8_t*>(smem);
  float* red_g = reinterpret_cast<float*>(smem + MT * 16 * sld);
  float* red_u = red_g + MK_WARPS * MT * 16 * W4_BN;
  float* xrs = red_u + MK_WARPS * MT * 16 * W4_BN;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  quantize_rows_shared(a.x, a.K, a.M, a.K, xc, sld, xrs);
  gate_up_phase<MT>(xc, sld, xrs, a.gu_w, a.gu_s, a.gu_b, a.M, a.K, a.F, a.Gg,
                    a.act, a.amax, red_g, red_u);
  grid.sync();
  quantize_act_phase(a.act, a.amax, a.M, a.F, a.aq);
  grid.sync();
  w4_dense_phase<MT, L2Codes>(a.aq, a.F, a.dn_w, a.dn_s, a.M, a.N, a.F, a.Gd, red_g,
                              [&](int m, int n, float s) {
                       float y = __fmul_rn(s, act_scale(a.amax, m));
                       if (a.dn_b) y = __fadd_rn(y, a.dn_b[n]);
                       a.out[(long long)m * a.N + n] = __float2bfloat16(y);
                     });
}

}  // namespace

// x (M, K) bf16 contiguous, 1 <= M <= 32; gu_w (2F, K/2) int8, gu_s (Gg,
// 2F) float32, gu_b (2F,) float32 or null; dn_w (N, F/2) int8, dn_s (Gd, N)
// float32, dn_b (N,) float32 or null; act (M, F) bf16, aq (M, F) int8 and
// amax (M,) uint32 scratch; out (M, N) bf16.  Needs F and N multiples of 16,
// Gg and Gd even, group sizes multiples of 32, and w4_megakernel_fits(M, K).
extern "C" int w4_swiglu_mlp(const void* x, const void* gu_w, const void* gu_s,
                             const void* gu_b, const void* dn_w, const void* dn_s,
                             const void* dn_b, void* act, void* aq, void* amax, void* out, int M,
                             int K, int F, int N, int Gg, int Gd, void* stream) {
  if (M < 1 || M > MK_MAX_M) return (int)cudaErrorInvalidValue;
  SwigluArgs a{(const __nv_bfloat16*)x, (const int8_t*)gu_w, (const float*)gu_s,
               (const float*)gu_b, (const int8_t*)dn_w, (const float*)dn_s,
               (const float*)dn_b, (__nv_bfloat16*)act, (int8_t*)aq, (unsigned*)amax,
               (__nv_bfloat16*)out, M, K, F, N, Gg, Gd};
  const int MT = megakernel_mt(M);
  const void* fn = MT == 1 ? (const void*)w4_swiglu_kernel<1> : (const void*)w4_swiglu_kernel<2>;
  return launch_megakernel(fn, megakernel_smem(MT, K), &a, (unsigned*)amax, M,
                           (cudaStream_t)stream);
}

// *fits = whether K9 (width K) or K10 (width max(Ka, D)) serves M rows on
// the current card: megakernel_fits in w4_swiglu.cuh.
extern "C" int w4_megakernel_fits(int M, int K, int* fits) {
  return (int)megakernel_fits(M, K, fits);
}
