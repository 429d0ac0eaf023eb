// K7: int8 GEMM for large M, Hopper's TMA + wgmma, bf16 out.
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
// it, and only wgmma reaches their int8 rate.  The design is Hopper's
// usual GEMM (sm90.cuh holds the TMA, mbarrier and wgmma helpers):
//
//   - two launches: the quantization of x (int8_mma.cuh), then the GEMM as
//     its programmatic dependent: the GEMM's producer puts the weight
//     stages of its ring in flight before griddepcontrol.wait, the codes
//     after;
//   - a persistent grid, one CTA per SM, walks the 128 x 256 output tiles
//     column band by column band, so a band's weights are read from device
//     memory about once and x's codes stay in L2; K moves
//     in 128-byte stages, and the ring runs on across a CTA's tiles, so
//     the next tile's loads overlap this tile's last stages and epilogue;
//   - TMA tensor maps of x's codes (M, K) and of the weights (N, K), both
//     K-major as integer wgmma needs, 128-byte boxes in the 128-byte
//     swizzle; TMA zero-fills the rows of the last tile past M; the maps
//     are __grid_constant__ parameters, one per launch, so a CUDA graph
//     that captures calls on other tensors keeps each call's own;
//   - a ring of STAGES = 3 slots in dynamic shared memory, a full and an
//     empty mbarrier per slot (3 x 48 KB of ring and the 64 KB staged
//     output tile fill the 227 KB a CTA may hold: a fourth slot does not
//     fit); one producer thread issues both TMA loads of a
//     stage on its full barrier and waits on the empty one before reusing
//     the slot;
//   - two consumer warpgroups, 64 rows each, issue four
//     wgmma.m64n256k32.s32.s8.s8 per stage (the descriptors' start advanced
//     32 bytes per k32 step), keep one stage's group in flight and release
//     the slot of the one before; setmaxnreg moves registers from the
//     producer warpgroup to the consumers' exact int32 accumulators;
//   - the epilogue (acc * rs) * scale + bias in float32, in the plain
//     version's order (the bf16 out is exact), staged in shared memory
//     past the ring in a swizzled layout and stored in coalesced 16-byte
//     pieces masked to M.

#include "int8_mma.cuh"
#include "sm90.cuh"

using namespace vtt_int8;
using namespace vtt_sm90;

namespace {

constexpr int BM = 128;           // output rows per CTA: two consumer warpgroups of 64
constexpr int BN = 256;           // output columns per CTA
constexpr int BK = 128;           // K bytes per stage: one swizzled 128-byte row per operand row
constexpr int NTHREADS = 384;     // warpgroup 0 produces, warpgroups 1 and 2 consume
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

constexpr int STAGES = 3;
constexpr int A_BYTES = BM * BK;           // x's codes, 16 KB
constexpr int STAGE = A_BYTES + BN * BK;   // + the weights' 32 KB
constexpr int ROW = BN * 2;                // bytes of a staged bf16 output row
// the ring, then the staged output tile, + room to align the ring to 1 KB
constexpr int SMEM = STAGES * STAGE + BM * ROW + 1024;
constexpr int ACC = BN / 2;                // s32 accumulators per consumer thread

struct K7Args {
  const float* rs;
  const float* scale;
  const float* bias;              // (N,) or null
  __nv_bfloat16* out;
  int M, N, K;
};

// A persistent grid, one CTA per SM: CTA c takes tiles c, c + gridDim.x,
// ...; tile i is row tile i % row_tiles of column band i / row_tiles, so
// the CTAs at work at any moment share a band or two of weights.  The
// ring's stage counter runs on across a CTA's tiles, so the producer loads
// the next tile's first stages while the consumers finish the last one.
__global__ void __launch_bounds__(NTHREADS, 1)
    i8mm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, K7Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float s_scale[2][BN], s_bias[2][BN];
  // the ring on a 1024-byte boundary, as the 128-byte swizzle's descriptors need
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkb = a.K / BK;
  const int row_tiles = (a.M + BM - 1) / BM;
  const int tiles = row_tiles * (a.N / BN);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- the producer warpgroup: one thread issues every load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0 && lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      int it = 0;                                  // stages issued so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile % row_tiles * BM, n0 = tile / row_tiles * BN;
        int kb = 0;
        if (it == 0) {
          // the weights need nothing of the quantize launch: the first
          // stages' go out before the wait for it, the codes after
          const int pre = min(STAGES, nkb);
          for (; kb < pre; ++kb) {
            mbar_arrive_expect_tx(&full[kb], STAGE);
            tma_load_2d(ring + kb * STAGE + A_BYTES, &wmap, &full[kb], kb * BK, n0);
          }
          asm volatile("griddepcontrol.wait;\n" ::: "memory");
          for (int k = 0; k < pre; ++k)
            tma_load_2d(ring + k * STAGE, &xmap, &full[k], k * BK, m0);
          it = pre;
        }
        for (; kb < nkb; ++kb, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);   // released
          unsigned char* slot = ring + s * STAGE;
          mbar_arrive_expect_tx(&full[s], STAGE);
          tma_load_2d(slot + A_BYTES, &wmap, &full[s], kb * BK, n0);
          tma_load_2d(slot, &xmap, &full[s], kb * BK, m0);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups: rows wg * 64 .. + 63 of each tile
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4 - 1, wt = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  const int rl = (warp & 3) * 16 + g;              // row in the warpgroup's 64, and + 8
  unsigned char* staged = ring + STAGES * STAGE + wg * 64 * ROW;
  int it = 0;                                      // stages consumed so far
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile % row_tiles * BM, n0 = tile / row_tiles * BN;
    // the tile's column scales and bias, loaded now, staged after the loop
    float sc[BN / 128], bi[BN / 128];
#pragma unroll
    for (int i = 0; i < BN / 128; ++i) {
      sc[i] = a.scale[n0 + wt + 128 * i];
      bi[i] = a.bias ? a.bias[n0 + wt + 128 * i] : 0.f;
    }
    int acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0;
    for (int kb = 0; kb < nkb; ++kb, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* slot = ring + s * STAGE;
      const uint64_t da = sw128_desc(slot + wg * 64 * BK);
      const uint64_t db = sw128_desc(slot + A_BYTES);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 32; ++k) wgmma_m64n256k32_s8(acc, da + 2 * k, db + 2 * k);
      wgmma_commit();
      wgmma_wait<1>();                            // the stage before has been read
      fence_regs(acc);
      if (kb > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

    // ---- epilogue: thread (g, t) of warp w holds rows 16 w + g and + 8 of
    // its warpgroup's 64, columns 8 j + 2 t and + 1 for each 8-column block
    // j.  The bf16 tile is staged row by row, 16-byte piece j of a row at
    // j ^ (row % 8) so that a warp's stores hit 32 banks; then the
    // warpgroup copies its 64 rows out in 16-byte pieces, a row's pieces
    // consecutive, rows past M left out.
    asm volatile("griddepcontrol.wait;\n" ::: "memory");   // rs is the quantize launch's
    const int r0 = m0 + wg * 64 + rl, r1 = r0 + 8;
    const float rs0 = r0 < a.M ? a.rs[r0] : 0.f;
    const float rs1 = r1 < a.M ? a.rs[r1] : 0.f;
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");   // the last copy-out is done
#pragma unroll
    for (int i = 0; i < BN / 128; ++i) {
      s_scale[wg][wt + 128 * i] = sc[i];
      s_bias[wg][wt + 128 * i] = bi[i];
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float s0 = s_scale[wg][c], s1 = s_scale[wg][c + 1];
      float y[4] = {__fmul_rn(__fmul_rn((float)acc[4 * j], rs0), s0),
                    __fmul_rn(__fmul_rn((float)acc[4 * j + 1], rs0), s1),
                    __fmul_rn(__fmul_rn((float)acc[4 * j + 2], rs1), s0),
                    __fmul_rn(__fmul_rn((float)acc[4 * j + 3], rs1), s1)};
      if (a.bias) {
        const float b0 = s_bias[wg][c], b1 = s_bias[wg][c + 1];
        y[0] = __fadd_rn(y[0], b0);
        y[1] = __fadd_rn(y[1], b1);
        y[2] = __fadd_rn(y[2], b0);
        y[3] = __fadd_rn(y[3], b1);
      }
      const int at = ((j ^ (rl & 7)) << 4) + 4 * t;   // rows rl and rl + 8 swizzle alike
      *reinterpret_cast<__nv_bfloat162*>(staged + rl * ROW + at) =
          __floats2bfloat162_rn(y[0], y[1]);
      *reinterpret_cast<__nv_bfloat162*>(staged + (rl + 8) * ROW + at) =
          __floats2bfloat162_rn(y[2], y[3]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");   // the rows are staged
    constexpr int CH = BN / 8;                     // 16-byte pieces of a row
    for (int i = wt; i < 64 * CH; i += 128) {
      const int row = i / CH, c = i % CH;
      const int m = m0 + wg * 64 + row;
      if (m < a.M)
        *reinterpret_cast<int4*>(a.out + (long long)m * a.N + n0 + c * 8) =
            *reinterpret_cast<const int4*>(staged + row * ROW + ((c ^ (row & 7)) << 4));
    }
  }
}

cudaError_t launch(const void* xq, const void* w, const K7Args& a, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  cudaError_t err = tma_map_2d(&xmap, xq, a.M, a.K, BM, BK);
  if (err != cudaSuccess) return err;
  err = tma_map_2d(&wmap, w, a.N, a.K, BN, BK);
  if (err != cudaSuccess) return err;
  // raised once, outside any CUDA-graph capture that follows
  static bool raised = false;
  static int sms = 0;
  if (!raised) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(i8mm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const int tiles = (a.M + BM - 1) / BM * (a.N / BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(min(tiles, sms));
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, i8mm_wgmma_kernel, xmap, wmap, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 (x_f32 == 0) or float32 with row stride x_sm elements;
// w (N, K) int8 contiguous and 16-byte aligned, K % 128 == 0; scale (N,)
// float32; bias (N,) float32 or null; xq (M, K) int8 and rs (M,) float32
// scratch; out (M, N) bf16 contiguous, N % 256 == 0.  Two launches: the
// quantization of x (rs = amax * (1/127)), then the GEMM.
extern "C" int a8w8_matmul_large(const void* x, int x_f32, long long x_sm, const void* w,
                                 const void* scale, const void* bias, void* xq, void* rs,
                                 void* out, int M, int N, int K, void* stream) {
  if (K % BK || N % BN) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = quantize_rows<true>(x, x_f32, x_sm, M, K, (int8_t*)xq, (float*)rs, st,
                                        /*rs_recip=*/1);
  if (err != cudaSuccess) return (int)err;
  const K7Args a{(const float*)rs, (const float*)scale, (const float*)bias,
                 (__nv_bfloat16*)out, M, N, K};
  return (int)launch(xq, w, a, st);
}
