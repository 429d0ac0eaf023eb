// K2: the fused UNet-1D conditional residual block, S stacked networks.
//
// Replaces the TPU kernel vla_touch_tpu/ops/pallas_unet.py::resblock_fused
// (the pl.pallas_call at :203, body _resblock_kernel :53): per stacked
// network s and batch row b,
//
//   h   = Mish(GroupNorm(conv_k(x; w0) + b0))            (n_groups groups, eps)
//   h   = scale * h + bias,  [scale|bias] = Mish(cond) @ fw + fb   (FiLM)
//   out = Mish(GroupNorm(conv_k(h; w1) + b1)) + residual(x)
//
// where residual is a 1x1 conv (wr, br) when Cin != C, else the identity.
// As in the TPU kernel (pallas_unet.py:87-96, 112-114, 123-125) the
// products take bf16 operands (x, the FiLM'd h, Mish(cond)) and the bf16
// weights, with float32 sums; bias, GroupNorm, Mish and FiLM are float32.
//
// What bounds it on an H100: bytes.  At batch 1 each weight meets T <= 64
// time steps, so the block streams its weights (up to 13 MB a call) at
// under 16 operations a byte.  The design spreads every weight matrix over
// the whole card and reads each weight byte once, in ONE cooperative
// launch whose blocks are all resident (occupancy API; two per SM):
//
//   phase 1  the products conv0, FiLM and the 1x1 residual, cut into items
//            of 64 output columns x one reduction split (the plan,
//            ops/unet_kernels.py::k2_plan, sizes the splits so that the
//            items about fill the grid); each item streams its weight rows
//            through a 4-slot cp.async ring (16-byte pieces, 4 mma steps
//            of 16 rows a slot) and runs mma.sync
//            m16n8k16 bf16 -> f32 on ldmatrix fragments: the time axis is
//            one M = 16 tile (T = 4, 8 zero-padded) or, above 16 steps, two
//            (the trained horizon 32), three or four (up to the 64-step
//            chunk), a kernel per count; each warp one 8-column tile; a tap
//            d of the conv reads the staged input rows
//            shifted by d; the item writes its float32 partial to scratch;
//   --- grid barrier
//   phase 2  one item per (s, b, group): conv0's splits summed in split
//            order + b0, the group's statistics (two passes, block sums in
//            a fixed order), GroupNorm0, Mish and FiLM (its splits summed
//            likewise), as bf16: conv1's operand;
//   --- grid barrier
//   phase 3  conv1's items as phase 1's, on that operand;
//   --- grid barrier
//   phase 4  one item per (s, b, group): conv1's splits + b1, GroupNorm1,
//            Mish, + the residual, bf16 out.
//
// A norm item issues each element's loads (split partials, norm weights,
// FiLM or residual) in one round trip.  The scratch (partials, conv1's
// operand) is one buffer the wrapper allocates; every element is written
// before it is read in each call, so nothing needs resetting between calls
// or graph replays, and every sum runs in a fixed order: the output is the
// same bits on every call.  Data written by other blocks before a barrier
// is read with ld.global.cg (from L2).
//
// Long time axes and wide blocks.  Above 64 steps the product items walk
// the time axis in chunks of 64 (the four-tile kernel), each chunk staging
// its rows of A and streaming the item's weights again (from L2 after the
// first).  A block whose layout (the ring, A over all input channels, and a
// group's values held for the norm phases: 20 T C / G bytes) does not fit
// one SM's shared memory takes two measures, in turn, until it does: the
// plan cuts the products (FiLM's too) into splits of at most WCAP_CHUNKS
// 16-channel chunks of input (A at most 256 channels wide), then the norm
// items stream
// a group's values over T from the float32 partials in L2 (three passes:
// the sum, the squared deviations, the output) instead of holding them.
// The sums run in the held version's order, so both give the same bits.
// Those shapes take their own kernels (BIG: the time-chunk loop and both
// norm routes, one block an SM, so that nothing spills); every shape of at
// most 64 steps that fits as it is keeps its layout, plan and kernel.
//
// Not yet done (later work): one persistent launch per UNet pass, and
// overlapping the next block's weight stream with this block's epilogue.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;                     // threads per block
constexpr int NWARP = NT / 32;
constexpr int CT = NWARP * 8;               // output columns of a product item
constexpr int KS = 16;                      // reduction rows of one mma step
constexpr int SR = 4;                       // mma steps per ring stage
constexpr int STAGES = 4;                   // 5 measured 1-2 % slower (PERF.md)
constexpr int WPITCH = CT + 8;              // bf16 per ring row: 144 bytes
constexpr int STAGE_ELEMS = SR * KS * WPITCH;
constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
constexpr int MT = 16;                      // time rows of one m16 tile
constexpr int MAXNM = 4;                    // m16 tiles of one time chunk
constexpr int TCH = MAXNM * MT;             // time steps of one chunk: 64
constexpr int WCAP_CHUNKS = 16;             // 16-channel chunks of A past one SM's layout

// m16 tiles a product item holds at a time for a time axis of T steps
__host__ __device__ __forceinline__ int mtiles(int T) {
  const int m = (T + MT - 1) / MT;
  return m < MAXNM ? m : MAXNM;
}

// One product of a phase: y[t, n] = sum_{d, ci} A[t + d + shift, ci] *
// w[s, d, ci, n] over `taps` taps of `rci` input channels, cut into
// `splits` ranges of its mma steps (step st = c16 * taps + d covers input
// channels [16 c16, 16 c16 + 16) of tap d).  A (src): SRC_X, the block's
// input; SRC_COND, one row, Mish(cond), shared by every output row;
// SRC_H, conv1's operand (the bf16 scratch phase 2 wrote).
enum { SRC_X = 0, SRC_COND = 1, SRC_H = 2 };

struct Job {
  const bf16* w;                            // (S, taps, rci, ncols)
  float* part;                              // (S, B, splits, rows, ncols)
  int rci, taps, shift, ncols, splits, rows, src;
};

struct Args {
  const bf16 *x, *cond, *b0, *g0w, *g0b, *fb, *b1, *g1w, *g1b, *br;
  bf16* h;                                  // scratch (S, B, T, C): conv1's operand
  bf16* out;                                // (S, B, T, C)
  Job jobs[4];                              // phase 1: conv0, film[, residual]; [3]: conv1
  int n1, has_res;
  int S, B, T, C, K, n_groups;
  int hold;                                 // the norm items hold a group's values in smem
  int hv_off;                               // bytes: a group's float32 values (or the sums' scratch)
  float eps;
};

__device__ __forceinline__ float mish(float x) {
  const float sp = x > 20.f ? x : log1pf(expf(x));
  return x * tanhf(sp);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16) . b (16x8 bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float bf(const bf16* p) { return __bfloat162float(*p); }

// a bf16 that another block of this launch wrote before a grid barrier
__device__ __forceinline__ float ld_bf16_l2(const bf16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// Block-wide sum of one float in a fixed order; every thread gets it.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < NWARP; ++w) s += scratch[w];
  return s;
}

// first mma step of split z of `steps` (ops/unet_kernels.py::k2_split_steps)
__device__ __forceinline__ int split_step(int z, int steps, int splits) {
  return (int)((long long)z * steps / splits);
}

// One element of a product: its split partials summed in split order (p:
// split 0's, `stride` floats apart), from L2 (other blocks wrote them
// before a grid barrier).
__device__ __forceinline__ float split_sum(const float* p, int splits, size_t stride) {
  float v = __ldcg(p);
#pragma unroll 8
  for (int z = 1; z < splits; ++z) v += __ldcg(p + z * stride);
  return v;
}

// GroupNorm statistics (mean, rstd) of channels [c0, c0 + gsz) of a conv of
// network s, row sb: hv[t * gsz + c'] = its split sums + bias; two passes,
// block sums in a fixed order.  extra(e, t, c) runs beside each value's
// loads, so that a caller's own loads of the element share their round
// trip (the loop is unrolled so that a thread's elements share one too).
// Ends with hv complete for every thread.
template <typename Extra>
__device__ float2 group_stats(const Args& a, const Job& jb, int s, int sb, int c0, const bf16* bias,
                              float* hv, float* red, Extra extra) {
  const int T = a.T, C = a.C, gsz = C / a.n_groups, n = T * gsz;
  const float* part = jb.part + (size_t)sb * jb.splits * T * C;
  float sum = 0.f;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += NT) {
    const int t = e / gsz, c = c0 + e - t * gsz;
    const float* p = part + (size_t)t * C + c;
    extra(e, t, c);
    const float v = split_sum(p, jb.splits, (size_t)T * C) + bf(bias + (size_t)s * C + c);
    hv[e] = v;
    sum += v;
  }
  const float mean = block_sum(sum, red) / n;
  float sq = 0.f;
  for (int e = threadIdx.x; e < n; e += NT) {
    const float d = hv[e] - mean;
    sq += d * d;
  }
  return make_float2(mean, rsqrtf(block_sum(sq, red) / n + a.eps));
}

// The mma steps [st0, st1) of split z of a job.
__device__ __forceinline__ int2 item_steps(const Job& jb, int z) {
  const int steps = jb.taps * ((jb.rci + KS - 1) / KS);
  return make_int2(split_step(z, steps, jb.splits), split_step(z + 1, steps, jb.splits));
}

// Stage sg of an item's weights (network s, columns [n0, n0 + 64), steps
// [st.x, st.y)) into ring slot q: SR * KS rows, 16-byte pieces; rows past
// the split or the input channels, columns past ncols, are 0.
__device__ __forceinline__ void load_stage(const Job& jb, int s, int n0, int2 st, int sg, int q,
                                           bf16* ring) {
  constexpr int PR = CT / 8;
  const bf16* w = jb.w + (size_t)s * jb.taps * jb.rci * jb.ncols;
  for (int i = threadIdx.x; i < SR * KS * PR; i += NT) {
    const int row = i / PR, p = i % PR;
    const int k = st.x + sg * SR + row / KS;
    const int c16 = k / jb.taps, d = k - c16 * jb.taps;
    const int ci = c16 * KS + row % KS, col = n0 + p * 8;
    const bool in = k < st.y && ci < jb.rci && col < jb.ncols;
    cp_async16(ring + q * STAGE_ELEMS + row * WPITCH + p * 8,
               in ? w + ((size_t)d * jb.rci + ci) * jb.ncols + col : w, in ? 16 : 0);
  }
}

// One product item: network s, batch row b, output columns [n0, n0 + 64),
// split z of the job's mma steps, time rows [t0, t0 + 16 NM).  NM: the m16
// tiles of the time chunk (a template argument, so that T <= 16 compiles to
// one tile's code).
template <int NM>
__device__ void product_item(const Args& a, const Job& jb, int s, int b, int n0, int z,
                             int t0, unsigned char* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int sb = s * a.B + b;
  const int taps = jb.taps, rci = jb.rci, ncols = jb.ncols;
  const int2 st = item_steps(jb, z);
  const int c_lo = st.x / taps, c_hi = (st.y - 1) / taps + 1;    // its 16-channel chunks
  const int width = (c_hi - c_lo) * KS, lda = width + 8;
  const int nstage = (st.y - st.x + SR - 1) / SR;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* abuf = ring + STAGES * STAGE_ELEMS;

  // the weights first: their stages stream while A is staged
#pragma unroll
  for (int sg = 0; sg < STAGES - 1; ++sg) {
    if (sg < nstage) load_stage(jb, s, n0, st, sg, sg, ring);
    cp_async_commit();
  }

  // A: the item's input channels, bf16.  Row r holds time t0 + r - K/2
  // (zero outside [0, T)), so tap d of output row t0 + t reads row t + d and the
  // residual (shift K/2) row t + K/2.  The film product: one row.  The
  // loops are unrolled so that a thread's loads share one round trip.
  if (jb.src == SRC_COND) {
    for (int e = tid; e < width; e += NT) {
      const int ci = c_lo * KS + e;
      const float v = ci < rci ? mish(bf(a.cond + (size_t)sb * rci + ci)) : 0.f;
      abuf[e] = __float2bfloat16(v);
    }
  } else {
    const int rows = NM * MT + a.K - 1, pad = a.K / 2;
    const bf16* sp = (jb.src == SRC_H ? a.h : a.x) + (size_t)sb * a.T * rci;
#pragma unroll 4
    for (int e = tid; e < rows * width; e += NT) {
      const int r = e / width, cc = e - r * width;
      const int tau = t0 + r - pad, ci = c_lo * KS + cc;
      float v = 0.f;
      if (tau >= 0 && tau < a.T && ci < rci) {
        const bf16* p = sp + (size_t)tau * rci + ci;
        v = jb.src == SRC_H ? ld_bf16_l2(p) : bf(p);
      }
      abuf[r * lda + cc] = __float2bfloat16(v);
    }
  }

  const int nm = jb.src == SRC_COND ? 1 : NM;   // the film product: one row
  float acc[NM][4] = {};
  for (int sg = 0; sg < nstage; ++sg) {
    cp_async_wait<STAGES - 2>();            // stage sg has landed
    __syncthreads();                        // (and A is staged; every warp is past sg - 1)
    if (sg + STAGES - 1 < nstage)
      load_stage(jb, s, n0, st, sg + STAGES - 1, (sg + STAGES - 1) % STAGES, ring);
    cp_async_commit();
    const bf16* stg = ring + (sg % STAGES) * STAGE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < SR; ++kk) {
      const int k = st.x + sg * SR + kk;
      if (k >= st.y) break;
      const int c16 = k / taps, d = k - c16 * taps;
      const int ac = (c16 - c_lo) * KS + (lane >> 4) * 8;
      unsigned bfr[2];
      ldmatrix_x2_trans(bfr, stg + (kk * KS + (lane & 15)) * WPITCH + warp * 8);
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        if (m >= nm) break;
        const bf16* ap = jb.src == SRC_COND
                             ? abuf + ac
                             : abuf + (m * MT + (lane & 15) + d + jb.shift) * lda + ac;
        unsigned af[4];
        ldmatrix_x4(af, ap);
        mma_bf16(acc[m], af, bfr);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                          // the ring and A are free for the next item

  const int col = n0 + warp * 8 + t * 2;
  if (col < ncols) {
    float* part = jb.part + (((size_t)sb * jb.splits + z) * jb.rows) * ncols + col;
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = t0 + m * MT + g + h * 8;
        if (m < nm && row < jb.rows) {
          part[(size_t)row * ncols] = acc[m][h * 2];
          part[(size_t)row * ncols + 1] = acc[m][h * 2 + 1];
        }
      }
  }
}

// Item `it` of a phase's jobs: job by job, then network, column tile,
// split; false past the last.
__device__ __forceinline__ bool item_of(const Args& a, const Job* jobs, int njobs, int it,
                                        Job& jb, int& s, int& n0, int& z) {
  for (int j = 0; j < njobs; ++j) {
    const int tiles = (jobs[j].ncols + CT - 1) / CT;
    const int n = a.S * tiles * jobs[j].splits;
    if (it < n) {
      jb = jobs[j];
      s = it / (tiles * jb.splits);
      const int rem = it - s * tiles * jb.splits;
      n0 = rem / jb.splits * CT;
      z = rem - rem / jb.splits * jb.splits;
      return true;
    }
    it -= n;
  }
  return false;
}

// Every item of the phase's jobs over the grid, each over every batch row
// and (BIG) time chunk (the film product: one row).
template <int NM, bool BIG>
__device__ void product_phase(const Args& a, const Job* jobs, int njobs, unsigned char* smem) {
  Job jb;
  int s, n0, z;
  for (int it = blockIdx.x; item_of(a, jobs, njobs, it, jb, s, n0, z); it += gridDim.x)
    for (int b = 0; b < a.B; ++b) {
      if constexpr (BIG) {
        for (int t0 = 0; t0 < jb.rows; t0 += TCH) product_item<NM>(a, jb, s, b, n0, z, t0, smem);
      } else {
        product_item<NM>(a, jb, s, b, n0, z, 0, smem);
      }
    }
}

// GroupNorm statistics (mean, rstd) of channels [c0, c0 + gsz) of a conv of
// network s, row sb, streamed: value(e) recomputes element e (its split
// sums + bias) from L2 in each pass, summed in group_stats' order.
template <typename Value>
__device__ float2 group_stats_stream(const Args& a, int n, float* red, Value value) {
  float sum = 0.f;
  for (int e = threadIdx.x; e < n; e += NT) sum += value(e);
  const float mean = block_sum(sum, red) / n;
  float sq = 0.f;
  for (int e = threadIdx.x; e < n; e += NT) {
    const float d = value(e) - mean;
    sq += d * d;
  }
  return make_float2(mean, rsqrtf(block_sum(sq, red) / n + a.eps));
}

// norm0_phase over a group streamed from L2 (a.hold == 0)
__device__ void norm0_phase_stream(const Args& a, unsigned char* smem) {
  const int C = a.C, T = a.T, gsz = C / a.n_groups, n = T * gsz;
  float* red = reinterpret_cast<float*>(smem + a.hv_off);
  const Job& cj = a.jobs[0];
  const Job& fj = a.jobs[1];
  for (int it = blockIdx.x; it < a.S * a.B * a.n_groups; it += gridDim.x) {
    const int sb = it / a.n_groups, q = it - sb * a.n_groups;
    const int s = sb / a.B;
    const float* part = cj.part + (size_t)sb * cj.splits * T * C;
    const float* fp = fj.part + (size_t)sb * fj.splits * 2 * C;
    auto value = [&](int e) {
      const int t = e / gsz, c = q * gsz + e - t * gsz;
      return split_sum(part + (size_t)t * C + c, cj.splits, (size_t)T * C) +
             bf(a.b0 + (size_t)s * C + c);
    };
    const float2 st = group_stats_stream(a, n, red, value);
    for (int e = threadIdx.x; e < n; e += NT) {
      const int t = e / gsz, c = q * gsz + e - t * gsz;
      const float y = mish((value(e) - st.x) * st.y * bf(a.g0w + (size_t)s * C + c) +
                           bf(a.g0b + (size_t)s * C + c));
      const float fs = split_sum(fp + c, fj.splits, 2 * (size_t)C) +
                       bf(a.fb + (size_t)s * 2 * C + c);
      const float fo = split_sum(fp + C + c, fj.splits, 2 * (size_t)C) +
                       bf(a.fb + (size_t)s * 2 * C + C + c);
      a.h[((size_t)sb * T + t) * C + c] = __float2bfloat16(fs * y + fo);
    }
  }
}

// out_phase over a group streamed from L2 (a.hold == 0)
__device__ void out_phase_stream(const Args& a, unsigned char* smem) {
  const int C = a.C, T = a.T, gsz = C / a.n_groups, n = T * gsz;
  float* red = reinterpret_cast<float*>(smem + a.hv_off);
  const Job& cj = a.jobs[3];
  const Job& rj = a.jobs[2];
  for (int it = blockIdx.x; it < a.S * a.B * a.n_groups; it += gridDim.x) {
    const int sb = it / a.n_groups, q = it - sb * a.n_groups;
    const int s = sb / a.B;
    const float* part = cj.part + (size_t)sb * cj.splits * T * C;
    auto value = [&](int e) {
      const int t = e / gsz, c = q * gsz + e - t * gsz;
      return split_sum(part + (size_t)t * C + c, cj.splits, (size_t)T * C) +
             bf(a.b1 + (size_t)s * C + c);
    };
    const float2 st = group_stats_stream(a, n, red, value);
    for (int e = threadIdx.x; e < n; e += NT) {
      const int t = e / gsz, c = q * gsz + e - t * gsz;
      const float y = mish((value(e) - st.x) * st.y * bf(a.g1w + (size_t)s * C + c) +
                           bf(a.g1b + (size_t)s * C + c));
      const float res =
          a.has_res ? split_sum(rj.part + (size_t)sb * rj.splits * T * C + (size_t)t * C + c,
                                rj.splits, (size_t)T * C) + bf(a.br + (size_t)s * C + c)
                    : bf(a.x + ((size_t)sb * T + t) * C + c);     // Cin == C
      a.out[((size_t)sb * T + t) * C + c] = __float2bfloat16(y + res);
    }
  }
}

// One item per (s, b, group): conv0's split sums + b0, GroupNorm0, Mish and
// FiLM -> conv1's bf16 operand; ex holds each element's norm weight and
// bias and FiLM scale and bias.
__device__ void norm0_phase(const Args& a, unsigned char* smem) {
  const int C = a.C, T = a.T, gsz = C / a.n_groups, n = T * gsz;
  float* hv = reinterpret_cast<float*>(smem + a.hv_off);
  float* red = hv + n;
  float* ex = red + NWARP;
  const Job& fj = a.jobs[1];                // film: (S, B, splits, 1, 2C)
  for (int it = blockIdx.x; it < a.S * a.B * a.n_groups; it += gridDim.x) {
    const int sb = it / a.n_groups, q = it - sb * a.n_groups;
    const int s = sb / a.B;
    const float* fp = fj.part + (size_t)sb * fj.splits * 2 * C;
    const float2 st = group_stats(a, a.jobs[0], s, sb, q * gsz, a.b0, hv, red,
                                  [&](int e, int, int c) {
      ex[e] = bf(a.g0w + (size_t)s * C + c);
      ex[n + e] = bf(a.g0b + (size_t)s * C + c);
      ex[2 * n + e] = split_sum(fp + c, fj.splits, 2 * (size_t)C) +
                      bf(a.fb + (size_t)s * 2 * C + c);
      ex[3 * n + e] = split_sum(fp + C + c, fj.splits, 2 * (size_t)C) +
                      bf(a.fb + (size_t)s * 2 * C + C + c);
    });
    for (int e = threadIdx.x; e < n; e += NT) {
      const int t = e / gsz, c = q * gsz + e - t * gsz;
      const float y = mish((hv[e] - st.x) * st.y * ex[e] + ex[n + e]);
      a.h[((size_t)sb * T + t) * C + c] = __float2bfloat16(ex[2 * n + e] * y + ex[3 * n + e]);
    }
    __syncthreads();                        // hv and ex are free for the next item
  }
}

// One item per (s, b, group): conv1's split sums + b1, GroupNorm1, Mish,
// + the residual (its split sums + br, or x), bf16 out; ex holds each
// element's norm weight and bias and residual.
__device__ void out_phase(const Args& a, unsigned char* smem) {
  const int C = a.C, T = a.T, gsz = C / a.n_groups, n = T * gsz;
  float* hv = reinterpret_cast<float*>(smem + a.hv_off);
  float* red = hv + n;
  float* ex = red + NWARP;
  const Job& rj = a.jobs[2];
  for (int it = blockIdx.x; it < a.S * a.B * a.n_groups; it += gridDim.x) {
    const int sb = it / a.n_groups, q = it - sb * a.n_groups;
    const int s = sb / a.B;
    const float2 st = group_stats(a, a.jobs[3], s, sb, q * gsz, a.b1, hv, red,
                                  [&](int e, int t, int c) {
      ex[e] = bf(a.g1w + (size_t)s * C + c);
      ex[n + e] = bf(a.g1b + (size_t)s * C + c);
      ex[2 * n + e] =
          a.has_res ? split_sum(rj.part + (size_t)sb * rj.splits * T * C + (size_t)t * C + c,
                                rj.splits, (size_t)T * C) + bf(a.br + (size_t)s * C + c)
                    : bf(a.x + ((size_t)sb * T + t) * C + c);     // Cin == C
    });
    for (int e = threadIdx.x; e < n; e += NT) {
      const int t = e / gsz, c = q * gsz + e - t * gsz;
      const float y = mish((hv[e] - st.x) * st.y * ex[e] + ex[n + e]);
      a.out[((size_t)sb * T + t) * C + c] = __float2bfloat16(y + ex[2 * n + e]);
    }
    __syncthreads();                        // hv and ex are free for the next item
  }
}

// BIG: a time axis past one 64-step chunk or a layout not held as it is
// (one block an SM)
template <int NM, bool BIG>
__global__ void __launch_bounds__(NT, BIG ? 1 : 2) resblock_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  product_phase<NM, BIG>(a, a.jobs, a.n1, smem);         // conv0, film, residual
  grid.sync();
  if (!BIG || a.hold)                                    // GN0, Mish, FiLM -> h
    norm0_phase(a, smem);
  else
    norm0_phase_stream(a, smem);
  grid.sync();
  product_phase<NM, BIG>(a, a.jobs + 3, 1, smem);        // conv1
  grid.sync();
  if (!BIG || a.hold)                                    // GN1, Mish, + residual
    out_phase(a, smem);
  else
    out_phase_stream(a, smem);
}

// Dynamic shared memory of a block: the ring, the widest A (the m16 tiles
// of a time chunk plus K - 1 rows of `chunks` 16-channel chunks of input,
// or the film row of `gchunks`), then at hv_off a group's float32 values,
// the block sums' scratch and four float32 values per element of the group
// (the norm phases' ex) when `hold`, else the block sums' scratch alone.
size_t resblock_hv_off(int T, int chunks, int gchunks, int K) {
  size_t a_elems = (size_t)(mtiles(T) * MT + K - 1) * (chunks * KS + 8);
  const size_t film = (size_t)gchunks * KS + 8;
  if (film > a_elems) a_elems = film;
  return (RING_BYTES + 2 * a_elems + 15) / 16 * 16;
}

struct Layout {
  int wcap;       // 16-channel chunks of input a split may span (0: any)
  int hold;       // the norm items hold a group's values
  size_t hv_off, smem;
  bool big;       // the BIG kernels: past 64 steps or not held as it is
};

// The block's layout on one SM of `optin` bytes of shared memory: as it is
// where it fits, else A capped at WCAP_CHUNKS chunks, then the norm values
// streamed (see the head of this file).
Layout resblock_layout(int T, int Cin, int C, int G, int K, int n_groups, int optin) {
  const int chunks = ((Cin > C ? Cin : C) + KS - 1) / KS, gchunks = (G + KS - 1) / KS;
  const size_t held = 4 * (5 * (size_t)T * (C / n_groups) + NWARP);
  Layout L{0, 1, resblock_hv_off(T, chunks, gchunks, K), 0, T > TCH};
  L.smem = L.hv_off + held;
  if (L.smem <= (size_t)optin) return L;
  L.big = true;
  if (chunks > WCAP_CHUNKS || gchunks > WCAP_CHUNKS) {
    L.wcap = WCAP_CHUNKS;
    L.hv_off = resblock_hv_off(T, chunks < WCAP_CHUNKS ? chunks : WCAP_CHUNKS,
                               gchunks < WCAP_CHUNKS ? gchunks : WCAP_CHUNKS, K);
    L.smem = L.hv_off + held;
    if (L.smem <= (size_t)optin) return L;
  }
  L.hold = 0;
  L.smem = L.hv_off + 4 * NWARP;
  return L;
}

// The most 16-channel chunks of input one of `splits` splits of a product
// of `taps` taps over `chunks` chunks spans (item_steps' ranges).
int split_chunks(int chunks, int taps, int splits) {
  const int steps = taps * chunks;
  int most = 0;
  for (int z = 0; z < splits; ++z) {
    const int st0 = (int)((long long)z * steps / splits);
    const int st1 = (int)((long long)(z + 1) * steps / splits);
    const int n = (st1 - 1) / taps + 1 - st0 / taps;
    if (n > most) most = n;
  }
  return most;
}

cudaError_t smem_optin(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// The kernel for a time axis of T steps (one to four m16 tiles a chunk),
// BIG or not.
template <bool BIG>
const void* kernel_of(int T) {
  switch (mtiles(T)) {
    case 1: return (const void*)resblock_kernel<1, BIG>;
    case 2: return (const void*)resblock_kernel<2, BIG>;
    case 3: return (const void*)resblock_kernel<3, BIG>;
    default: return (const void*)resblock_kernel<4, BIG>;
  }
}

const void* resblock_kernel_for(int T, bool big) {
  return big ? kernel_of<true>(T) : kernel_of<false>(T);
}

// The grid of the cooperative launch of the kernel for T steps: every block
// resident (occupancy API), 0 when not one block fits an SM.  Attribute and
// occupancy calls run once per (shared-memory size, kernel) and are kept,
// so that a launch inside CUDA-graph capture makes none; each kernel's
// shared-memory limit only rises (the largest size any launch asked for),
// so a narrower call never lowers it under a wider one's cached launch.
cudaError_t resblock_grid(size_t smem, int T, bool big, int* grid) {
  struct Entry { size_t smem; int nm, grid; bool big; };
  static Entry cache[32];
  static int n = 0;
  static size_t limit[2][MAXNM] = {};
  const int nm = mtiles(T);
  const void* kern = resblock_kernel_for(T, big);
  for (int i = 0; i < n; ++i)
    if (cache[i].smem == smem && cache[i].nm == nm && cache[i].big == big) {
      *grid = cache[i].grid;
      return cudaSuccess;
    }
  cudaError_t err;
  int dev = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  if (smem > (size_t)optin) {
    *grid = 0;
    return cudaSuccess;
  }
  if (smem > limit[big][nm - 1]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    limit[big][nm - 1] = smem;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem)) !=
      cudaSuccess)
    return err;
  *grid = per_sm * sms;
  if (n < 32) cache[n++] = Entry{smem, nm, *grid, big};
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* vtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// *ctas = the blocks of one cooperative launch at this shape (0: one block
// does not fit an SM) and *wcap the 16-channel chunks of input one split
// may span (0: any); the plan (ops/unet_kernels.py::k2_plan) sizes its
// splits to them.
int resblock_ctas(int T, int Cin, int C, int G, int K, int n_groups, int* ctas, int* wcap) {
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  const Layout L = resblock_layout(T, Cin, C, G, K, n_groups, optin);
  *wcap = L.wcap;
  return (int)resblock_grid(L.smem, T, L.big, ctas);
}

// x (S, B, T, Cin), cond (S, B, G), w0 (S, K, Cin, C), w1 (S, K, C, C),
// fw (S, G, 2C), wr (S, Cin, C) or null (identity residual), vectors
// (S, C) / fb (S, 2C); all bf16 contiguous, weights 16-byte aligned, C %
// 16 == 0, any T.  The splits p0, pf, pr, p1 of conv0, FiLM, the
// residual and conv1 come from k2_plan (each split of conv0, the residual
// and conv1 within resblock_ctas' wcap chunks of input); scratch holds
// float32 partials (S, B, p0, T, C), (S, B, pf, 2C), (S, B, pr, T, C) (with
// wr), (S, B, p1, T, C), then conv1's bf16 operand (S, B, T, C):
// scratch_bytes at least that.  out (S, B, T, C) bf16.
int resblock_bf16(const void* x, const void* cond, const void* w0, const void* b0,
                  const void* g0w, const void* g0b, const void* fw, const void* fb,
                  const void* w1, const void* b1, const void* g1w, const void* g1b,
                  const void* wr, const void* br, void* scratch, long long scratch_bytes,
                  void* out, int S, int B, int T, int Cin, int C, int G, int K, int n_groups,
                  float eps, int p0, int pf, int pr, int p1, void* stream) {
  const int has_res = wr != nullptr;
  const int st0 = K * ((Cin + KS - 1) / KS), stf = (G + KS - 1) / KS;
  const int str = (Cin + KS - 1) / KS, st1 = K * ((C + KS - 1) / KS);
  if (T < 1 || C % 16 || C % n_groups || K % 2 == 0 || p0 < 1 || p0 > st0 ||
      pf < 1 || pf > stf || p1 < 1 || p1 > st1 || (has_res && (pr < 1 || pr > str)))
    return (int)cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  const Layout L = resblock_layout(T, Cin, C, G, K, n_groups, optin);
  if (L.wcap && (split_chunks((Cin + KS - 1) / KS, K, p0) > L.wcap ||
                 split_chunks((C + KS - 1) / KS, K, p1) > L.wcap ||
                 split_chunks((G + KS - 1) / KS, 1, pf) > L.wcap ||
                 (has_res && split_chunks((Cin + KS - 1) / KS, 1, pr) > L.wcap)))
    return (int)cudaErrorInvalidValue;
  const size_t tc = (size_t)S * B * T * C;
  float* part0 = (float*)scratch;
  float* partf = part0 + tc * p0;
  float* partr = partf + (size_t)S * B * 2 * C * pf;
  float* part1 = partr + (has_res ? tc * pr : 0);
  bf16* h = (bf16*)(part1 + tc * p1);
  if ((long long)((char*)(h + tc) - (char*)scratch) > scratch_bytes)
    return (int)cudaErrorInvalidValue;

  Args a{};
  a.x = (const bf16*)x;
  a.cond = (const bf16*)cond;
  a.b0 = (const bf16*)b0;
  a.g0w = (const bf16*)g0w;
  a.g0b = (const bf16*)g0b;
  a.fb = (const bf16*)fb;
  a.b1 = (const bf16*)b1;
  a.g1w = (const bf16*)g1w;
  a.g1b = (const bf16*)g1b;
  a.br = (const bf16*)br;
  a.h = h;
  a.out = (bf16*)out;
  a.jobs[0] = Job{(const bf16*)w0, part0, Cin, K, 0, C, p0, T, SRC_X};
  a.jobs[1] = Job{(const bf16*)fw, partf, G, 1, 0, 2 * C, pf, 1, SRC_COND};
  a.jobs[2] = Job{(const bf16*)wr, partr, Cin, 1, K / 2, C, has_res ? pr : 1, T, SRC_X};
  a.jobs[3] = Job{(const bf16*)w1, part1, C, K, 0, C, p1, T, SRC_H};
  a.n1 = has_res ? 3 : 2;
  a.has_res = has_res;
  a.S = S;
  a.B = B;
  a.T = T;
  a.C = C;
  a.K = K;
  a.n_groups = n_groups;
  a.hold = L.hold;
  a.hv_off = (int)L.hv_off;
  a.eps = eps;

  const size_t smem = L.smem;
  int grid = 0;
  err = resblock_grid(smem, T, L.big, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(resblock_kernel_for(T, L.big), dim3(grid), dim3(NT), params,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
