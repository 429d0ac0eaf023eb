// K3 and K4: flash attention over an int8 K/V cache, bf16 q and out, f32
// softmax state.  One source; the cache layout is a template parameter.
//
// Replaces the TPU kernels of vla_touch_tpu/ops/pallas_attention.py:
//   K3 flash_cross_attention_q8  (pl.pallas_call :275, body :173): K/V
//      (B, Lkv, H, D) int8, D contiguous;
//   K4 flash_cross_attention_q8t (pl.pallas_call :424, body :339): K/V
//      (B, H, D, Lkv) int8, Lkv contiguous.
// Both compute, per (b, h), with per-(b, h, d) scales ks and vs:
//   out = softmax_masked(q' . k_i8^T) . v_i8 * vs,   q' = bf16(q * D^-0.5 * ks)
// The wrapper folds the softmax and K scales into q in float32 and rounds
// once to bf16, as the TPU wrappers do (:247-248); the V scale is applied
// last (:208).  A fully masked query row returns 0.
//
// What bounds it on an H100: the int8 cache stream.  At the RDT-1B image
// cross-attention one call reads K+V = 2 x 4374 x 2048 int8 = 17.9 MB for 67
// query rows (~1 operation per byte), so its bound is ~5.3 us.  To reach the
// stream, enough CTAs must be reading at once, and each must keep its next
// tile in flight while it computes:
//
//   - split-KV: one CTA per (KV split, head, batch) covers every query row
//     of the call (up to 128: warps of 16 rows; warps past Lq only help
//     stage), so the cache is read once per head.  The split count
//     (ops/flash_attention_q8.py::split_plan, from the shape and the SM
//     count) gives >= 4 CTAs per SM with >= 2 tiles each: 18 splits of 4
//     tiles at the image shape, 576 CTAs where one CTA per (q tile, head)
//     gave 64.  Each split writes its unnormalised float32 acc and its m
//     and l per row to scratch the wrapper allocates; a second launch
//     (flash_q8_combine_kernel) merges them, m* = max m_s, l* = sum
//     e^(m_s - m*) l_s, o = sum e^(m_s - m*) acc_s / l* x vs.  A split whose
//     keys are all masked carries m = -1e30 and l = 0 and adds nothing.  One
//     split (the 64-key language cache) finalises in place: no combine.
//   - a two-slot ring of raw int8 K and V tiles (64 keys, 4 KB each at D 64)
//     filled by 16-byte cp.async.cg along the contiguous axis of each
//     layout, the ragged edge zero-filled through cp.async's source size;
//     tile t + 1 is in flight while tile t computes.  Each tile is widened
//     to bf16 (exact for int8) in shared memory in its own layout: K4's
//     (D, 64) tile is a row-major matrix_b for q.k^T and a column-major one
//     for p.v, so the cache is never transposed;
//   - per tile, as before: q.k^T and p.v as WMMA 16x16x16 bf16 tiles with f32
//     accumulation through shared memory (rows padded by 16 bytes), the
//     online softmax in f32 one row at a time, p rounded to bf16 for p.v as
//     the TPU kernel does.
//
// Head dims.  The tiles are D padded to the next multiple of 16 (DP) wide.
// K3's cache rows must start 16-byte aligned, so quantize_kv keeps a D off
// 16 (RDT-170M's 72) in storage DP wide (zero columns), built once per
// chunk; the loads copy D bytes of a row and zero-fill the rest, and the
// wrapper pads the pre-scaled q with zero columns, so the extra columns add
// nothing to a score and their outputs are never written.  Every buffer of
// the CTA grows with DP; above D 128 the launch takes fewer warps (query
// rows per CTA) until the layout fits one SM's shared memory (D 160: 80
// rows; D 256: 32), and the combine walks D in pieces of 128 columns.
//
// Not done yet: the scores, p and acc in registers (mma.sync fragments, no
// shared-memory round trip per tile), TMA and wgmma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BK = 64;            // keys per tile
constexpr int MAX_WARPS = 8;      // 16 query rows each: up to 128 rows per CTA
constexpr int MIN_WARPS = 4;      // warps that stage tiles even for few rows
constexpr int MAX_D = 256;         // the widest head dim taken
constexpr int COMBINE_D = 128;     // output columns a combine warp holds at once
constexpr int PAD_BF16 = 8;       // row padding of bf16 tiles (16 bytes)
constexpr int PAD_F32 = 4;        // row padding of float32 tiles (16 bytes)
constexpr int COMBINE_WARPS = 8;
constexpr float NEG_INF = -1e30f;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~(size_t)127; }

// Byte offsets of the shared-memory buffers of a CTA of BQ query rows.
struct Layout {
  size_t qs, ring, kt, vt, ss, ps, os, ml, valid, total;
};

template <bool TRANS>
__host__ __device__ inline Layout layout(int BQ, int D) {
  Layout L;
  size_t o = 0;
  const size_t tile = TRANS ? (size_t)D * (BK + PAD_BF16) : (size_t)BK * (D + PAD_BF16);
  L.qs = o;    o = align128(o + (size_t)BQ * (D + PAD_BF16) * sizeof(bf16));   // [BQ][D+8]
  L.ring = o;  o = align128(o + (size_t)2 * 2 * BK * D);                       // [2][K|V][BK*D] int8
  L.kt = o;    o = align128(o + tile * sizeof(bf16));                          // K tile, bf16
  L.vt = o;    o = align128(o + tile * sizeof(bf16));                          // V tile, bf16
  L.ss = o;    o = align128(o + (size_t)BQ * (BK + PAD_F32) * sizeof(float));  // scores
  L.ps = o;    o = align128(o + (size_t)BQ * (BK + PAD_BF16) * sizeof(bf16));  // p
  L.os = o;    o = align128(o + (size_t)BQ * (D + PAD_F32) * sizeof(float));   // acc
  L.ml = o;    o = align128(o + (size_t)2 * BQ * sizeof(float));               // m, l
  L.valid = o; o = align128(o + BK);
  L.total = o;
  return L;
}

struct Args {
  const bf16* q;
  const int8_t* k;
  const int8_t* v;
  const float* vscale;
  const uint8_t* mask;
  bf16* out;
  float* part_acc;   // (B, H, splits, Lq, D) unnormalised acc of each split
  float* part_m;     // (B, H, splits, Lq)
  float* part_l;     // (B, H, splits, Lq)
  int B, Lq, Lkv, H, D, n_splits, tiles_per_split;
  int DP;            // D padded to a multiple of 16: the tiles' width and q's row
  long long k_sb, k_sh, k_sld, v_sb, v_sh, v_sld, m_sb;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  // copies src_bytes (0..16) and zero-fills the rest of the 16
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// 16 int8 -> 16 bf16 (exact), two 16-byte stores
__device__ __forceinline__ void int8x16_to_bf16(const int4& v, bf16* dst) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
  __align__(16) __nv_bfloat162 o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __floats2bfloat162_rn((float)b[2 * e], (float)b[2 * e + 1]);
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(o)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(o)[1];
}

// acc / l, then the V channel scale: every output of K3/K4 ends here
__device__ __forceinline__ float finish(float acc, float l, float vs) {
  return acc / fmaxf(l, 1e-30f) * vs;
}

template <bool TRANS>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_q8_kernel(const Args a) {
  // K (q.k^T's matrix_b) and V (p.v's) as their tiles lie in shared memory:
  // K3 [BK][D] rows of keys, K4 [D][BK] rows of channels
  typedef typename std::conditional<TRANS, wmma::row_major, wmma::col_major>::type KLayout;
  typedef typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type VLayout;
  const int nthreads = blockDim.x;
  const int BQ = (nthreads >> 5) * 16;
  const int D = a.DP;                        // the tiles' width
  const int LDQ = D + PAD_BF16, LDS = BK + PAD_F32, LDP = BK + PAD_BF16, LDO = D + PAD_F32;
  const int LDT = TRANS ? BK + PAD_BF16 : D + PAD_BF16;
  const int split = blockIdx.x % a.n_splits;
  const int q0 = (blockIdx.x / a.n_splits) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * 16;
  const int rows = min(BQ, a.Lq - q0);      // query rows of this CTA
  const int nr = min(16, rows - row0);       // of this warp (<= 0: stage only)

  const Layout L = layout<TRANS>(BQ, D);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L.qs);
  int8_t* ring = reinterpret_cast<int8_t*>(smem + L.ring);
  bf16* kt = reinterpret_cast<bf16*>(smem + L.kt);
  bf16* vt = reinterpret_cast<bf16*>(smem + L.vt);
  float* ss = reinterpret_cast<float*>(smem + L.ss);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.ps);
  float* os = reinterpret_cast<float*>(smem + L.os);
  float* m_s = reinterpret_cast<float*>(smem + L.ml);
  float* l_s = m_s + BQ;
  uint8_t* valid_s = smem + L.valid;

  const int8_t* kb = a.k + b * a.k_sb + h * a.k_sh;
  const int8_t* vb = a.v + b * a.v_sb + h * a.v_sh;
  const uint8_t* mb = a.mask ? a.mask + b * a.m_sb : nullptr;
  const int n_tiles = (a.Lkv + BK - 1) / BK;
  const int t0 = split * a.tiles_per_split;
  const int t1 = min(t0 + a.tiles_per_split, n_tiles);
  const int tile_bytes = BK * D;

  // raw int8 K and V of tile t into ring slot t & 1; keys past Lkv are zero
  auto issue = [&](int t) {
    if (t < t1) {
      int8_t* kd = ring + (t & 1) * 2 * tile_bytes;
      int8_t* vd = kd + tile_bytes;
      const int k0 = t * BK;
      if (!TRANS) {
        const int DV = D / 16;                      // 16-byte pieces per key
        for (int i = tid; i < BK * DV; i += nthreads) {
          const int r = i / DV, c = i - r * DV;
          // bytes of this piece inside the row's true D (16 but at D's edge)
          const int n = k0 + r < a.Lkv ? min(16, a.D - c * 16) : 0;
          const long long off = n ? (long long)(k0 + r) * a.k_sld + c * 16 : 0;
          const long long voff = n ? (long long)(k0 + r) * a.v_sld + c * 16 : 0;
          cp_async16(kd + r * D + c * 16, kb + off, n);
          cp_async16(vd + r * D + c * 16, vb + voff, n);
        }
      } else {
        constexpr int LV = BK / 16;                 // 16-key pieces per channel
        for (int i = tid; i < D * LV; i += nthreads) {
          const int d = i / LV, c = i - d * LV;
          const int l0 = k0 + c * 16;
          const int n = min(16, max(0, a.Lkv - l0));
          const int l = n ? l0 : 0;
          cp_async16(kd + d * BK + c * 16, kb + (long long)d * a.k_sld + l, n);
          cp_async16(vd + d * BK + c * 16, vb + (long long)d * a.v_sld + l, n);
        }
      }
    }
    cp_async_commit();                              // an empty group past the split
  };
  // whether key tid of tile t takes part (threads tid < BK), read ahead
  auto key_valid = [&](int t) -> int {
    const int j = t * BK + tid;
    if (tid >= BK || t >= t1 || j >= a.Lkv) return 0;
    return mb == nullptr || __ldg(mb + j) != 0;
  };
  // a staged int8 tile -> bf16 in its own layout, rows padded to LDT
  auto widen = [&](const int8_t* src, bf16* dst) {
    const int len = TRANS ? BK : D;
    const int CV = len / 16;
    const int n = (TRANS ? D : BK) * CV;
    for (int i = tid; i < n; i += nthreads) {
      const int r = i / CV, c = i - r * CV;
      int8x16_to_bf16(*reinterpret_cast<const int4*>(src + r * len + c * 16),
                      dst + r * LDT + c * 16);
    }
  };

  issue(t0);
  issue(t0 + 1);
  int vcur = key_valid(t0), vnext = key_valid(t0 + 1);

  // q (B, Lq, H, DP) contiguous, pre-scaled, zero past D; rows past Lq are zero
  const int DV8 = D / 8;
  for (int i = tid; i < BQ * DV8; i += nthreads) {
    const int r = i / DV8, c = i - r * DV8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      val = *reinterpret_cast<const uint4*>(
          a.q + (((long long)b * a.Lq + q0 + r) * a.H + h) * D + c * 8);
    *reinterpret_cast<uint4*>(qs + r * LDQ + c * 8) = val;
  }
  for (int i = tid; i < BQ * LDO; i += nthreads) os[i] = 0.f;
  for (int i = tid; i < BQ * LDP; i += nthreads) ps[i] = __float2bfloat16(0.f);
  for (int i = tid; i < BQ; i += nthreads) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    cp_async_wait_one();   // tile t has landed; tile t + 1 may be in flight
    __syncthreads();       // ... for every thread; every warp is done with tile t - 1
    const int8_t* slot = ring + (t & 1) * 2 * tile_bytes;
    widen(slot, kt);
    widen(slot + tile_bytes, vt);
    if (tid < BK) valid_s[tid] = (uint8_t)vcur;
    __syncthreads();       // bf16 tiles ready; ring slot t & 1 is free
    issue(t + 2);
    vcur = vnext;
    vnext = key_valid(t + 2);
    if (nr <= 0) continue;

    // S[row0:row0+16, 0:BK] = Q K^T (this warp's rows only)
    for (int ct = 0; ct < BK / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, KLayout> fb;
        wmma::load_matrix_sync(fa, qs + row0 * LDQ + kk, LDQ);
        wmma::load_matrix_sync(fb, kt + (TRANS ? kk * LDT + ct * 16 : ct * 16 * LDT + kk), LDT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(ss + row0 * LDS + ct * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax update, one row at a time, lanes own 2 columns each
    const bool v0 = valid_s[lane] != 0, v1 = valid_s[lane + 32] != 0;
    for (int r = 0; r < nr; ++r) {
      const int row = row0 + r;
      const float s0 = v0 ? ss[row * LDS + lane] : NEG_INF;
      const float s1 = v1 ? ss[row * LDS + lane + 32] : NEG_INF;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = v0 ? __expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? __expf(s1 - m_new) : 0.f;
      ps[row * LDP + lane] = __float2bfloat16(p0);
      ps[row * LDP + lane + 32] = __float2bfloat16(p1);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = __expf(m_prev - m_new);
      for (int c = lane; c < D; c += 32) os[row * LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[row] = m_new;
        l_s[row] = alpha * l_s[row] + sum;
      }
      __syncwarp();
    }

    // O[row0:row0+16, :] += P V
    for (int ct = 0; ct < D / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + row0 * LDO + ct * 16, LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, VLayout> fb;
        wmma::load_matrix_sync(fa, ps + row0 * LDP + kk, LDP);
        wmma::load_matrix_sync(fb, vt + (TRANS ? ct * 16 * LDT + kk : kk * LDT + ct * 16), LDT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(os + row0 * LDO + ct * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();   // the initial state is visible even to a split with no tile (Lkv 0)

  if (a.n_splits == 1) {
    // one split: finalise in place; a fully masked row has l == 0 and
    // acc == 0 and returns 0
    const float* vsc = a.vscale + ((long long)b * a.H + h) * a.D;
    for (int r = 0; r < nr; ++r) {
      const int row = row0 + r;
      bf16* orow = a.out + (((long long)b * a.Lq + q0 + row) * a.H + h) * a.D;
      for (int c = lane; c < a.D; c += 32)
        orow[c] = __float2bfloat16(finish(os[row * LDO + c], l_s[row], vsc[c]));
    }
  } else {
    // this split's unnormalised acc, m and l, for the combine launch
    const long long base = (((long long)b * a.H + h) * a.n_splits + split) * a.Lq + q0;
    for (int r = 0; r < nr; ++r) {
      const int row = row0 + r;
      float* prow = a.part_acc + (base + row) * a.D;
      for (int c = lane; c < a.D; c += 32) prow[c] = os[row * LDO + c];
      if (lane == 0) {
        a.part_m[base + row] = m_s[row];
        a.part_l[base + row] = l_s[row];
      }
    }
  }
}

// One warp per (b, q, h) output row: merge the splits' partial softmax
// states in split order (the same sum every run), then write bf16; D in
// pieces of COMBINE_D columns (one piece up to D 128).
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
flash_q8_combine_kernel(const Args a) {
  const int r = blockIdx.x * COMBINE_WARPS + (threadIdx.x >> 5);
  if (r >= a.B * a.Lq * a.H) return;
  const int lane = threadIdx.x & 31;
  const int h = r % a.H, bq = r / a.H;
  const int qi = bq % a.Lq, b = bq / a.Lq;
  const int S = a.n_splits;
  const long long base = ((long long)b * a.H + h) * S * a.Lq + qi;   // split s: + s * Lq
  float m_star = NEG_INF;
  for (int s = 0; s < S; ++s) m_star = fmaxf(m_star, a.part_m[base + (long long)s * a.Lq]);
  float l_star = 0.f;
  for (int s = 0; s < S; ++s) {
    const long long i = base + (long long)s * a.Lq;
    l_star += __expf(a.part_m[i] - m_star) * a.part_l[i];
  }
  const float* vsc = a.vscale + ((long long)b * a.H + h) * a.D;
  bf16* orow = a.out + (long long)r * a.D;
  for (int c0 = 0; c0 < a.D; c0 += COMBINE_D) {
    float o[COMBINE_D / 32];
#pragma unroll
    for (int j = 0; j < COMBINE_D / 32; ++j) o[j] = 0.f;
    for (int s = 0; s < S; ++s) {
      const long long i = base + (long long)s * a.Lq;
      const float w = __expf(a.part_m[i] - m_star);
      const float* acc = a.part_acc + i * a.D + c0;
#pragma unroll
      for (int j = 0; j < COMBINE_D / 32; ++j) {
        const int c = lane + 32 * j;
        if (c0 + c < a.D) o[j] += w * acc[c];
      }
    }
#pragma unroll
    for (int j = 0; j < COMBINE_D / 32; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < a.D) orow[c] = __float2bfloat16(finish(o[j], l_star, vsc[c]));
    }
  }
}

// The warps (16 query rows each) of a CTA at Lq rows and tile width DP: one
// per 16 rows up to MAX_WARPS, at least MIN_WARPS, then as many fewer as
// the layout needs to fit `smem_max` bytes; 0 when not one warp fits.
template <bool TRANS>
int cta_warps(int Lq, int DP, int smem_max) {
  int nw = std::max(MIN_WARPS, (std::min(Lq, MAX_WARPS * 16) + 15) / 16);
  while (nw > 0 && layout<TRANS>(nw * 16, DP).total > (size_t)smem_max) --nw;
  return nw;
}

template <bool TRANS>
int launch(const Args& a, cudaStream_t stream) {
  const long long tiles = (a.Lkv + BK - 1) / BK;
  if (a.n_splits < 1 || a.tiles_per_split < 1 ||
      (long long)(a.n_splits - 1) * a.tiles_per_split >= std::max(tiles, 1LL) ||
      (long long)a.n_splits * a.tiles_per_split < tiles ||
      (a.n_splits > 1 && a.part_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  // raise the shared-memory cap once, to the most one block may take, so
  // that no later launch, inside a CUDA graph capture or not, makes an
  // attribute call
  static int smem_max = 0;
  if (smem_max == 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_q8_kernel<TRANS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    smem_max = optin;
  }
  const int nw = cta_warps<TRANS>(a.Lq, a.DP, smem_max);
  if (nw < 1) return (int)cudaErrorInvalidValue;
  const int BQ = nw * 16;
  const dim3 grid(((a.Lq + BQ - 1) / BQ) * a.n_splits, a.H, a.B);
  flash_q8_kernel<TRANS><<<grid, nw * 32, layout<TRANS>(BQ, a.DP).total, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return (int)err;
  const int out_rows = a.B * a.Lq * a.H;
  flash_q8_combine_kernel<<<(out_rows + COMBINE_WARPS - 1) / COMBINE_WARPS,
                            COMBINE_WARPS * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, Lq, H, DP) bf16 contiguous, pre-scaled, zero past D, DP = D
// rounded up to a multiple of 16; D <= 256.
// transposed == 0 (K3): k/v (B, Lkv, H, D) int8, D contiguous; strides
//   (s_b, s_h, s_l) in elements, 16-byte aligned rows (a D off 16 in
//   storage DP wide).
// transposed == 1 (K4): k/v (B, H, D, Lkv) int8, Lkv contiguous, D % 16 ==
//   0; strides (s_b, s_h, s_d), 16-byte aligned rows.
// vscale (B, H, D) float32 contiguous; mask (B, Lkv) uint8 or null; out
// (B, Lq, H, D) bf16 contiguous.  The keys are cut into n_splits splits of
// tiles_per_split 64-key tiles (the last may hold fewer; none is empty).
// n_splits > 1 needs scratch of B * H * n_splits * Lq * (D + 2) float32
// (acc, then m, then l) and launches the combine after the split kernel,
// both on ``stream``.
int flash_attention_q8(int transposed, const void* q, const void* k, const void* v,
                       const void* vscale, const void* mask, void* out, int B,
                       int Lq, int Lkv, int H, int D, long long k_sb, long long k_sh,
                       long long k_sld, long long v_sb, long long v_sh,
                       long long v_sld, long long m_sb, int n_splits,
                       int tiles_per_split, void* scratch, void* stream) {
  if (D < 1 || D > MAX_D || (transposed && D % 16)) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const bf16*)q;
  a.k = (const int8_t*)k;
  a.v = (const int8_t*)v;
  a.vscale = (const float*)vscale;
  a.mask = (const uint8_t*)mask;
  a.out = (bf16*)out;
  const long long n_part = (long long)B * H * n_splits * Lq;
  a.part_acc = (float*)scratch;
  a.part_m = scratch ? a.part_acc + n_part * D : nullptr;
  a.part_l = scratch ? a.part_m + n_part : nullptr;
  a.B = B; a.Lq = Lq; a.Lkv = Lkv; a.H = H; a.D = D;
  a.DP = (D + 15) / 16 * 16;
  a.n_splits = n_splits;
  a.tiles_per_split = tiles_per_split;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_sld = k_sld;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_sld = v_sld;
  a.m_sb = m_sb;
  cudaStream_t s = (cudaStream_t)stream;
  return transposed ? launch<true>(a, s) : launch<false>(a, s);
}

}  // extern "C"
