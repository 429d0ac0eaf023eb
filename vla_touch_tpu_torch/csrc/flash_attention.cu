// K1: masked flash attention, bf16 in / bf16 out, f32 softmax state.
//
// Replaces the TPU kernel vla_touch_tpu/ops/pallas_attention.py::
// flash_cross_attention (def :86, pl.pallas_call :126, body :35-83): out =
// softmax(scale * q k^T, masked) v over (B, L, H, D) tensors, an online
// softmax over KV blocks with f32 running max / normaliser / accumulator, p
// rounded to bf16 for p.v, and a fully masked query row returning 0.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): the
// bytes.  The RDT image cross-attention reads K+V of 4374 tokens x 2048
// channels bf16 (35.8 MB) for only 67 query rows, ~0.5 operations per byte:
// its bound is 10.9 us of bytes against 0.8 us of operations.  SigLIP's
// self-attention (6 x 729 tokens, 16 heads, D 72) moves 40 MB for 14.7
// GFLOP, at the balance point (12.0 us of bytes, 14.9 us of operations at
// the wgmma peak).  So the design keeps every CTA streaming and spends no
// time between a tile's arrival and its use:
//
//   - split-KV.  Short-query calls (Lq <= 128: the RDT attentions) get one
//     CTA per (KV split, head, batch) covering every query row in warps of
//     16 rows; long-query calls keep 128-row q tiles.  The split count
//     (ops/flash_attention.py::split_plan, shared with K3/K4) fills one
//     wave of the CTAs the card holds at once (CUDA's occupancy calculator,
//     flash_attention_resident), at least 4 tiles per split: 12 splits of 6
//     tiles at the image call (3 CTAs per SM), 3 of 4 at DinoV2, one at
//     SigLIP and at CLIP.
//     Each split writes its unnormalised float32 acc and its m and l per row
//     (log2 domain) to scratch the wrapper allocates; a second launch
//     (flash_combine_kernel) merges them in split order, m* = max m_s, l* =
//     sum 2^(m_s - m*) l_s, so every run gives the same sum.  A split whose
//     keys are all masked carries m = -1e30 and l = 0 and adds nothing; one
//     split finalises in place.
//   - a ring of STAGES slots of 64-key K and V tiles, filled by 16-byte
//     cp.async.cg through the strides given (q, k, v are strided views of
//     the fused projections); the ragged edge and D's padding to a multiple
//     of 16 are zero-filled through cp.async's source size.  Tiles t + 1 and
//     t + 2 are in flight while tile t computes; one block barrier per tile.
//     The mask bytes of a tile are read into registers when it is issued.
//   - the scores, p and the output accumulator stay in registers:
//     mma.sync m16n8k16 bf16 -> f32 fed by ldmatrix (.trans for V), q's
//     fragments loaded once per CTA, each warp's 16 x 64 score tile as 8
//     accumulator fragments whose row max and sum need two shfl_xor within a
//     quad, p packed to bf16 straight from the accumulator into the A
//     operand of p.v (the accumulator-to-A layout identity of m16n8k16), and
//     D/8 output fragments for the whole KV loop.  Shared-memory rows are
//     padded by 16 bytes, so ldmatrix has no bank conflicts; D is padded to
//     a multiple of 16 (72 -> 80) for the depth of q.k^T.
//
// Not done (later work, if the measured times call for them): wgmma and
// TMA.  Both calls are bound by bytes or at the balance point, where
// mma.sync's rate is not the limit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BK = 64;            // keys per tile
constexpr int STAGES = 3;         // ring slots of K and V tiles
constexpr int MAX_WARPS = 8;      // 16 query rows each: up to 128 rows per CTA
constexpr int MIN_WARPS = 4;
constexpr int MAX_DP = 128;
constexpr int PAD = 8;            // row padding of shared tiles, bf16 (16 bytes)
constexpr int COMBINE_WARPS = 8;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* mask;
  bf16* out;
  float* part_acc;   // (B, H, splits, Lq, D) unnormalised acc of each split
  float* part_m;     // (B, H, splits, Lq), log2 domain
  float* part_l;     // (B, H, splits, Lq)
  int B, Lq, Lkv, H, D, rows, n_splits, tiles_per_split;
  long long q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, m_sb;
  float scale_log2;  // softmax scale x log2(e): scores in the log2 domain
};

__host__ __device__ inline size_t smem_bytes(int rows, int DP) {
  return (size_t)(rows + 2 * STAGES * BK) * (DP + PAD) * sizeof(bf16) + STAGES * BK;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  // copies src_bytes (0 or 16) and zero-fills the rest of the 16
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// One CTA: query rows [q0, q0 + rows) of (b, h), keys of split `split`.
// Warp w owns rows 16w .. 16w + 15; in every m16n8 fragment lane l holds rows
// g = l / 4 and g + 8, columns 2 (l % 4) and 2 (l % 4) + 1.
template <int DP>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_fwd_kernel(const Args a) {
  constexpr int LD = DP + PAD;      // shared row stride, bf16
  constexpr int KT = DP / 16;       // depth steps of q.k^T
  constexpr int NO = DP / 8;        // n8 fragments of the output
  constexpr int CV = DP / 8;        // 16-byte pieces per staged row
  const int nthreads = blockDim.x;
  const int BQ = a.rows;
  const int split = blockIdx.x % a.n_splits;
  const int q0 = (blockIdx.x / a.n_splits) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * 16;
  const int rows = min(BQ, a.Lq - q0);
  const bool active = row0 < rows;  // a warp past Lq only stages tiles
  const int DV = a.D / 8;           // pieces that hold data

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);                            // [BQ][LD]
  bf16* ring = qs + BQ * LD;                                           // [STAGES][K|V][BK][LD]
  uint8_t* valid_s = reinterpret_cast<uint8_t*>(ring + STAGES * 2 * BK * LD);  // [STAGES][BK]

  const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* kb = a.k + b * a.k_sb + h * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + h * a.v_sh;
  const uint8_t* mb = a.mask ? a.mask + b * a.m_sb : nullptr;
  const int n_tiles = (a.Lkv + BK - 1) / BK;
  const int t0 = split * a.tiles_per_split;
  const int t1 = min(t0 + a.tiles_per_split, n_tiles);

  // K and V of tile t into ring slot (t - t0) % STAGES; keys past Lkv and
  // channels past D are zero
  auto issue = [&](int t) {
    if (t < t1) {
      bf16* kd = ring + ((t - t0) % STAGES) * 2 * BK * LD;
      bf16* vd = kd + BK * LD;
      const int k0 = t * BK;
      for (int i = tid; i < BK * CV; i += nthreads) {
        const int r = i / CV, c = i - r * CV;
        const bool in = k0 + r < a.Lkv && c < DV;
        const long long ko = in ? (long long)(k0 + r) * a.k_sl + c * 8 : 0;
        const long long vo = in ? (long long)(k0 + r) * a.v_sl + c * 8 : 0;
        cp_async16(kd + r * LD + c * 8, kb + ko, in ? 16 : 0);
        cp_async16(vd + r * LD + c * 8, vb + vo, in ? 16 : 0);
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

  // q rows past Lq and channels past D are zero
  for (int i = tid; i < BQ * CV; i += nthreads) {
    const int r = i / CV, c = i - r * CV;
    const bool in = r < rows && c < DV;
    cp_async16(qs + r * LD + c * 8, qb + (in ? (long long)(q0 + r) * a.q_sl + c * 8 : 0),
               in ? 16 : 0);
  }
  cp_async_commit();
  int vq[STAGES - 1];
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    issue(t0 + i);
    vq[i] = key_valid(t0 + i);
  }
  cp_async_wait<STAGES - 1>();   // q has landed
  __syncthreads();

  unsigned qf[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    ldsm_x4(qf[kt], qs + (row0 + (lane & 15)) * LD + kt * 16 + (lane >> 4) * 8);

  const int c2 = (lane & 3) * 2;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};   // running max of rows g, g + 8 (log2 domain)
  float l_r[2] = {0.f, 0.f};           // this lane's share of their running sums

  for (int t = t0; t < t1; ++t) {
    const int slot = (t - t0) % STAGES;
    if (tid < BK) valid_s[slot * BK + tid] = (uint8_t)vq[0];
#pragma unroll
    for (int i = 0; i < STAGES - 2; ++i) vq[i] = vq[i + 1];
    cp_async_wait<STAGES - 2>();   // tile t has landed; later tiles may be in flight
    __syncthreads();               // ... for every thread; every warp is done with tile t - 1
    issue(t + STAGES - 1);         // into the slot of tile t - 1
    vq[STAGES - 2] = key_valid(t + STAGES - 1);
    if (!active) continue;
    const bf16* ks = ring + slot * 2 * BK * LD;
    const bf16* vs = ks + BK * LD;
    const uint8_t* vt = valid_s + slot * BK;

    // S (16 x 64) = q k^T: key fragments 2jp and 2jp + 1 per ldmatrix.x4
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned r[4];
        ldsm_x4(r, ks + (jp * 16 + ((lane >> 4) << 3) + (lane & 7)) * LD + kt * 16 +
                       ((lane >> 3) & 1) * 8);
        mma16816(s[2 * jp], qf[kt], r[0], r[1]);
        mma16816(s[2 * jp + 1], qf[kt], r[2], r[3]);
      }
    }

    // online softmax in the log2 domain; masked keys give p = 0
    unsigned vbits = 0;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool v0 = vt[j * 8 + c2] != 0, v1 = vt[j * 8 + c2 + 1] != 0;
      vbits |= ((unsigned)v0 | ((unsigned)v1 << 1)) << (2 * j);
      s[j][0] = v0 ? s[j][0] * a.scale_log2 : NEG_INF;
      s[j][1] = v1 ? s[j][1] * a.scale_log2 : NEG_INF;
      s[j][2] = v0 ? s[j][2] * a.scale_log2 : NEG_INF;
      s[j][3] = v1 ? s[j][3] * a.scale_log2 : NEG_INF;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m_r[0], mx0), mn1 = fmaxf(m_r[1], mx1);
    const float al0 = exp2f(m_r[0] - mn0), al1 = exp2f(m_r[1] - mn1);
    m_r[0] = mn0;
    m_r[1] = mn1;
    l_r[0] *= al0;
    l_r[1] *= al1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
    // p as the A operand of p.v: key step kk takes score fragments 2kk, 2kk + 1
    unsigned pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool v0 = (vbits >> (2 * j)) & 1u, v1 = (vbits >> (2 * j + 1)) & 1u;
      const float p0 = v0 ? exp2f(s[j][0] - mn0) : 0.f;
      const float p1 = v1 ? exp2f(s[j][1] - mn0) : 0.f;
      const float p2 = v0 ? exp2f(s[j][2] - mn1) : 0.f;
      const float p3 = v1 ? exp2f(s[j][3] - mn1) : 0.f;
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O (16 x DP) += p v: output fragments 2np and 2np + 1 per ldmatrix.x4.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        unsigned r[4];
        ldsm_x4_trans(r, vs + (kk * 16 + (((lane >> 3) & 1) << 3) + (lane & 7)) * LD +
                             np * 16 + ((lane >> 4) << 3));
        mma16816(o[2 * np], pf[kk], r[0], r[1]);
        mma16816(o[2 * np + 1], pf[kk], r[2], r[3]);
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_r[0] += __shfl_xor_sync(0xffffffffu, l_r[0], off);
    l_r[1] += __shfl_xor_sync(0xffffffffu, l_r[1], off);
  }
  const int g = lane >> 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + row0 + g + 8 * half;
    if (qi >= a.Lq) continue;
    if (a.n_splits == 1) {
      // one split: finalise in place; a fully masked row has l == 0 and
      // acc == 0 and returns 0
      const float inv = 1.f / fmaxf(l_r[half], 1e-30f);
      bf16* orow = a.out + (((long long)b * a.Lq + qi) * a.H + h) * a.D;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = n * 8 + c2;
        if (col < a.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
      }
    } else {
      // this split's unnormalised acc, m and l, for the combine launch
      const long long i = (((long long)b * a.H + h) * a.n_splits + split) * a.Lq + qi;
      float* prow = a.part_acc + i * a.D;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = n * 8 + c2;
        if (col < a.D)
          *reinterpret_cast<float2*>(prow + col) = make_float2(o[n][2 * half], o[n][2 * half + 1]);
      }
      if (c2 == 0) {
        a.part_m[i] = m_r[half];
        a.part_l[i] = l_r[half];
      }
    }
  }
}

// One warp per (b, q, h) output row: merge the splits' partial softmax
// states in split order (the same sum every run), then write bf16.
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
flash_combine_kernel(const Args a) {
  const int r = blockIdx.x * COMBINE_WARPS + (threadIdx.x >> 5);
  if (r >= a.B * a.Lq * a.H) return;
  const int lane = threadIdx.x & 31;
  const int h = r % a.H, bq = r / a.H;
  const int qi = bq % a.Lq, b = bq / a.Lq;
  const int S = a.n_splits;
  const int n_used = S;
  const long long base = ((long long)b * a.H + h) * S * a.Lq + qi;   // split s: + s * Lq
  float m_star = NEG_INF;
  for (int s = 0; s < n_used; ++s) m_star = fmaxf(m_star, a.part_m[base + (long long)s * a.Lq]);
  float l_star = 0.f;
  float o[MAX_DP / 32];
#pragma unroll
  for (int j = 0; j < MAX_DP / 32; ++j) o[j] = 0.f;
  for (int s = 0; s < n_used; ++s) {
    const long long i = base + (long long)s * a.Lq;
    const float w = exp2f(a.part_m[i] - m_star);
    l_star += w * a.part_l[i];
    const float* acc = a.part_acc + i * a.D;
#pragma unroll
    for (int j = 0; j < MAX_DP / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < a.D) o[j] += w * acc[c];
    }
  }
  const float inv = 1.f / fmaxf(l_star, 1e-30f);
  bf16* orow = a.out + (long long)r * a.D;
#pragma unroll
  for (int j = 0; j < MAX_DP / 32; ++j) {
    const int c = lane + 32 * j;
    if (c < a.D) orow[c] = __float2bfloat16(o[j] * inv);
  }
}

// Raise the shared-memory cap once, to the most any call of this depth
// needs (128 rows), so that no later launch, inside a CUDA graph capture or
// not, makes an attribute call.
template <int DP>
cudaError_t raise_cap() {
  static bool cap_raised = false;
  if (!cap_raised) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes(MAX_WARPS * 16, DP));
    if (err != cudaSuccess) return err;
    cap_raised = true;
  }
  return cudaSuccess;
}

template <int DP>
int resident(int rows, int* n) {
  cudaError_t err = raise_cap<DP>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, flash_fwd_kernel<DP>, rows * 2,
                                                        smem_bytes(rows, DP));
  return (int)err;
}

template <int DP>
int launch(const Args& a, cudaStream_t stream) {
  cudaError_t cap = raise_cap<DP>();
  if (cap != cudaSuccess) return (int)cap;
  const dim3 grid(((a.Lq + a.rows - 1) / a.rows) * a.n_splits, a.H, a.B);
  flash_fwd_kernel<DP><<<grid, a.rows * 2, smem_bytes(a.rows, DP), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return (int)err;
  const int out_rows = a.B * a.Lq * a.H;
  flash_combine_kernel<<<(out_rows + COMBINE_WARPS - 1) / COMBINE_WARPS, COMBINE_WARPS * 32,
                         0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// *n = the CTAs of `rows` query rows (a multiple of 16, 64..128) at head
// dim D one SM holds at once: the split plan fills one wave of them.
int flash_attention_resident(int D, int rows, int* n) {
  if (D % 8 || D < 8 || D > MAX_DP || rows % 16 || rows < MIN_WARPS * 16 ||
      rows > MAX_WARPS * 16)
    return (int)cudaErrorInvalidValue;
  switch ((D + 15) / 16 * 16) {
    case 16: return resident<16>(rows, n);
    case 32: return resident<32>(rows, n);
    case 48: return resident<48>(rows, n);
    case 64: return resident<64>(rows, n);
    case 80: return resident<80>(rows, n);
    case 96: return resident<96>(rows, n);
    case 112: return resident<112>(rows, n);
    default: return resident<128>(rows, n);
  }
}

// q (B, Lq, H, D), k/v (B, Lkv, H, D) bf16 with unit stride on D and
// strides that are multiples of 8 elements (16-byte aligned rows); mask
// (B, Lkv) uint8 or null; out (B, Lq, H, D) contiguous.  Strides are in
// elements.  D % 8 == 0, D <= 128.  `rows` query rows per CTA (a multiple
// of 16, 64..128); the keys are cut into n_splits splits of
// tiles_per_split 64-key tiles (the last may hold fewer; none is empty).
// n_splits > 1 needs scratch of B * H * n_splits * Lq * (D + 2) float32
// (acc, then m, then l) and launches the combine after the split kernel,
// both on `stream`.
int flash_attention_bf16(const void* q, const void* k, const void* v, const void* mask,
                         void* out, int B, int Lq, int Lkv, int H, int D, long long q_sb,
                         long long q_sl, long long q_sh, long long k_sb, long long k_sl,
                         long long k_sh, long long v_sb, long long v_sl, long long v_sh,
                         long long m_sb, float scale, int rows, int n_splits,
                         int tiles_per_split, void* scratch, void* stream) {
  const long long tiles = (Lkv + BK - 1) / BK;
  if (D % 8 || D < 8 || D > MAX_DP || rows % 16 || rows < MIN_WARPS * 16 ||
      rows > MAX_WARPS * 16 || n_splits < 1 || tiles_per_split < 1 ||
      (long long)(n_splits - 1) * tiles_per_split >= std::max(tiles, 1LL) ||
      (long long)n_splits * tiles_per_split < tiles || (n_splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.mask = (const uint8_t*)mask;
  a.out = (bf16*)out;
  const long long n_part = (long long)B * H * n_splits * Lq;
  a.part_acc = (float*)scratch;
  a.part_m = scratch ? a.part_acc + n_part * D : nullptr;
  a.part_l = scratch ? a.part_m + n_part : nullptr;
  a.B = B; a.Lq = Lq; a.Lkv = Lkv; a.H = H; a.D = D;
  a.rows = rows;
  a.n_splits = n_splits;
  a.tiles_per_split = tiles_per_split;
  a.q_sb = q_sb; a.q_sl = q_sl; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_sl = k_sl; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_sl = v_sl; a.v_sh = v_sh;
  a.m_sb = m_sb;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 15) / 16 * 16) {
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 48: return launch<48>(a, s);
    case 64: return launch<64>(a, s);
    case 80: return launch<80>(a, s);
    case 96: return launch<96>(a, s);
    case 112: return launch<112>(a, s);
    default: return launch<128>(a, s);
  }
}

}  // extern "C"
