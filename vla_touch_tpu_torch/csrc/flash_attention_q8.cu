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
// at finalize (:208).  A fully masked query row returns 0.
//
// What bounds it on an H100: the int8 cache stream.  At the RDT-1B image
// cross-attention one call reads K+V = 2 x 4374 x 2048 int8 = 17.9 MB for 67
// query rows (~1 operation per byte), so its bound is ~5.3 us.  The design
// is K1's (csrc/flash_attention.cu), kept simple in this first port:
//
//   - one CTA per (q tile of 64 rows, head, batch); 4 warps of 16 query rows;
//   - K/V tiles of 64 keys are read as int8 with 16-byte loads along the
//     contiguous axis of each layout (D for K3; L for K4, so K4's reads
//     coalesce along L and the cache is never transposed in device memory)
//     and converted to bf16 in shared memory, which is exact for int8;
//   - q.k^T and p.v on the tensor cores as WMMA 16x16x16 bf16 tiles with f32
//     accumulation; the online softmax in f32 on the CUDA cores; p rounded
//     to bf16 for p.v, as the TPU kernel does.
//
// Not yet done (later work, with K1): split-KV (at B = 1 the 64 CTAs leave
// half the SMs idle and each walks 69 tiles serially), cp.async/TMA
// pipelining, and keeping scores and p in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per staged tile
constexpr int NWARPS = 4;       // each warp owns 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

// 16 int8 -> 16 bf16 (exact)
__device__ __forceinline__ void int8x16_to_bf16(const int4& v, bf16* dst) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int e = 0; e < 16; e += 2)
    *reinterpret_cast<__nv_bfloat162*>(dst + e) =
        __floats2bfloat162_rn((float)b[e], (float)b[e + 1]);
}

// Stage keys [k0, k0 + BK) of one (b, h) as bf16 [BK][D] rows.
//   TRANS == false: src (Lkv, D) rows at stride s_l, D contiguous;
//   TRANS == true:  src (D, Lkv) rows at stride s_d, Lkv contiguous.
// Keys at or beyond Lkv are zero.
template <bool TRANS>
__device__ __forceinline__ void stage_int8(const int8_t* __restrict__ src, long long s_ld,
                                           int k0, int Lkv, int D, bf16* dst, int tid) {
  const int4 zero4 = make_int4(0, 0, 0, 0);
  if (!TRANS) {
    const int DV = D / 16;
    for (int i = tid; i < BK * DV; i += NTHREADS) {
      const int r = i / DV, c = i - r * DV;
      int4 v = zero4;
      if (k0 + r < Lkv)
        v = __ldg(reinterpret_cast<const int4*>(src + (long long)(k0 + r) * s_ld + c * 16));
      int8x16_to_bf16(v, dst + r * D + c * 16);
    }
  } else {
    constexpr int LV = BK / 16;   // 16-key vectors per row of the tile
    for (int i = tid; i < D * LV; i += NTHREADS) {
      const int d = i / LV, lv = i - d * LV;
      const int l0 = k0 + lv * 16;
      const int8_t* p = src + (long long)d * s_ld + l0;
      int8_t b[16];
      if (l0 + 16 <= Lkv) {
        *reinterpret_cast<int4*>(b) = __ldg(reinterpret_cast<const int4*>(p));
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) b[e] = (l0 + e < Lkv) ? p[e] : (int8_t)0;
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) dst[(lv * 16 + e) * D + d] = __float2bfloat16((float)b[e]);
    }
  }
}

template <bool TRANS>
__global__ void __launch_bounds__(NTHREADS)
flash_q8_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ k,
                const int8_t* __restrict__ v, const float* __restrict__ vscale,
                const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                int Lq, int Lkv, int H, int D,
                long long k_sb, long long k_sh, long long k_sld,
                long long v_sb, long long v_sh, long long v_sld, long long m_sb) {
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * 16;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);          // [BQ][D]
  bf16* ks = qs + BQ * D;                                 // [BK][D]
  bf16* vs = ks + BK * D;                                 // [BK][D]
  float* ss = reinterpret_cast<float*>(vs + BK * D);     // [BQ][BK] scores
  bf16* ps = reinterpret_cast<bf16*>(ss + BQ * BK);      // [BQ][BK] probs
  float* os = reinterpret_cast<float*>(ps + BQ * BK);    // [BQ][D] acc
  float* m_s = os + BQ * D;                               // [BQ] running max
  float* l_s = m_s + BQ;                                  // [BQ] normaliser
  uint8_t* valid_s = reinterpret_cast<uint8_t*>(l_s + BQ);  // [BK]

  // q (B, Lq, H, D) contiguous, pre-scaled
  const int DV8 = D / 8;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < BQ * DV8; i += NTHREADS) {
    const int r = i / DV8, c = i - r * DV8;
    uint4 val = zero4;
    if (q0 + r < Lq)
      val = *reinterpret_cast<const uint4*>(q + (((long long)b * Lq + q0 + r) * H + h) * D + c * 8);
    *reinterpret_cast<uint4*>(qs + r * D + c * 8) = val;
  }
  for (int i = tid; i < BQ * D; i += NTHREADS) os[i] = 0.f;
  for (int i = tid; i < BQ; i += NTHREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  const int8_t* kb = k + b * k_sb + h * k_sh;
  const int8_t* vb = v + b * v_sb + h * v_sh;
  const uint8_t* mb = mask ? mask + b * m_sb : nullptr;
  const int n_tiles = (Lkv + BK - 1) / BK;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_int8<TRANS>(kb, k_sld, k0, Lkv, D, ks, tid);
    stage_int8<TRANS>(vb, v_sld, k0, Lkv, D, vs, tid);
    for (int i = tid; i < BK; i += NTHREADS) {
      const int j = k0 + i;
      valid_s[i] = (j < Lkv) && (mb == nullptr || mb[j] != 0);
    }
    __syncthreads();

    // S[row0:row0+16, 0:BK] = Q K^T (this warp's rows only)
    for (int ct = 0; ct < BK / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, qs + row0 * D + kk, D);
        wmma::load_matrix_sync(bt, ks + (ct * 16) * D + kk, D);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(ss + row0 * BK + ct * 16, acc, BK, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax update, one row at a time, lanes own 2 columns each
    const bool v0 = valid_s[lane] != 0, v1 = valid_s[lane + 32] != 0;
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      const float s0 = v0 ? ss[row * BK + lane] : NEG_INF;
      const float s1 = v1 ? ss[row * BK + lane + 32] : NEG_INF;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = v0 ? __expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? __expf(s1 - m_new) : 0.f;
      ps[row * BK + lane] = __float2bfloat16(p0);
      ps[row * BK + lane + 32] = __float2bfloat16(p1);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = __expf(m_prev - m_new);
      for (int c = lane; c < D; c += 32) os[row * D + c] *= alpha;
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
      wmma::load_matrix_sync(acc, os + row0 * D + ct * 16, D, wmma::mem_row_major);
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, ps + row0 * BK + kk, BK);
        wmma::load_matrix_sync(bv, vs + kk * D + ct * 16, D);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(os + row0 * D + ct * 16, acc, D, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // finalize: acc / l, then the V channel scale; fully masked rows have
  // l == 0 and acc == 0 and return 0
  const float* vsc = vscale + ((long long)b * H + h) * D;
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    const int qi = q0 + row;
    if (qi >= Lq) break;
    const float l = fmaxf(l_s[row], 1e-30f);
    bf16* orow = out + (((long long)b * Lq + qi) * H + h) * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(os[row * D + c] / l * vsc[c]);
  }
}

template <bool TRANS>
int launch(const void* q, const void* k, const void* v, const void* vscale,
           const void* mask, void* out, int B, int Lq, int Lkv, int H, int D,
           long long k_sb, long long k_sh, long long k_sld, long long v_sb,
           long long v_sh, long long v_sld, long long m_sb, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * D + 2 * BK * D) * sizeof(bf16)
                      + (size_t)BQ * BK * sizeof(float)
                      + (size_t)BQ * BK * sizeof(bf16)
                      + (size_t)BQ * D * sizeof(float)
                      + 2 * BQ * sizeof(float) + BK;
  // raise the shared-memory cap once per new maximum (one card per
  // process), so that a launch inside a CUDA graph capture makes no
  // attribute call
  static size_t smem_cap = 0;
  if (smem > smem_cap) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_q8_kernel<TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_cap = smem;
  }
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_q8_kernel<TRANS><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const int8_t*)k, (const int8_t*)v, (const float*)vscale,
      (const uint8_t*)mask, (bf16*)out, Lq, Lkv, H, D, k_sb, k_sh, k_sld,
      v_sb, v_sh, v_sld, m_sb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, Lq, H, D) bf16 contiguous, pre-scaled; D % 16 == 0, D <= 128.
// transposed == 0 (K3): k/v (B, Lkv, H, D) int8, D contiguous; strides
//   (s_b, s_h, s_l) in elements, 16-byte aligned rows.
// transposed == 1 (K4): k/v (B, H, D, Lkv) int8, Lkv contiguous; strides
//   (s_b, s_h, s_d), 16-byte aligned rows.
// vscale (B, H, D) float32 contiguous; mask (B, Lkv) uint8 or null; out
// (B, Lq, H, D) bf16 contiguous.
int flash_attention_q8(int transposed, const void* q, const void* k, const void* v,
                       const void* vscale, const void* mask, void* out, int B,
                       int Lq, int Lkv, int H, int D, long long k_sb, long long k_sh,
                       long long k_sld, long long v_sb, long long v_sh,
                       long long v_sld, long long m_sb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (transposed)
    return launch<true>(q, k, v, vscale, mask, out, B, Lq, Lkv, H, D, k_sb, k_sh,
                        k_sld, v_sb, v_sh, v_sld, m_sb, s);
  return launch<false>(q, k, v, vscale, mask, out, B, Lq, Lkv, H, D, k_sb, k_sh,
                       k_sld, v_sb, v_sh, v_sld, m_sb, s);
}

}  // extern "C"
