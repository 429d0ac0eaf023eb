// K1: masked flash attention, bf16 in / bf16 out, f32 softmax state.
//
// Replaces the TPU kernel vla_touch_tpu/ops/pallas_attention.py::
// flash_cross_attention (the pl.pallas_call at :126): out = softmax(scale *
// q k^T, masked) v over (B, L, H, D) tensors, an online softmax over KV
// blocks with f32 running max / normaliser / accumulator, and a fully
// masked query row returning 0.
//
// What bounds it on an H100: at the serving shapes it is memory-bound.  The
// RDT image cross-attention reads K+V of 4374 tokens x 2048 channels bf16
// (35.8 MB per block) for only 67 query rows, ~0.5 operations per byte, far
// below the ~295 operations per byte at which bf16 tensor cores become the
// limit; SigLIP/DinoV2 self-attention (729-730 tokens) is closer to the
// balance point.  The design streams every K/V byte once per (b, h, q-tile)
// and keeps the scores out of device memory:
//
//   - one CTA per (q tile of 64 rows, head, batch); 4 warps, each owning 16
//     query rows end to end, so after the block-wide K/V staging no further
//     block barrier is needed inside a tile;
//   - K/V tiles of 64 keys staged in shared memory with 16-byte loads read
//     straight from the (B, L, H, D) layout through strides (no transpose);
//   - q.k^T and p.v on the tensor cores through WMMA 16x16x16 bf16 tiles
//     with f32 accumulation; D is zero-padded to a multiple of 16 in shared
//     memory, so any D <= 128 that is a multiple of 8 works (SigLIP's 72);
//   - the softmax update (scale, mask, running max, exp, normaliser) runs on
//     the CUDA cores, one warp per 16 rows, in f32; p is rounded to bf16 for
//     the p.v product, as the TPU kernel does.
//
// Not yet done (later work): split-KV for short-query/long-KV calls (the
// RDT image cross-attention launches only 2 x 32 CTAs at B = 1), wgmma and
// TMA pipelining.

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

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                 bf16* __restrict__ out, int Lq, int Lkv, int H, int D, int DP,
                 long long q_sb, long long q_sl, long long q_sh,
                 long long k_sb, long long k_sl, long long k_sh,
                 long long v_sb, long long v_sl, long long v_sh,
                 long long m_sb, float scale) {
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * 16;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);          // [BQ][DP]
  bf16* ks = qs + BQ * DP;                                // [BK][DP]
  bf16* vs = ks + BK * DP;                                // [BK][DP]
  float* ss = reinterpret_cast<float*>(vs + BK * DP);    // [BQ][BK] scores
  bf16* ps = reinterpret_cast<bf16*>(ss + BQ * BK);      // [BQ][BK] probs
  float* os = reinterpret_cast<float*>(ps + BQ * BK);    // [BQ][DP] acc
  float* m_s = os + BQ * DP;                              // [BQ] running max
  float* l_s = m_s + BQ;                                  // [BQ] normaliser
  uint8_t* valid_s = reinterpret_cast<uint8_t*>(l_s + BQ);  // [BK]

  const int DV = D / 8;     // 16-byte vectors per row
  const int DPV = DP / 8;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  const bf16* qb = q + b * q_sb + h * q_sh;
  for (int i = tid; i < BQ * DPV; i += NTHREADS) {
    const int r = i / DPV, c = i - r * DPV;
    uint4 val = zero4;
    if (q0 + r < Lq && c < DV)
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * q_sl + c * 8);
    *reinterpret_cast<uint4*>(qs + r * DP + c * 8) = val;
  }
  for (int i = tid; i < BQ * DP; i += NTHREADS) os[i] = 0.f;
  for (int i = tid; i < BQ; i += NTHREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const uint8_t* mb = mask ? mask + b * m_sb : nullptr;
  const int n_tiles = (Lkv + BK - 1) / BK;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BK * DPV; i += NTHREADS) {
      const int r = i / DPV, c = i - r * DPV;
      uint4 kv4 = zero4, vv4 = zero4;
      if (k0 + r < Lkv && c < DV) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * k_sl + c * 8);
        vv4 = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * v_sl + c * 8);
      }
      *reinterpret_cast<uint4*>(ks + r * DP + c * 8) = kv4;
      *reinterpret_cast<uint4*>(vs + r * DP + c * 8) = vv4;
    }
    for (int i = tid; i < BK; i += NTHREADS) {
      const int j = k0 + i;
      valid_s[i] = (j < Lkv) && (mb == nullptr || mb[j] != 0);
    }
    __syncthreads();

    // S[row0:row0+16, 0:BK] = Q K^T (this warp's rows only)
    for (int ct = 0; ct < BK / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, qs + row0 * DP + kk, DP);
        wmma::load_matrix_sync(bt, ks + (ct * 16) * DP + kk, DP);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(ss + row0 * BK + ct * 16, acc, BK, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax update, one row at a time, lanes own 2 columns each
    const bool v0 = valid_s[lane] != 0, v1 = valid_s[lane + 32] != 0;
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      const float s0 = v0 ? ss[row * BK + lane] * scale : NEG_INF;
      const float s1 = v1 ? ss[row * BK + lane + 32] * scale : NEG_INF;
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
      for (int c = lane; c < DP; c += 32) os[row * DP + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[row] = m_new;
        l_s[row] = alpha * l_s[row] + sum;
      }
      __syncwarp();
    }

    // O[row0:row0+16, :] += P V
    for (int ct = 0; ct < DP / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + row0 * DP + ct * 16, DP, wmma::mem_row_major);
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, ps + row0 * BK + kk, BK);
        wmma::load_matrix_sync(bv, vs + kk * DP + ct * 16, DP);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(os + row0 * DP + ct * 16, acc, DP, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // finalize: fully masked rows have l == 0 and acc == 0 and return 0
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    const int qi = q0 + row;
    if (qi >= Lq) break;
    const float inv = 1.f / fmaxf(l_s[row], 1e-30f);
    bf16* orow = out + (((long long)b * Lq + qi) * H + h) * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(os[row * DP + c] * inv);
  }
}

}  // namespace

extern "C" {

const char* vtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, Lq, H, D), k/v (B, Lkv, H, D) bf16 with unit stride on D and
// 16-byte aligned rows; mask (B, Lkv) uint8 or null; out (B, Lq, H, D)
// contiguous.  Strides are in elements.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         const void* mask, void* out, int B, int Lq, int Lkv,
                         int H, int D, long long q_sb, long long q_sl,
                         long long q_sh, long long k_sb, long long k_sl,
                         long long k_sh, long long v_sb, long long v_sl,
                         long long v_sh, long long m_sb, float scale,
                         void* stream) {
  const int DP = (D + 15) / 16 * 16;
  const size_t smem = (size_t)(BQ * DP + 2 * BK * DP) * sizeof(bf16)
                      + (size_t)BQ * BK * sizeof(float)
                      + (size_t)BQ * BK * sizeof(bf16)
                      + (size_t)BQ * DP * sizeof(float)
                      + 2 * BQ * sizeof(float) + BK;
  // raise the kernel's shared-memory cap once per new maximum (one card per
  // process), so that a launch inside a CUDA graph capture makes no
  // attribute call
  static size_t smem_cap = 0;
  if (smem > smem_cap) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_cap = smem;
  }
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const uint8_t*)mask,
      (bf16*)out, Lq, Lkv, H, D, DP, q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
      v_sb, v_sl, v_sh, m_sb, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
