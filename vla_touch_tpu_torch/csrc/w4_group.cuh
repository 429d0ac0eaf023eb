// Shared by the grouped-int4 kernels (w4a8_matmul.cu: K8, w4_swiglu.cu: K9,
// w4_postattn.cu: K10): the nibble unpacking (K8's tile body takes it too)
// and one warp's share of a grouped int4 x int8 product over 16 output
// columns (K8's warp loop, K9, K10).
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
// Each group's int32 sum is scaled by scale4 BEFORE the float32 sum across
// groups, as ops/quant.py::qdense_w4 and the JAX package do.

#pragma once

#include "int8_mma.cuh"

namespace vtt_int8 {

constexpr int W4_NT = 2;              // 8-column mma tiles per warp
constexpr int W4_BN = W4_NT * 8;      // output columns of one work item

// four packed 4-bit fields (one per byte, in bits 0..3) -> four int8
__device__ __forceinline__ int sext_nibbles(unsigned v) {
  return (int)__vsub4(v ^ 0x08080808u, 0x08080808u);
}

// four packed bytes -> their low-plane (w[n, j]) and high-plane (w[n, K/2 +
// j]) values, four int8 in the bytes' order
__device__ __forceinline__ int low_nibbles(unsigned v) {
  return sext_nibbles(v & 0x0F0F0F0Fu);
}
__device__ __forceinline__ int high_nibbles(unsigned v) {
  return sext_nibbles((v >> 4) & 0x0F0F0F0Fu);
}

// K8's tile body takes each nibble times 16, in the high half of its byte:
// the nibble's top bit lands on the byte's sign bit, so the byte is the
// int8 16 * w exactly, at one or two operations a word.  Its int32 sums are
// then 16 x the group sums, and the 1/16 is applied once at the end, exactly.
__device__ __forceinline__ int low_nibbles_x16(unsigned v) {
  return (int)((v << 4) & 0xF0F0F0F0u);
}
__device__ __forceinline__ int high_nibbles_x16(unsigned v) {
  return (int)(v & 0xF0F0F0F0u);
}

__device__ __forceinline__ int4 low_plane(const int4& p) {
  return make_int4(low_nibbles(p.x), low_nibbles(p.y), low_nibbles(p.z), low_nibbles(p.w));
}

__device__ __forceinline__ int4 high_plane(const int4& p) {
  return make_int4(high_nibbles(p.x), high_nibbles(p.y), high_nibbles(p.z), high_nibbles(p.w));
}

// Loads of 16 int8 activation codes.  Codes written by an earlier launch go
// through the read-only cache; codes that other blocks of the same launch
// wrote before a grid barrier are read from L2 (ld.global.cg), never from a
// stale L1 or read-only line; codes in this block's shared memory need a
// row stride that is a multiple of 16 bytes.
struct GlobalCodes {
  static __device__ __forceinline__ int4 load(const int8_t* p) { return ld128(p); }
};
struct L2Codes {
  static __device__ __forceinline__ int4 load(const int8_t* p) {
    return __ldcg(reinterpret_cast<const int4*>(p));
  }
};
struct SharedCodes {
  static __device__ __forceinline__ int4 load(const int8_t* p) {
    return *reinterpret_cast<const int4*>(p);
  }
};

// One warp's share of y[m, n] = sum_g scale4[g, n] * (sum_{k in g} x_i8[m, k] w[n, k])
// for rows m0 + [0, MT*16) over NS column sets (columns n0[h] + [0,
// W4_BN)) at once: the units u = u0, u0 + du, ... < u1, folded into
// accf[h] (the mma accumulator layout: tile (i, j), register r holds row
// i*16 + lane/4 + (r/2)*8, column j*8 + (lane%4)*2 + r%2).  The sets share
// each chunk's activation codes, and every set's weight loads of a chunk
// are in flight together (K9's gate|up runs its gate and up tiles as two
// sets); a unit's scale4 values go out with its first weights.  x_i8 (M,
// K) has row stride ldx bytes (rows >= M give 0) and is read through
// Codes::load; N is the weight's row count (columns past N give 0).
template <int MT, int NS, typename Codes>
__device__ __forceinline__ void w4_warp_units(float (&accf)[NS][MT][W4_NT][4],
                                              const int8_t* __restrict__ xq, int ldx, int M,
                                              const int8_t* __restrict__ wp,
                                              const float* __restrict__ scale4, int N, int K,
                                              int G, const int (&n0)[NS], int m0, int u0,
                                              int u1, int du) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int KH = K / 2;
  const int gs = K / G;
  const int HG = G / 2;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int u = u0; u < u1; u += du) {
    int acc_lo[NS][MT][W4_NT][4], acc_hi[NS][MT][W4_NT][4];
#pragma unroll
    for (int h = 0; h < NS; ++h)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < W4_NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc_lo[h][i][j][r] = acc_hi[h][i][j][r] = 0;
    float s_lo[NS][W4_NT][2], s_hi[NS][W4_NT][2];
#pragma unroll
    for (int h = 0; h < NS; ++h)
#pragma unroll
      for (int j = 0; j < W4_NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0[h] + j * 8 + t * 2 + e;
          s_lo[h][j][e] = n < N ? __ldg(scale4 + (long long)u * N + n) : 0.f;
          s_hi[h][j][e] = n < N ? __ldg(scale4 + (long long)(u + HG) * N + n) : 0.f;
        }
    for (int c = 0; c < gs; c += 64) {
      const bool kin = c + t * 16 < gs;   // gs % 32 == 0: whole 16 bytes or none
      const int k = u * gs + c + t * 16;  // low-plane K index = packed byte index
      int4 p[NS][W4_NT];
#pragma unroll
      for (int h = 0; h < NS; ++h)
#pragma unroll
        for (int j = 0; j < W4_NT; ++j) {
          const int n = n0[h] + j * 8 + g;
          p[h][j] = (kin && n < N) ? ld128(wp + (long long)n * KH + k) : zero;
        }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r0 = m0 + i * 16 + g, r1 = r0 + 8;
        const bool in0 = kin && r0 < M, in1 = kin && r1 < M;
        const int8_t* x0 = xq + (long long)r0 * ldx + k;
        const int8_t* x1 = xq + (long long)r1 * ldx + k;
        const int4 a_lo = in0 ? Codes::load(x0) : zero, a_hi = in1 ? Codes::load(x1) : zero;
        const int4 b_lo = in0 ? Codes::load(x0 + KH) : zero;
        const int4 b_hi = in1 ? Codes::load(x1 + KH) : zero;
#pragma unroll
        for (int h = 0; h < NS; ++h)
#pragma unroll
          for (int j = 0; j < W4_NT; ++j) {
            mma_chunk64(acc_lo[h][i][j], a_lo, a_hi, low_plane(p[h][j]));
            mma_chunk64(acc_hi[h][i][j], b_lo, b_hi, high_plane(p[h][j]));
          }
      }
    }
    // fold the unit's two groups into the float32 sums
#pragma unroll
    for (int h = 0; h < NS; ++h)
#pragma unroll
      for (int j = 0; j < W4_NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float& acc = accf[h][i][j][hh * 2 + e];
              acc = __fadd_rn(acc, __fmul_rn((float)acc_lo[h][i][j][hh * 2 + e], s_lo[h][j][e]));
              acc = __fadd_rn(acc, __fmul_rn((float)acc_hi[h][i][j][hh * 2 + e], s_hi[h][j][e]));
            }
  }
}

// Each warp's partial sums into red[warp][row][col] (MT*16 rows, W4_BN
// columns), for a fixed-order sum across warps after a __syncthreads.
template <int MT>
__device__ __forceinline__ void w4_store_partials(float* red, const float (&accf)[MT][W4_NT][4],
                                                  int warp) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < W4_NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        red[(warp * MT * 16 + i * 16 + g + (r >> 1) * 8) * W4_BN + j * 8 + t * 2 + (r & 1)] =
            accf[i][j][r];
}

template <int MT>
__device__ __forceinline__ float w4_sum_partials(const float* red, int nwarps, int row, int col) {
  float s = red[row * W4_BN + col];
  for (int w = 1; w < nwarps; ++w) s = __fadd_rn(s, red[(w * MT * 16 + row) * W4_BN + col]);
  return s;
}

}  // namespace vtt_int8
