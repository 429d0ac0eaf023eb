// K2: the fused UNet-1D conditional residual block, S stacked networks.
//
// Replaces the TPU kernel vla_touch_tpu/ops/pallas_unet.py::resblock_fused
// (the pl.pallas_call at :203): per stacked network s and batch row b,
//
//   h   = Mish(GroupNorm(conv_k(x; w0) + b0))            (G groups, eps)
//   h   = scale * h + bias,  [scale|bias] = Mish(cond) @ fw + fb   (FiLM)
//   out = Mish(GroupNorm(conv_k(h; w1) + b1)) + residual(x)
//
// where residual is a 1x1 conv (wr, br) when Cin != C, else the identity.
// Weights arrive in bf16, accumulation and all normalisation are f32.
//
// What bounds it on an H100: bytes.  At batch 1 each weight is used by a
// handful of time steps (T <= 16), so the block is a streaming GEMV: the
// 68.5 M parameters of the two stacked nets are ~137 MB of bf16 per SDE
// step against ~0.3 GFLOP.  The design therefore spreads every weight
// matrix over many CTAs and reads each weight byte exactly once:
//
//   launch A  grid (C/16, S*B): conv0 for 16 output channels (+ bias) and
//             the FiLM scale/bias of the same channels, to f32 scratch;
//   launch B  grid (C/16, S*B): GroupNorm0 statistics of all channels
//             (recomputed per CTA from the small f32 scratch), Mish, FiLM,
//             then conv1 and the residual for 16 output channels;
//   launch C  grid (G, S*B):    GroupNorm1 + Mish + residual, bf16 out.
//
// Inside A and B, 256 threads split the reduction dimension (k * Cin rows)
// into 128 row slots x 2 channel halves; each thread streams 16-byte weight
// vectors (8 channels) and keeps T x 8 f32 accumulators; warp shuffles and
// a small shared-memory pass finish the sum.  GroupNorm needs statistics
// over whole groups, which is why it happens in the next launch rather
// than across CTAs.
//
// Not yet done (later work): one persistent launch per UNet pass, and
// overlapping the next block's weight stream with this block's epilogue.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;        // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int CH = 16;         // output channels per CTA in launches A and B
constexpr int RSLOTS = NT / 2; // reduction row slots (2 channel halves)
constexpr int MAXT = 16;       // longest time axis the accumulators hold

__device__ __forceinline__ float mish(float x) {
  const float sp = x > 20.f ? x : log1pf(expf(x));
  return x * tanhf(sp);
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// acc[t][j] += sum_r xs[(t + d(r)) * ldx + ci(r)] * w[r * C + cbase + j]
// over rows r = d * Cin + ci owned by this thread's slot.
__device__ __forceinline__ void conv_rows(const bf16* __restrict__ w,
                                          const float* xs, int ldx, int K,
                                          int Cin, int C, int T, int cbase,
                                          int slot, float (&acc)[MAXT][8]) {
  const int R = K * Cin;
#pragma unroll 4
  for (int r = slot; r < R; r += RSLOTS) {
    const int d = r / Cin;
    const int ci = r - d * Cin;
    const uint4 wv = __ldg(reinterpret_cast<const uint4*>(w + (size_t)r * C + cbase));
    float wf[8];
    unpack8(wv, wf);
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (t < T) {
        const float xv = xs[(t + d) * ldx + ci];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[t][j] = fmaf(xv, wf[j], acc[t][j]);
      }
    }
  }
}

// Sum acc over the 128 row slots.  Lane layout: half = lane & 1, so the
// slot partners of a lane differ in lane bits 1..4; after the shuffles
// lanes 0/1 hold the warp's sums, which meet in red[warp][t][16].
// Leaves red_out[t * CH + c] (t < T, c < 16) = total; ends synchronised.
__device__ __forceinline__ void reduce_rows(float (&acc)[MAXT][8], int T,
                                            float* red, float* red_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = lane & 1;
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    if (t < T) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float vsum = acc[t][j];
        vsum += __shfl_xor_sync(0xffffffffu, vsum, 2);
        vsum += __shfl_xor_sync(0xffffffffu, vsum, 4);
        vsum += __shfl_xor_sync(0xffffffffu, vsum, 8);
        vsum += __shfl_xor_sync(0xffffffffu, vsum, 16);
        acc[t][j] = vsum;
      }
    }
  }
  if (lane < 2) {
    // static indices keep acc in registers (a runtime-bound loop would
    // move the whole array to local memory)
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (t < T) {
#pragma unroll
        for (int j = 0; j < 8; ++j) red[(warp * MAXT + t) * CH + half * 8 + j] = acc[t][j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < T * CH; i += NT) {
    const int t = i / CH, c = i - t * CH;
    float s = 0.f;
    for (int w = 0; w < NWARP; ++w) s += red[(w * MAXT + t) * CH + c];
    red_out[i] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void zero_acc(float (&acc)[MAXT][8]) {
#pragma unroll
  for (int t = 0; t < MAXT; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[t][j] = 0.f;
}

// Block-wide sum of one float; all threads get the total.
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

// ---- launch A: conv0 + FiLM for 16 channels --------------------------------
__global__ void __launch_bounds__(NT)
resblock_conv0_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cond,
                      const bf16* __restrict__ w0, const bf16* __restrict__ b0,
                      const bf16* __restrict__ fw, const bf16* __restrict__ fb,
                      float* __restrict__ h0, float* __restrict__ film,
                      int B, int T, int Cin, int C, int G, int K) {
  const int c0 = blockIdx.x * CH;
  const int sb = blockIdx.y;            // s * B + b
  const int s = sb / B;
  const int tid = threadIdx.x;
  const int half = tid & 1, slot = tid >> 1;
  const int pad = K / 2;
  const int Tp = T + K - 1;

  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                     // [Tp][Cin], zero halo rows
  float* mc = xs + Tp * Cin;            // [G] Mish(cond)
  float* red = mc + G;                  // [NWARP][MAXT][CH]
  float* tot = red + NWARP * MAXT * CH; // [MAXT][CH]

  const bf16* xb = x + (size_t)sb * T * Cin;
  for (int i = tid; i < Tp * Cin; i += NT) {
    const int t = i / Cin - pad, ci = i % Cin;
    xs[i] = (t >= 0 && t < T) ? __bfloat162float(xb[t * Cin + ci]) : 0.f;
  }
  const bf16* cb = cond + (size_t)sb * G;
  for (int i = tid; i < G; i += NT) mc[i] = mish(__bfloat162float(cb[i]));
  __syncthreads();

  float acc[MAXT][8];
  zero_acc(acc);
  conv_rows(w0 + (size_t)s * K * Cin * C, xs, Cin, K, Cin, C, T,
            c0 + half * 8, slot, acc);
  reduce_rows(acc, T, red, tot);
  for (int i = tid; i < T * CH; i += NT) {
    const int t = i / CH, c = i - t * CH;
    h0[((size_t)sb * T + t) * C + c0 + c] =
        tot[i] + __bfloat162float(b0[(size_t)s * C + c0 + c]);
  }

  // FiLM: row g of fw (G, 2C); half 0 -> scale columns, half 1 -> bias.
  const bf16* fws = fw + (size_t)s * G * 2 * C;
  float f[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) f[j] = 0.f;
  const int col = half * C + c0;
  for (int g = slot; g < G; g += RSLOTS) {
    const uint4* p = reinterpret_cast<const uint4*>(fws + (size_t)g * 2 * C + col);
    float wf[8];
    const float mv = mc[g];
    unpack8(__ldg(p), wf);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = fmaf(mv, wf[j], f[j]);
    unpack8(__ldg(p + 1), wf);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[8 + j] = fmaf(mv, wf[j], f[8 + j]);
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    float vsum = f[j];
    vsum += __shfl_xor_sync(0xffffffffu, vsum, 2);
    vsum += __shfl_xor_sync(0xffffffffu, vsum, 4);
    vsum += __shfl_xor_sync(0xffffffffu, vsum, 8);
    vsum += __shfl_xor_sync(0xffffffffu, vsum, 16);
    f[j] = vsum;
  }
  const int lane = tid & 31, warp = tid >> 5;
  __syncthreads();                      // red is reused
  if (lane < 2) {
#pragma unroll
    for (int j = 0; j < CH; ++j) red[(warp * 2 + half) * CH + j] = f[j];
  }
  __syncthreads();
  for (int i = tid; i < 2 * CH; i += NT) {
    const int hh = i / CH, j = i - hh * CH;
    float sum = 0.f;
    for (int w = 0; w < NWARP; ++w) sum += red[(w * 2 + hh) * CH + j];
    const int cc = hh * C + c0 + j;
    film[(size_t)sb * 2 * C + cc] = sum + __bfloat162float(fb[(size_t)s * 2 * C + cc]);
  }
}

// ---- launch B: GN0 + Mish + FiLM, conv1 and residual for 16 channels -------
__global__ void __launch_bounds__(NT)
resblock_conv1_kernel(const bf16* __restrict__ x, const float* __restrict__ h0,
                      const float* __restrict__ film,
                      const bf16* __restrict__ g0w, const bf16* __restrict__ g0b,
                      const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                      const bf16* __restrict__ wr, const bf16* __restrict__ br,
                      float* __restrict__ h1, float* __restrict__ res,
                      int B, int T, int Cin, int C, int K, int n_groups, float eps) {
  const int c0 = blockIdx.x * CH;
  const int sb = blockIdx.y;
  const int s = sb / B;
  const int tid = threadIdx.x;
  const int half = tid & 1, slot = tid >> 1;
  const int lane = tid & 31, warp = tid >> 5;
  const int pad = K / 2;
  const int Tp = T + K - 1;
  const int gs = C / n_groups;

  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                      // [Tp][C]
  float* xs = hs + Tp * C;               // [T][Cin] (residual conv input)
  float* stats = xs + (wr ? T * Cin : 0); // [n_groups][2] mean, rstd
  float* red = stats + 2 * n_groups;     // [NWARP][MAXT][CH]
  float* tot = red + NWARP * MAXT * CH;  // [MAXT][CH]

  const float* hb = h0 + (size_t)sb * T * C;
  for (int i = tid; i < Tp * C; i += NT) {
    const int t = i / C - pad;
    hs[i] = (t >= 0 && t < T) ? hb[t * C + i % C] : 0.f;
  }
  if (wr) {
    const bf16* xb = x + (size_t)sb * T * Cin;
    for (int i = tid; i < T * Cin; i += NT) xs[i] = __bfloat162float(xb[i]);
  }
  __syncthreads();

  // GroupNorm0 statistics: warp w handles groups w, w + 8, ... (two-pass)
  const int n = T * gs;
  for (int g = warp; g < n_groups; g += NWARP) {
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const int t = i / gs, c = g * gs + i % gs;
      sum += hs[(t + pad) * C + c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = sum / n;
    float sq = 0.f;
    for (int i = lane; i < n; i += 32) {
      const int t = i / gs, c = g * gs + i % gs;
      const float dlt = hs[(t + pad) * C + c] - mean;
      sq += dlt * dlt;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (lane == 0) {
      stats[2 * g] = mean;
      stats[2 * g + 1] = rsqrtf(sq / n + eps);
    }
  }
  __syncthreads();
  const float* fs = film + (size_t)sb * 2 * C;
  for (int i = tid; i < T * C; i += NT) {
    const int t = i / C, c = i - t * C, g = c / gs;
    float y = (hs[(t + pad) * C + c] - stats[2 * g]) * stats[2 * g + 1];
    y = y * __bfloat162float(g0w[(size_t)s * C + c]) + __bfloat162float(g0b[(size_t)s * C + c]);
    y = mish(y);
    hs[(t + pad) * C + c] = fs[c] * y + fs[C + c];
  }
  __syncthreads();

  float acc[MAXT][8];
  zero_acc(acc);
  conv_rows(w1 + (size_t)s * K * C * C, hs, C, K, C, C, T, c0 + half * 8, slot, acc);
  reduce_rows(acc, T, red, tot);
  for (int i = tid; i < T * CH; i += NT) {
    const int t = i / CH, c = i - t * CH;
    h1[((size_t)sb * T + t) * C + c0 + c] =
        tot[i] + __bfloat162float(b1[(size_t)s * C + c0 + c]);
  }

  if (wr) {
    zero_acc(acc);
    conv_rows(wr + (size_t)s * Cin * C, xs, Cin, 1, Cin, C, T, c0 + half * 8, slot, acc);
    reduce_rows(acc, T, red, tot);
    for (int i = tid; i < T * CH; i += NT) {
      const int t = i / CH, c = i - t * CH;
      res[((size_t)sb * T + t) * C + c0 + c] =
          tot[i] + __bfloat162float(br[(size_t)s * C + c0 + c]);
    }
  } else {
    const bf16* xb = x + (size_t)sb * T * Cin;   // Cin == C
    for (int i = tid; i < T * CH; i += NT) {
      const int t = i / CH, c = i - t * CH;
      res[((size_t)sb * T + t) * C + c0 + c] = __bfloat162float(xb[t * C + c0 + c]);
    }
  }
}

// ---- launch C: GN1 + Mish + residual, one group per CTA --------------------
__global__ void __launch_bounds__(NT)
resblock_out_kernel(const float* __restrict__ h1, const float* __restrict__ res,
                    const bf16* __restrict__ g1w, const bf16* __restrict__ g1b,
                    bf16* __restrict__ out, int B, int T, int C, int n_groups,
                    float eps) {
  const int g = blockIdx.x;
  const int sb = blockIdx.y;
  const int s = sb / B;
  const int gs = C / n_groups;
  const int n = T * gs;
  __shared__ float scratch[NWARP];
  const float* hb = h1 + (size_t)sb * T * C;

  float sum = 0.f;
  for (int i = threadIdx.x; i < n; i += NT) sum += hb[(i / gs) * C + g * gs + i % gs];
  const float mean = block_sum(sum, scratch) / n;
  float sq = 0.f;
  for (int i = threadIdx.x; i < n; i += NT) {
    const float dlt = hb[(i / gs) * C + g * gs + i % gs] - mean;
    sq += dlt * dlt;
  }
  const float rstd = rsqrtf(block_sum(sq, scratch) / n + eps);
  for (int i = threadIdx.x; i < n; i += NT) {
    const int t = i / gs, c = g * gs + i % gs;
    const size_t idx = ((size_t)sb * T + t) * C + c;
    float y = (hb[t * C + c] - mean) * rstd;
    y = y * __bfloat162float(g1w[(size_t)s * C + c]) + __bfloat162float(g1b[(size_t)s * C + c]);
    out[idx] = __float2bfloat16(mish(y) + res[idx]);
  }
}

}  // namespace

extern "C" {

const char* vtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (S, B, T, Cin), cond (S, B, G), w0 (S, K, Cin, C), w1 (S, K, C, C),
// fw (S, G, 2C), wr (S, Cin, C) or null (identity residual), vectors
// (S, C) / fb (S, 2C); all bf16 contiguous.  Scratch h0/h1/res
// (S, B, T, C) and film (S, B, 2C) are f32.  out (S, B, T, C) bf16.
int resblock_bf16(const void* x, const void* cond, const void* w0,
                  const void* b0, const void* g0w, const void* g0b,
                  const void* fw, const void* fb, const void* w1,
                  const void* b1, const void* g1w, const void* g1b,
                  const void* wr, const void* br, void* h0, void* film,
                  void* h1, void* res, void* out, int S, int B, int T,
                  int Cin, int C, int G, int K, int n_groups, float eps,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int red_floats = NWARP * MAXT * CH + MAXT * CH;
  const int Tp = T + K - 1;
  const size_t smem_a = sizeof(float) * ((size_t)Tp * Cin + G + red_floats);
  const size_t smem_b = sizeof(float) * ((size_t)Tp * C + (wr ? (size_t)T * Cin : 0)
                                         + 2 * n_groups + red_floats);
  // raise the shared-memory caps once per new maximum (one card per
  // process), so that a launch inside a CUDA graph capture makes no
  // attribute call
  static size_t cap_a = 0, cap_b = 0;
  cudaError_t err;
  if (smem_a > cap_a) {
    err = cudaFuncSetAttribute(resblock_conv0_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
    if (err != cudaSuccess) return (int)err;
    cap_a = smem_a;
  }
  if (smem_b > cap_b) {
    err = cudaFuncSetAttribute(resblock_conv1_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
    if (err != cudaSuccess) return (int)err;
    cap_b = smem_b;
  }

  const dim3 grid_ab(C / CH, S * B);
  resblock_conv0_kernel<<<grid_ab, NT, smem_a, st>>>(
      (const bf16*)x, (const bf16*)cond, (const bf16*)w0, (const bf16*)b0,
      (const bf16*)fw, (const bf16*)fb, (float*)h0, (float*)film, B, T, Cin, C, G, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  resblock_conv1_kernel<<<grid_ab, NT, smem_b, st>>>(
      (const bf16*)x, (const float*)h0, (const float*)film, (const bf16*)g0w,
      (const bf16*)g0b, (const bf16*)w1, (const bf16*)b1, (const bf16*)wr,
      (const bf16*)br, (float*)h1, (float*)res, B, T, Cin, C, K, n_groups, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  resblock_out_kernel<<<dim3(n_groups, S * B), NT, 0, st>>>(
      (const float*)h1, (const float*)res, (const bf16*)g1w, (const bf16*)g1b,
      (bf16*)out, B, T, C, n_groups, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
