// The split-K skeleton shared by K6 (a8w8_matmul.cu) and K5
// (w8a16_matmul.cu): the cp.async ring's copies, the K chunks of a split,
// and the sum of a tile's splits in one thread-block cluster.
//
// A call's plan (ops/quant_matmul.py::k6_plan, k5_plan) cuts K into
// `splits` contiguous ranges of 64-wide chunks that differ by at most one
// chunk; the splits of an output tile are the CTAs of one cluster (at most
// 8, the portable limit), and CTA z finishes slice z of the tile, summing
// the splits' partials in rank order through distributed shared memory:
// K6 reads every rank's partial after a cluster barrier (rank_sum), K5's
// CTAs store theirs into the owner's receive slots before one (and after
// cluster_arrive_relaxed / cluster_wait, which see every peer started).  No global
// workspace or counter: nothing to reset between calls or CUDA-graph
// replays, and the same sum on every run.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace vtt_splitk {

constexpr int KC = 64;            // K elements per chunk
constexpr int MAX_SPLITS = 8;     // CTAs of a cluster (the portable limit)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  // copies src_bytes (0 or 16) and zero-fills the rest of the 16
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// first 64-wide K chunk of split z of nc chunks: the splits differ by at
// most one chunk (ops/quant_matmul.py::k6_split_chunks)
__device__ __forceinline__ int split_chunk(int z, int nc, int splits) {
  return (int)((long long)z * nc / splits);
}

__device__ __forceinline__ void accumulate(int& a, int b) { a += b; }
__device__ __forceinline__ void accumulate(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// The two halves of a cluster barrier, for a CTA that stores into its
// peers' shared memory: a store to a peer is safe only once the peer has
// started, which the wait after every CTA's arrive guarantees.  Arriving
// at the kernel's start and waiting just before the first remote store
// lets the barrier complete during the main loop.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// element e of the tile summed over the cluster's S partials `red`, in rank
// order (S == 1: this CTA's own); every peer's load is issued before the
// first add
template <typename T>
__device__ __forceinline__ T rank_sum(cooperative_groups::cluster_group& cluster, T* red, int e,
                                      int S) {
  if (S == 1) return red[e];
  T p[MAX_SPLITS];
#pragma unroll
  for (int q = 0; q < MAX_SPLITS; ++q) p[q] = q < S ? *cluster.map_shared_rank(red + e, q) : T{};
  T v = p[0];
#pragma unroll
  for (int q = 1; q < MAX_SPLITS; ++q)
    if (q < S) accumulate(v, p[q]);
  return v;
}

}  // namespace vtt_splitk
