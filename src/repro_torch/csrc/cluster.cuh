// Helpers shared by the kernels that spread one recurrence over the CTAs
// of a thread-block cluster (decode_cluster.cuh: lstm_decode, gru_decode;
// seq_cluster.cuh: lstm_seq, gru_seq): the split of H hidden units over S
// CTAs, cp.async copies into shared memory, the split cluster barrier,
// operand loads whose type is a run-time flag, and the per-instance
// opt-ins a cluster launch needs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cluster {
// internal linkage: each library keeps its own copy
namespace {

constexpr int kMaxSplits = 16;
constexpr int kSliceCols = 64;
constexpr int kMaxH = 2048;
// the H100's shared memory a block may opt in to
constexpr int kMaxSmem = 232448;

// Slices start on multiples of this many hidden units: 8 when H % 8 == 0,
// 4 when H % 4 == 0, else 1 -- what vector loads of a slice's gate
// segments (element k * G * H + g * H + u0 of row k) need.
__host__ __device__ inline int unit_align(int H) {
  return H % 8 == 0 ? 8 : (H % 4 == 0 ? 4 : 1);
}

// S, the CTAs of one cluster, from (H, G) alone: the fewest (a power of
// two, at most 16 and at most the H / unit_align(H) aligned unit groups)
// whose widest slice holds at most kSliceCols gate columns.
__host__ __device__ inline int splits(int H, int G) {
  const int A = unit_align(H), groups = H / A;
  const int cap = groups < kMaxSplits ? groups : kMaxSplits;
  int S = 1;
  while (2 * S <= cap && G * ((groups + S - 1) / S) * A > kSliceCols) S *= 2;
  return S;
}

struct Slice {
  int u0, nu;
};

// CTA `rank` of S: the aligned unit groups [rank * n / S, (rank+1) * n / S)
__host__ __device__ inline Slice slice(int H, int S, int rank) {
  const int A = unit_align(H), n = H / A;
  const int lo = rank * n / S, hi = (rank + 1) * n / S;
  return Slice{lo * A, (hi - lo) * A};
}

template <int BYTES>
__device__ __forceinline__ void cp_async(unsigned dst, const void* gmem) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(gmem), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cluster barrier, split: arrive (release) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Element i of an fp32 (bf = 0) or bf16 (bf = 1) operand, as fp32.
__device__ __forceinline__ float load_f32(const void* p, size_t i, int bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

// Opt a cluster kernel in to the card's whole shared memory and to a
// cluster of 16 (a non-portable size).  Each instance calls it once,
// through a function-local static of its own.
template <typename K>
cudaError_t opt_in(K kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return e != cudaSuccess ? e : cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// A cluster launch's configuration, with its one attribute.
struct Config {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;

  void set(dim3 grid, int threads, size_t smem, cudaStream_t stream,
           int S) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = S;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

}  // namespace
}  // namespace cluster
