// mvm_tile: y = x . W (+ b) with fp32 accumulation, output in x's dtype --
// the GEMV engine of the transformer's decode-step projections.
//
// Replaces the TPU kernel mvm_pallas / _kernel
// (src/repro/kernels/mvm_tile/kernel.py:49 / :25).  Same function: x (B, X),
// W (X, N), optional bias b (N,); every product and the bias add in fp32,
// one rounding to x's dtype at the end.  The Pallas grid is (j over N
// stripes, k over X stripes) with an fp32 accumulator tile carried across
// k in VMEM and masked X / N edges (kernel.py:34-38); its block shape is a
// planning parameter that changes no number.
//
// What bounds it on an H100: bytes.  At decode B <= 4, so each W element
// is used for at most 4 multiply-adds: reading W once is the least time,
// 39.3 MB for a 2560 x 7680 bf16 W, 0.0117 ms at 3.35 TB/s; the decode
// step's 156 projections read 4.0 GB, 1.20 ms.
//
// The design: a thread-block cluster per output stripe.
//  - The grid is (S splits of X) x (stripes of kCols = 64 output columns)
//    x (groups of <= 4 batch rows); the S CTAs of one stripe form one
//    cluster (cudaLaunchKernelEx with a cluster dimension of S along x).
//    S is chosen by the host from (X, N) only (kernels/mvm_tile/ops.py:
//    the largest S whose grid fits in one wave of the 4-row instance, 3
//    CTAs per SM); S = 16 is a non-portable cluster size, opted in per
//    instance.
//  - CTA `split` sums its own X-slice, rows [split * slice, (split + 1) *
//    slice), for all of its batch rows in fp32.  Its 256 threads split the
//    slice: a thread holds VEC adjacent columns (VEC = 8 bf16 or 4 fp32
//    values, one 16-byte load per W row; VEC = 1 when N is not a multiple
//    of that) and walks the rows k = kg, kg + KG, ... of the slice, where
//    KG = 256 / (kCols / VEC) thread groups share the stripe; neighbouring
//    threads read neighbouring columns of one W row, so a warp reads whole
//    128-byte lines.  Each thread streams its W vectors through its own
//    ring of kStages x kRows 16-byte slots in shared memory (cp.async,
//    kStages - 1 stages = 6 loads in flight per thread, 24 KB per CTA,
//    with no registers held for them); a thread reads only the slots it
//    filled, so the ring needs no barrier.  The first stages go out
//    before x is staged.  x is staged in shared memory in fp32, only the
//    CTA's own slice, kChunk rows at a time, and masked at the X edge.
//  - The KG partial sums of each output are added in a fixed order:
//    within a warp by a shuffle tree, then the warps in order, into the
//    CTA's partial stripe in shared memory.  After cluster.sync() the CTAs
//    split the stripe's columns among themselves; each adds the S partials
//    of its columns in rank order 0 .. S-1, read through distributed shared
//    memory (cluster.map_shared_rank), then the bias in fp32, and rounds
//    once.  A last cluster.sync() keeps every CTA's shared memory alive
//    until it has been read.  No atomics and no second launch.
//  - Every output's order of summation depends on (X, N) only, never on B
//    or on the run: two runs are bit-equal, and a row of a B = 4 call
//    equals the same row at B = 1 bit for bit.  X < S leaves some CTAs
//    with empty slices; they contribute zeros.  B > 4 takes more row
//    groups (gridDim.z), each reading W again.
//
// What it reaches (PERF.md, row 7; the decode step's 156 projections in
// one CUDA graph): 1.07x torch.matmul and 1.60x the bytes bound at B = 1,
// 1.33x and 2.08x at B = 4.  A launch this small pays a few microseconds
// for the ramp-up of its first loads and for the cluster's epilogue; at
// B = 4 the fourfold FMA work is not hidden under the stream.

#include <cooperative_groups.h>

#include "rnn_common.cuh"

namespace cg = cooperative_groups;

namespace mvm {
// internal linkage: the function-local statics below (the per-instance
// opt-ins) stay this library's own
namespace {

using namespace rnn;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 64;     // output columns per stripe (and cluster)
constexpr int kChunk = 2048;  // rows of the X-slice staged at once
constexpr int kStages = 4;    // a thread's ring of W loads: stages ...
constexpr int kRows = 2;      // ... of this many W rows each
constexpr int kMaxSplits = 16;
// the W ring in dynamic shared memory: one 16-byte slot per (stage, row,
// thread); a thread reads only the slots it filled itself
constexpr size_t kRingBytes = sizeof(uint4) * kStages * kRows * kThreads;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A thread's 16-byte W vector as fp32: 8 bf16 or 4 fp32 values.
template <typename WT>
__device__ __forceinline__ void unpack(const uint4& v, float* out) {
  if constexpr (sizeof(WT) == 2) {
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
}

template <typename XT, typename WT, int VEC, int RB>
__global__ void __launch_bounds__(kThreads)
mvm_kernel(const XT* __restrict__ x, const WT* __restrict__ W,
           const float* __restrict__ bias, XT* __restrict__ y, int B, int X,
           int N, int slice) {
  constexpr int TPR = kCols / VEC;        // threads across the stripe
  constexpr int KG = kThreads / TPR;      // thread groups along X
  extern __shared__ uint4 ring[];         // [kStages][kRows][kThreads]
  __shared__ float x_s[RB][kChunk];
  __shared__ float warp_s[kWarps][RB][kCols];
  __shared__ float part_s[RB][kCols];     // read by the whole cluster

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.y * kCols;
  const int b0 = blockIdx.z * RB;
  const int nrows = min(RB, B - b0);
  const int lane_c = threadIdx.x % TPR;   // which VEC columns of the stripe
  const int kg = threadIdx.x / TPR;       // which rows of the slice
  const int col = n0 + lane_c * VEC;
  // a vector lies wholly inside or wholly outside N (N % VEC == 0 for
  // VEC > 1); the scalar instance masks column by column
  const bool live = col < N;
  const int k_lo = min(X, split * slice);
  const int k_hi = min(X, k_lo + slice);

  float acc[RB][VEC];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;

  for (int c0 = k_lo; c0 < k_hi; c0 += kChunk) {
    const int kn = min(kChunk, k_hi - c0);
    const WT* w = W + (size_t)c0 * N + col;
    // this thread walks the chunk's rows kg + j * KG, j < J, in order;
    // stage t of its ring holds j in [t * kRows, (t + 1) * kRows)
    const int J = (live && kg < kn) ? (kn - kg + KG - 1) / KG : 0;
    auto issue = [&](int t) {
      if constexpr (VEC > 1) {
        uint4* slot = ring + (t % kStages) * kRows * kThreads + threadIdx.x;
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int j = t * kRows + u;
          if (j < J)
            cp_async16(slot + u * kThreads, w + (size_t)(kg + j * KG) * N);
        }
        cp_async_commit();  // an empty group past the end keeps the count
      }
    };
    auto consume = [&](int t) {
      if constexpr (VEC > 1) {
        const uint4* slot =
            ring + (t % kStages) * kRows * kThreads + threadIdx.x;
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int j = t * kRows + u;
          if (j >= J) break;
          float wk[VEC];
          unpack<WT>(slot[u * kThreads], wk);
          const int k = kg + j * KG;
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float xk = x_s[r][k];
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[r][e] = fmaf(xk, wk[e], acc[r][e]);
          }
        }
      }
    };
    // the ring's first stages go out before x is staged
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) issue(t);
    __syncthreads();  // the previous chunk's x_s is no longer read
#pragma unroll
    for (int r = 0; r < RB; ++r)
      for (int k = threadIdx.x; k < kn; k += kThreads)
        x_s[r][k] = r < nrows ? to_f32(x[(size_t)(b0 + r) * X + c0 + k])
                              : 0.f;
    __syncthreads();
    if constexpr (VEC > 1) {
      const int T = (J + kRows - 1) / kRows;
      for (int t = 0; t < T; ++t) {
        issue(t + kStages - 1);
        cp_async_wait<kStages - 1>();  // stage t has landed
        consume(t);
      }
    } else {
      // scalar columns (N % 8 != 0 for bf16, % 4 for fp32): plain loads
      for (int j = 0; j < J; ++j) {
        const int k = kg + j * KG;
        const float wk = to_f32(w[(size_t)k * N]);
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[r][0] = fmaf(x_s[r][k], wk, acc[r][0]);
      }
    }
  }

  // the KG partial sums of each output, in a fixed order: a shuffle tree
  // within each warp (its lanes < TPR end with the warp's sums; with TPR
  // >= 32 a warp holds one row group's 32 columns and has nothing to
  // add), then the warps that hold the column, in order
  constexpr int WPR = TPR > 32 ? TPR / 32 : 1;  // warps across one row
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float v = acc[r][e];
#pragma unroll
      for (int off = 16; off >= TPR; off /= 2)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane < TPR) warp_s[warp][r][lane_c * VEC + e] = v;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < RB * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int q0 = (c / VEC / 32) % WPR;
    float s = warp_s[q0][r][c];
    for (int q = q0 + WPR; q < kWarps; q += WPR) s += warp_s[q][r][c];
    part_s[r][c] = s;
  }
  cluster.sync();  // every CTA's partial stripe is written and visible

  // this CTA's share of the stripe: the S partials in rank order
  const int share = kCols / S;
  for (int i = threadIdx.x; i < RB * share; i += kThreads) {
    const int r = i / share, c = split * share + i % share;
    const int n = n0 + c;
    if (r >= nrows || n >= N) continue;
    float p[kMaxSplits];  // every remote read issued before the sum
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < S) p[q] = *cluster.map_shared_rank(&part_s[r][c], q);
    float s = p[0];
#pragma unroll
    for (int q = 1; q < kMaxSplits; ++q)
      if (q < S) s += p[q];
    if (bias != nullptr) s += bias[n];
    y[(size_t)(b0 + r) * N + n] = from_f32<XT>(s);
  }
  cluster.sync();  // no CTA leaves while another still reads its part_s
}

// One kernel instance and its launch configuration.
template <typename XT_, typename WT_, int VEC_, int RB_>
struct Inst {
  typedef XT_ XT;
  typedef WT_ WT;
  static constexpr int VEC = VEC_, RB = RB_;
};

struct Config {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
};

// The grid and cluster of a launch; a cluster above 8 CTAs is opted in
// (once per instance).
template <typename I>
cudaError_t configure(Config& c, int B, int N, int S, cudaStream_t stream) {
  auto kern = mvm_kernel<typename I::XT, typename I::WT, I::VEC, I::RB>;
  const size_t ring = I::VEC > 1 ? kRingBytes : 0;
  // the ring and the static arrays together exceed the 48 KB default
  static const cudaError_t opt_in = ring ? cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(ring))
      : cudaSuccess;
  if (opt_in != cudaSuccess) return opt_in;
  if (S > 8) {
    static const cudaError_t opt_in16 = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (opt_in16 != cudaSuccess) return opt_in16;
  }
  c.cfg = cudaLaunchConfig_t{};
  c.cfg.gridDim = dim3(S, (N + kCols - 1) / kCols, (B + I::RB - 1) / I::RB);
  c.cfg.blockDim = dim3(kThreads);
  c.cfg.dynamicSmemBytes = ring;
  c.cfg.stream = stream;
  c.attr.id = cudaLaunchAttributeClusterDimension;
  c.attr.val.clusterDim.x = S;
  c.attr.val.clusterDim.y = 1;
  c.attr.val.clusterDim.z = 1;
  c.cfg.attrs = &c.attr;
  c.cfg.numAttrs = 1;
  return cudaSuccess;
}

struct LaunchOp {
  const void *x, *W, *b;
  void* y;
  int B, X, N, S;
  cudaStream_t stream;
  template <typename I>
  cudaError_t run() const {
    Config c;
    cudaError_t err = configure<I>(c, B, N, S, stream);
    if (err != cudaSuccess) return err;
    const int slice = (X + S - 1) / S;
    err = cudaLaunchKernelEx(
        &c.cfg, mvm_kernel<typename I::XT, typename I::WT, I::VEC, I::RB>,
        static_cast<const typename I::XT*>(x),
        static_cast<const typename I::WT*>(W), static_cast<const float*>(b),
        static_cast<typename I::XT*>(y), B, X, N, slice);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
};

struct OccupancyOp {
  int B, N, S;
  int* clusters;
  template <typename I>
  cudaError_t run() const {
    Config c;
    cudaError_t err = configure<I>(c, B, N, S, nullptr);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(
        clusters, mvm_kernel<typename I::XT, typename I::WT, I::VEC, I::RB>,
        &c.cfg);
  }
};

template <typename XT, typename WT, int VEC, typename Op>
cudaError_t by_rows(const Op& op) {
  const int rb = rows_per_block(op.B);
  if (rb == 1) return op.template run<Inst<XT, WT, VEC, 1>>();
  if (rb == 2) return op.template run<Inst<XT, WT, VEC, 2>>();
  return op.template run<Inst<XT, WT, VEC, 4>>();
}

template <typename XT, typename WT, typename Op>
cudaError_t by_vec(const Op& op) {
  constexpr int V = 16 / sizeof(WT);  // one 16-byte load per W row
  if (op.N % V == 0) return by_rows<XT, WT, V>(op);
  return by_rows<XT, WT, 1>(op);
}

template <typename Op>
cudaError_t by_types(const Op& op, int x_type, int w_type) {
  if (op.B < 1 || op.N < 1 || op.S < 1 || op.S > kMaxSplits ||
      kCols % op.S != 0 || (op.B + 3) / 4 > 65535 ||
      (op.N + kCols - 1) / kCols > 65535)
    return cudaErrorInvalidValue;
  if (x_type == 0 && w_type == 0) return by_vec<float, float>(op);
  if (x_type == 0 && w_type == 1) return by_vec<float, bf16>(op);
  if (x_type == 1 && w_type == 0) return by_vec<bf16, float>(op);
  if (x_type == 1 && w_type == 1) return by_vec<bf16, bf16>(op);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mvm

// Plain C entry points (bound with ctypes).  Layouts, all contiguous:
// x (B, X) and y (B, N) in x's type, W (X, N) in W's type (0 = fp32,
// 1 = bf16 for x_type / w_type), b (N,) fp32 or NULL.  B, X, N >= 1;
// splits S in {1, 2, 4, 8, 16}, the CTAs of one cluster.

// Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int mvm_launch(const void* x, const void* W, const void* b,
                          void* y, int B, int X, int N, int splits,
                          int x_type, int w_type, void* stream) {
  if (X < 1) return static_cast<int>(cudaErrorInvalidValue);
  const mvm::LaunchOp op{x, W, b, y, B, X, N, splits,
                         static_cast<cudaStream_t>(stream)};
  return static_cast<int>(mvm::by_types(op, x_type, w_type));
}

// How many clusters of the instance a launch at (B, N, splits) takes can
// be resident on the card at once (cudaOccupancyMaxActiveClusters), into
// *clusters; returns the CUDA error (0 = ok).
extern "C" int mvm_max_clusters(int B, int N, int splits, int x_type,
                                int w_type, int* clusters) {
  const mvm::OccupancyOp op{B, N, splits, clusters};
  return static_cast<int>(mvm::by_types(op, x_type, w_type));
}
