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
// 39.3 MB for a 2560 x 7680 bf16 W, 0.0117 ms at 3.35 TB/s.
//
// What the design does about it: a CUDA grid has no order between blocks,
// so nothing carries an accumulator from one block to the next; each block
// owns a stripe of kCols = 32 output columns over ALL of X and all of its
// batch rows.  Inside the block the 256 threads split X: a thread holds
// VEC adjacent columns (VEC = 8 bf16 or 4 fp32 values, one 16-byte load per
// W row; VEC = 1 when N is not a multiple of that) for all of the block's
// rows in fp32 registers, and walks the rows k = kg, kg + KG, ... of W,
// where KG = 256 / (kCols / VEC) thread groups share the stripe.
// Neighbouring threads read neighbouring columns of one W row, so W is
// read once, in contiguous runs of 64 (bf16) or 128 (fp32) bytes.  x is
// staged in shared memory in fp32, kChunk rows of X at a time, masked at
// the X edge.  The KG partial sums of each output are then added in shared
// memory in a fixed order, the bias added in fp32, and the sum rounded
// once: every run sums in the same order (no atomics).  B > 4 takes more
// row groups (gridDim.y), each reading W again.
//
// At N = 2560 the 32-column stripes give only 80 blocks for 132 SMs, and
// at N = 512 only 16: the card is underfilled at those widths.  Splitting
// X across blocks (a second pass that adds the partial stripes in a fixed
// order) is the lever, and later work.

#include "rnn_common.cuh"

namespace mvm {

using namespace rnn;

constexpr int kThreads = 256;
constexpr int kCols = 32;     // output columns per block
constexpr int kChunk = 256;   // rows of X staged in shared memory at once

template <typename XT, typename WT, int VEC, int RB>
__global__ void __launch_bounds__(kThreads)
mvm_kernel(const XT* __restrict__ x, const WT* __restrict__ W,
           const float* __restrict__ bias, XT* __restrict__ y, int B, int X,
           int N) {
  constexpr int TPR = kCols / VEC;        // threads across the stripe
  constexpr int KG = kThreads / TPR;      // thread groups along X
  __shared__ float x_s[RB][kChunk];
  __shared__ float part_s[KG][RB][kCols];

  const int b0 = blockIdx.y * RB;
  const int nrows = min(RB, B - b0);
  const int n0 = blockIdx.x * kCols;
  const int lane_c = threadIdx.x % TPR;   // which VEC columns of the stripe
  const int kg = threadIdx.x / TPR;       // which rows of X
  const int col = n0 + lane_c * VEC;
  // a vector lies wholly inside or wholly outside N (N % VEC == 0 for
  // VEC > 1); the scalar instance masks column by column
  const bool live = col < N;

  float acc[RB][VEC];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;

  for (int k0 = 0; k0 < X; k0 += kChunk) {
    const int kn = min(kChunk, X - k0);
    __syncthreads();  // the previous chunk's x_s is no longer read
    for (int i = threadIdx.x; i < RB * kChunk; i += kThreads) {
      const int r = i / kChunk, k = i % kChunk;
      x_s[r][k] = (r < nrows && k < kn)
                      ? to_f32(x[(size_t)(b0 + r) * X + k0 + k]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const WT* w = W + (size_t)k0 * N + col;
#pragma unroll 4
    for (int k = kg; k < kn; k += KG) {
      float wk[VEC];
      loadv<VEC>(w + (size_t)k * N, wk);  // 16 bytes for VEC > 1
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float xk = x_s[r][k];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(xk, wk[e], acc[r][e]);
      }
    }
  }

  // the KG partial sums of each output, added in a fixed order
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) part_s[kg][r][lane_c * VEC + e] = acc[r][e];
  __syncthreads();
  for (int i = threadIdx.x; i < RB * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int n = n0 + c;
    if (r >= nrows || n >= N) continue;
    float s = 0.f;
    for (int g = 0; g < KG; ++g) s = __fadd_rn(s, part_s[g][r][c]);
    if (bias != nullptr) s = __fadd_rn(s, bias[n]);
    y[(size_t)(b0 + r) * N + n] = from_f32<XT>(s);
  }
}

template <typename XT, typename WT, int VEC, int RB>
cudaError_t launch(const void* x, const void* W, const void* b, void* y,
                   int B, int X, int N, cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols, (B + RB - 1) / RB);
  mvm_kernel<XT, WT, VEC, RB><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(W),
      static_cast<const float*>(b), static_cast<XT*>(y), B, X, N);
  return cudaGetLastError();
}

template <typename XT, typename WT, int VEC>
cudaError_t by_rows(const void* x, const void* W, const void* b, void* y,
                    int B, int X, int N, cudaStream_t s) {
  const int rb = rows_per_block(B);
  if (rb == 1) return launch<XT, WT, VEC, 1>(x, W, b, y, B, X, N, s);
  if (rb == 2) return launch<XT, WT, VEC, 2>(x, W, b, y, B, X, N, s);
  return launch<XT, WT, VEC, 4>(x, W, b, y, B, X, N, s);
}

template <typename XT, typename WT>
cudaError_t by_vec(const void* x, const void* W, const void* b, void* y,
                   int B, int X, int N, cudaStream_t s) {
  constexpr int V = 16 / sizeof(WT);  // one 16-byte load per W row
  if (N % V == 0) return by_rows<XT, WT, V>(x, W, b, y, B, X, N, s);
  return by_rows<XT, WT, 1>(x, W, b, y, B, X, N, s);
}

}  // namespace mvm

// Plain C entry point (bound with ctypes).  Layouts, all contiguous:
// x (B, X) and y (B, N) in x's type, W (X, N) in W's type (0 = fp32,
// 1 = bf16 for x_type / w_type), b (N,) fp32 or NULL.  B, X, N >= 1.
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int mvm_launch(const void* x, const void* W, const void* b,
                          void* y, int B, int X, int N, int x_type,
                          int w_type, void* stream) {
  using rnn::bf16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || X < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((B + 3) / 4 > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_type == 0 && w_type == 0)
    err = mvm::by_vec<float, float>(x, W, b, y, B, X, N, s);
  else if (x_type == 0 && w_type == 1)
    err = mvm::by_vec<float, bf16>(x, W, b, y, B, X, N, s);
  else if (x_type == 1 && w_type == 0)
    err = mvm::by_vec<bf16, float>(x, W, b, y, B, X, N, s);
  else if (x_type == 1 && w_type == 1)
    err = mvm::by_vec<bf16, bf16>(x, W, b, y, B, X, N, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
