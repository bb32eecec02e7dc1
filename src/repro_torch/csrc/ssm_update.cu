// ssm_update: one decode step of the Mamba-2 selective state-space
// recurrence for every (batch row, head), the state updated in place.
//
// Replaces no TPU kernel: the JAX package has no Mamba-2 block.  It was
// added with the granite-4.0-h hybrid (models/layers/mamba2.py), whose
// decode step would otherwise make about five passes of plain PyTorch over
// the state and copy the new state back into the engine's cache.  Same
// function as kernels/ssm/ops.py's plain version: for each (b, h), with
// g = h / (H / G) the head's group,
//   delta = softplus(dt[b, h] + dt_bias[h])        (threshold 20, as torch)
//   dA    = exp(delta * A[h])                      (A = -exp(A_log) < 0)
//   S[p, n] = S[p, n] * dA + (delta * x[p]) * B[g, n]
//   y[p]    = sum_n S[p, n] * C[g, n] + D[h] * x[p]
// where x (H x P), B and C (G x N each) are one row of xbc (the conv's
// output), S (P x N) is the cached state and y (H x P); all fp32.
//
// What bounds it on an H100: bytes.  The state is read once and written
// once; at granite-4.0-h-micro's 64 heads of 64 x 128 fp32 that is 2 MiB a
// row each way, so a 32-row step moves 134 MB, 40 us at 3.35 TB/s, against
// ~2 MFLOP a row.  The inputs (one xbc row, 17 KB) are noise beside it.
//
// The design: one CTA per (b, h, 16 rows of p), 8 warps of 2 rows each;
// lane l holds the V = N / 32 consecutive states n = l V .. l V + V - 1 of
// its row (16 bytes of fp32 at N = 128), so a warp reads a row as whole
// 128-byte lines.  Each warp issues both rows' loads before it computes,
// the lanes' B and C values sit in registers for the CTA's rows, and y of
// a row is the warp's shuffle tree over the lanes' partial sums.  The state
// moves with cache-streaming loads and stores (it is not read again within
// the step).  Many small CTAs (8,192 at B = 32; 256 at B = 1) keep enough
// loads in flight on every SM at both ends of the batch.  Each output's sum
// order depends on N alone, never on B or the grid, so a row is bit-equal
// at every B and run to run.

#include <cuda_runtime.h>

namespace ssm {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;

// the raw type a lane loads in one instruction, by bytes
template <int kBytes> struct Raw;
template <> struct Raw<4> { using T = float; };
template <> struct Raw<8> { using T = float2; };
template <> struct Raw<16> { using T = float4; };

// V consecutive fp32 states, moved in chunks of at most 16 bytes
template <int V> struct Seg {
  static constexpr int kBytes = V * 4;
  static constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  using T = typename Raw<kChunk>::T;
  union {
    T raw[kBytes / kChunk];
    float s[V];
  };
  __device__ __forceinline__ void load(const float* p) {
#pragma unroll
    for (int c = 0; c < kBytes / kChunk; ++c)
      raw[c] = __ldcs(reinterpret_cast<const T*>(p) + c);
  }
  __device__ __forceinline__ void store(float* p) const {
#pragma unroll
    for (int c = 0; c < kBytes / kChunk; ++c)
      __stcs(reinterpret_cast<T*>(p) + c, raw[c]);
  }
};

template <int V>
__global__ void __launch_bounds__(kThreads)
    ssm_update_kernel(float* __restrict__ state, const float* __restrict__ xbc,
                      const float* __restrict__ dt,
                      const float* __restrict__ dt_bias,
                      const float* __restrict__ A,
                      const float* __restrict__ D, float* __restrict__ y,
                      int H, int P, int G, int row_stride) {
  constexpr int N = 32 * V;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cta_rows = (P + kRowsPerCta - 1) / kRowsPerCta;
  const int bh = blockIdx.x / cta_rows;  // b * H + h
  const int p0 = (blockIdx.x % cta_rows) * kRowsPerCta;
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h / (H / G);
  const float* row = xbc + static_cast<size_t>(b) * row_stride;

  // the rows' states first, so that their loads are in flight together
  Seg<V> s[kRowsPerWarp];
  float* base = state + static_cast<size_t>(bh) * P * N + lane * V;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int p = p0 + warp + r * kWarps;
    if (p < P) s[r].load(base + static_cast<size_t>(p) * N);
  }

  const float v = dt[bh] + dt_bias[h];
  const float delta = v > 20.0f ? v : log1pf(expf(v));
  const float dA = expf(delta * A[h]);
  const float d = D[h];
  const float* Bv = row + H * P + g * N + lane * V;
  const float* Cv = row + H * P + G * N + g * N + lane * V;
  float bn[V], cn[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    bn[k] = __ldg(Bv + k);
    cn[k] = __ldg(Cv + k);
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int p = p0 + warp + r * kWarps;
    if (p >= P) continue;  // uniform across the warp
    const float x = __ldg(row + h * P + p);
    const float dx = delta * x;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float sn = fmaf(s[r].s[k], dA, dx * bn[k]);
      s[r].s[k] = sn;
      acc = fmaf(sn, cn[k], acc);
    }
    s[r].store(base + static_cast<size_t>(p) * N);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) y[static_cast<size_t>(bh) * P + p] = fmaf(d, x, acc);
  }
}

template <int V>
cudaError_t launch(float* state, const float* xbc, const float* dt,
                   const float* dt_bias, const float* A, const float* D,
                   float* y, int B, int H, int P, int G, int row_stride,
                   cudaStream_t st) {
  const long long blocks = static_cast<long long>(B) * H *
                           ((P + kRowsPerCta - 1) / kRowsPerCta);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssm_update_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      state, xbc, dt, dt_bias, A, D, y, H, P, G, row_stride);
  return cudaGetLastError();
}

cudaError_t by_state(int N, float* state, const float* xbc, const float* dt,
                     const float* dt_bias, const float* A, const float* D,
                     float* y, int B, int H, int P, int G, int row_stride,
                     cudaStream_t st) {
  switch (N) {
    case 32:
      return launch<1>(state, xbc, dt, dt_bias, A, D, y, B, H, P, G,
                         row_stride, st);
    case 64:
      return launch<2>(state, xbc, dt, dt_bias, A, D, y, B, H, P, G,
                         row_stride, st);
    case 128:
      return launch<4>(state, xbc, dt, dt_bias, A, D, y, B, H, P, G,
                         row_stride, st);
    case 256:
      return launch<8>(state, xbc, dt, dt_bias, A, D, y, B, H, P, G,
                         row_stride, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ssm

// One decode step: state (B, H, P, N) fp32, updated in place; xbc
// (B, row_stride) fp32 holding x (H P), B (G N) and C (G N) at the start
// of each row; dt (B, H), dt_bias, A, D (H) fp32;
// y (B, H, P) fp32 written.  N is 32, 64, 128 or 256; G divides H.
// Returns the CUDA error of the launch (0 = ok).
extern "C" int ssm_update_launch(void* state, const void* xbc, const void* dt,
                                 const void* dt_bias, const void* A,
                                 const void* D, void* y, int B, int H, int P,
                                 int N, int G, int row_stride,
                                 void* stream) {
  if (B < 0 || H < 1 || P < 1 || G < 1 || H % G != 0 ||
      row_stride < H * P + 2 * G * N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const auto* x = static_cast<const float*>(xbc);
  const auto* t = static_cast<const float*>(dt);
  const auto* tb = static_cast<const float*>(dt_bias);
  const auto* a = static_cast<const float*>(A);
  const auto* dd = static_cast<const float*>(D);
  auto* out = static_cast<float*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(ssm::by_state(N, static_cast<float*>(state), x, t,
                                        tb, a, dd, out, B, H, P, G,
                                        row_stride, st));
}
