// rglru_scan_bwd: the backward of rglru_scan (csrc/rglru_scan.cu), the
// reverse recurrence of the cotangents over T steps in ONE launch, for
// every (batch row, channel) at once.
//
// The JAX package has no backward kernel: jax.grad differentiates the
// reference's jax.lax.scan (src/repro/models/layers/rglru.py:50).  This
// kernel computes the same function for the port's forward.  For each
// (b, w), with a_t = exp(la_t), a2_t = exp(2 la_t), s_t = sqrt(max(1 -
// a2_t, 0)), h_{-1} = h0 and delta_t the cotangent of h_t:
//   delta_{T-1} = dhs_{T-1} + dhT,  delta_t = fma(a_{t+1}, delta_{t+1}, dhs_t)
//   dgx_t       = s_t * delta_t
//   dlog_a_t    = delta_t * fma(a_t, h_{t-1}, u_t),  u_t = g_t * ds_t/dla_t
//   dh0         = a_0 * delta_0
// where ds/dla = -(a2 * sel) / s is the derivative of s = sqrt(max(1 -
// exp(2 la), 0)) with maximum's selector as jax.grad takes it (sel = 1
// where 1 - a2 > 0, 1/2 where it is 0, 0 below).  Where a rounds to 1
// (s = 0) that is -inf, and dlog_a is +-inf or nan, as jax.grad gives
// there too; the plain version (kernels/rglru/ref.py,
// rglru_scan_bwd_plain) says when it happens.
//
// What bounds it on an H100: bytes.  Each step of each channel reads
// four floats (log_a, gx, hs, dhs) and writes two (dlog_a, dgx): 6 x B x T
// x W x 4 bytes over 3.35 TB/s, 18.8 us at B = 1, T = 1024, W = 2560.
//
// The design: only the fma of delta depends on the previous step.  a_t,
// s_t and q_t = fma(a_t, h_{t-1}, u_t) depend on the inputs alone, and
// dgx_t and dlog_a_t only on delta_t, so all but one fma a step is
// parallel over a tile of T.
//  - Each CTA owns a strip of C consecutive channels of one batch row and
//    walks all of T backwards, C chosen as in rglru_scan (the widest of 32,
//    16, 8 that still gives at least two CTAs an SM).  A ragged last strip
//    masks its channels.
//  - T goes in tiles of kTileElems / C steps, from the last tile to the
//    first.  Each of the 256 threads owns the same kPer elements (step,
//    channel) of every tile.  For a tile it computes a, s, q from the
//    registers its loads landed in and writes them, with dhs, to shared
//    memory; then issues the loads of the next (earlier) tile into the
//    same registers, so that they are in flight while the chain runs.
//  - One chain warp (lane c on channel c) walks the tile from its last
//    step to its first, delta = fmaf(a_next, delta, dhs_t), loading a
//    batch of (a, dhs) ahead of the fmas, and writes delta over dhs.
//  - Then each thread reads delta for its elements and writes dgx and
//    dlog_a.  Two CTA barriers a tile: before and after the chain.  A
//    thread writes in the next tile only the shared slots it read itself,
//    so no third barrier is needed.
//
// Numerics: every operation is the plain version's, in its order, each
// product and sum rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, IEEE sqrtf) and the three fmas as fmaf; no fast-math flag.
// The a_t are the forward's own bits (the same xla_expf).  Nothing depends
// on C, the tile or the grid, so a row's results do not depend on B, and
// a run equals the next bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace rglru_bwd {
namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 1024;                  // steps x channels
constexpr int kPer = kTileElems / kThreads;       // elements a thread
constexpr int kBatch = 8;                         // chain loads ahead

// fp32 exp as XLA evaluates it on the CPU (rglru_scan.cu's xla_expf,
// operation for operation)
__device__ __forceinline__ float xla_expf(float x) {
  x = fminf(fmaxf(x, -88.3762626647949f), 88.3762626647950f);
  const float n = floorf(fmaf(x, 1.44269504088896341f, 0.5f));
  float r = fmaf(n, -0.693359375f, x);
  r = fmaf(n, 2.12194440e-4f, r);
  const float z = __fmul_rn(r, r);
  float y = 1.9875691500e-4f;
  y = fmaf(y, r, 1.3981999507e-3f);
  y = fmaf(y, r, 8.3334519073e-3f);
  y = fmaf(y, r, 4.1665795894e-2f);
  y = fmaf(y, r, 1.6666665459e-1f);
  y = fmaf(y, r, 5.0000001201e-1f);
  y = __fadd_rn(fmaf(y, z, r), 1.0f);
  return __fmul_rn(y, __int_as_float((static_cast<int>(n) + 127) << 23));
}

template <int C>
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const float* __restrict__ log_a,
                      const float* __restrict__ gx,
                      const float* __restrict__ h0,
                      const float* __restrict__ hs,
                      const float* __restrict__ dhs,
                      const float* __restrict__ dhT,
                      float* __restrict__ dla, float* __restrict__ dgx,
                      float* __restrict__ dh0, int T, int W, int strips) {
  constexpr int kTileT = kTileElems / C;  // steps a tile
  static_assert(kTileT % kBatch == 0, "batch");
  // a tile as kTileT rows of C channels: a_t, s_t, q_t, and dhs_t
  // (delta_t once the chain has passed)
  __shared__ float sa[kTileElems], ss[kTileElems], sq[kTileElems],
      sd[kTileElems];

  const int b = blockIdx.x / strips;
  const int w0 = (blockIdx.x % strips) * C;
  const size_t base = (size_t)b * T * W + w0;  // element (b, 0, w0)
  const int tiles = (T + kTileT - 1) / kTileT;
  const int p = threadIdx.x;

  // this thread's elements e = p + j * kThreads: row e / C, channel e % C
  float la[kPer], g[kPer], hp[kPer], dh[kPer];
  auto load = [&](int k) {  // tile k's inputs into the registers
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = p + j * kThreads;
      const int r = e / C, c = e % C;
      const int t = k * kTileT + r;
      const bool ok = t < T && w0 + c < W;
      const size_t off = base + (size_t)t * W + c;
      la[j] = ok ? log_a[off] : 0.0f;
      g[j] = ok ? gx[off] : 0.0f;
      dh[j] = ok ? dhs[off] : 0.0f;
      hp[j] = !ok ? 0.0f
                  : (t > 0 ? hs[off - W] : h0[(size_t)b * W + w0 + c]);
    }
  };

  const int c = threadIdx.x;  // the chain warp's channel
  const bool live = c < C && w0 + c < W;
  float delta = live ? dhT[(size_t)b * W + w0 + c] : 0.0f;
  float a_next = 1.0f;  // fmaf(1, dhT, dhs_{T-1}) = dhs + dhT, one rounding

  load(tiles - 1);
  for (int k = tiles - 1; k >= 0; --k) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {  // the h-independent part
      const int e = p + j * kThreads;
      const float a = xla_expf(la[j]);
      const float a2 = xla_expf(__fadd_rn(la[j], la[j]));
      const float d = __fsub_rn(1.0f, a2);
      const float s = sqrtf(fmaxf(d, 0.0f));
      const float sel = d > 0.0f ? 1.0f : (d == 0.0f ? 0.5f : 0.0f);
      const float u = __fmul_rn(g[j], -__fdiv_rn(__fmul_rn(a2, sel), s));
      sa[e] = a;
      ss[e] = s;
      sq[e] = fmaf(a, hp[j], u);
      sd[e] = dh[j];
    }
    if (k > 0) load(k - 1);  // in flight while the chain runs
    __syncthreads();
    if (c < 32) {
      const int nt = min(kTileT, T - k * kTileT);
      if (c < C) {
        int i = nt;  // steps [0, i) of the tile are left, walked downwards
        for (; i >= kBatch; i -= kBatch) {
          float av[kBatch], dv[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            av[u] = sa[(i - 1 - u) * C + c];
            dv[u] = sd[(i - 1 - u) * C + c];
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            delta = fmaf(a_next, delta, dv[u]);
            dv[u] = delta;
            a_next = av[u];
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) sd[(i - 1 - u) * C + c] = dv[u];
        }
        for (; i > 0; --i) {
          delta = fmaf(a_next, delta, sd[(i - 1) * C + c]);
          sd[(i - 1) * C + c] = delta;
          a_next = sa[(i - 1) * C + c];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {  // the outputs of this tile
      const int e = p + j * kThreads;
      const int r = e / C, cc = e % C;
      const int t = k * kTileT + r;
      if (t < T && w0 + cc < W) {
        const size_t off = base + (size_t)t * W + cc;
        const float dv = sd[e];
        dgx[off] = __fmul_rn(ss[e], dv);
        dla[off] = __fmul_rn(dv, sq[e]);
      }
    }
  }
  // a_next is a_0 and delta is delta_0 after the first tile's chain
  if (live) dh0[(size_t)b * W + w0 + c] = __fmul_rn(a_next, delta);
}

template <int C>
cudaError_t launch(const float* la, const float* g, const float* h0,
                   const float* hs, const float* dhs, const float* dhT,
                   float* dla, float* dgx, float* dh0, int B, int T, int W,
                   cudaStream_t stream) {
  const int strips = (W + C - 1) / C;
  const long long blocks = (long long)B * strips;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rglru_scan_bwd_kernel<C><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(la, g, h0, hs, dhs, dhT, dla, dgx,
                                       dh0, T, W, strips);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rglru_bwd

// Plain C entry point (bound with ctypes).  Layouts, all contiguous fp32:
// log_a, gx, hs, dhs (B, T, W), h0 and dhT (B, W); outputs dlog_a and dgx
// (B, T, W) and dh0 (B, W).  T >= 1.  Launches on `stream` and returns
// cudaGetLastError() (0 = ok).
extern "C" int rglru_scan_bwd_launch(const void* log_a, const void* gx,
                                     const void* h0, const void* hs,
                                     const void* dhs, const void* dhT,
                                     void* dlog_a, void* dgx, void* dh0,
                                     int B, int T, int W, void* stream) {
  if (B < 0 || T < 1 || W < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * W == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* la = static_cast<const float*>(log_a);
  const auto* g = static_cast<const float*>(gx);
  const auto* h = static_cast<const float*>(h0);
  const auto* y = static_cast<const float*>(hs);
  const auto* dy = static_cast<const float*>(dhs);
  const auto* dyT = static_cast<const float*>(dhT);
  auto* o_la = static_cast<float*>(dlog_a);
  auto* o_g = static_cast<float*>(dgx);
  auto* o_h = static_cast<float*>(dh0);
  const auto st = static_cast<cudaStream_t>(stream);
  // the strip rule of rglru_scan (kernels.rglru.ops.scan_tile mirrors it)
  if ((long long)B * ((W + 31) / 32) >= 2LL * sms)
    err = rglru_bwd::launch<32>(la, g, h, y, dy, dyT, o_la, o_g, o_h, B, T,
                                W, st);
  else if ((long long)B * ((W + 15) / 16) >= 2LL * sms)
    err = rglru_bwd::launch<16>(la, g, h, y, dy, dyT, o_la, o_g, o_h, B, T,
                                W, st);
  else
    err = rglru_bwd::launch<8>(la, g, h, y, dy, dyT, o_la, o_g, o_h, B, T,
                               W, st);
  return static_cast<int>(err);
}
