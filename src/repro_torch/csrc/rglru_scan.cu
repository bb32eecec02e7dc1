// rglru_scan: the RG-LRU gated linear recurrence over T steps in ONE
// launch, for every (batch row, channel) at once.
//
// Replaces the TPU kernel rglru_scan_pallas / _kernel
// (src/repro/kernels/rglru/kernel.py:40 / :22).  Same function: for each
// (b, w), a_t = exp(log_a[b, t, w]) and
//   h = a_t * h + sqrt(max(1 - a_t^2, 0)) * gx[b, t, w],
// starting from h0[b, w]; hs[b, t, w] is h after step t and hT[b, w] the
// state after the last step.  Everything is fp32.
//
// What bounds it on an H100: bytes.  Each step of each channel reads two
// floats and writes one, and does a handful of operations, so the least
// time is (2 reads + 1 write) x B x T x W x 4 bytes over 3.35 TB/s — 75 us
// at B = 4, T = 2048, W = 2560.  The recurrence is serial in t but the
// channels are independent.
//
// What the design does about it: the TPU kernel walks its grid (channel
// block, t) in order with the state in VMEM scratch; a CUDA grid has no
// order between blocks, so here each thread owns ONE (b, w) channel, keeps
// h in a register and loops over T itself.  Neighbouring threads own
// neighbouring w, so every load and store of a warp is one contiguous
// 128-byte line; blocks are small (64 threads) so that B x W channels
// spread over as many SMs as possible.  The loads of log_a and gx do not
// depend on h, so the loop keeps the next kPrefetch steps' loads in flight
// in a register ring while it computes the current step.  One channel per
// thread leaves only B x W threads (10,240 at B = 4, W = 2560), each
// walking T serially, so the kernel stays far from its bound; splitting T
// across blocks with a two-pass associative scan is later work.
//
// Numerics: the recurrence is ill-conditioned near a = 1, where 1 - a^2
// cancels and one ulp of exp moves sqrt(1 - a^2) by many, so the kernel
// evaluates each step with the operations XLA emits for the reference's
// compiled scan, as the plain version (kernels/rglru/ref.py) does: XLA's
// fp32 exp (the Cephes polynomial, its range reduction and Horner steps as
// fmaf), a^2 as exp(2 * log_a) (XLA rewrites exp(x) * exp(x) into
// exp(x + x)), IEEE sqrtf, and h = fmaf(a, h, s * g).  Every other product
// and sum is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn), so
// nvcc contracts nothing else; no fast-math flag is set.  Any W works
// (there are no vector loads, so a ragged W such as 513 needs no special
// case).

#include <cuda_runtime.h>

namespace rglru {

constexpr int kThreads = 64;
constexpr int kPrefetch = 8;

// fp32 exp as XLA evaluates it on the CPU: n = floor(x log2(e) + 1/2),
// r = x - n C1 - n C2, exp(r) by the Cephes degree-7 polynomial, times 2^n
// (the plain version's xla_exp, operation for operation)
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
  // 2^n from its exponent bits: n is in [-127, 128] after the clamp
  return __fmul_rn(y, __int_as_float((static_cast<int>(n) + 127) << 23));
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ log_a, const float* __restrict__ gx,
            const float* __restrict__ h0, float* __restrict__ hs,
            float* __restrict__ hT, int B, int T, int W) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= (long long)B * W) return;
  const int b = static_cast<int>(ch / W);
  const int w = static_cast<int>(ch % W);
  // element (b, t, w) of a (B, T, W) array is base + t * W
  const size_t base = (size_t)b * T * W + w;
  const float* la = log_a + base;
  const float* g = gx + base;
  float* out = hs + base;

  float la_buf[kPrefetch], g_buf[kPrefetch];
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i) {
    if (i < T) {
      la_buf[i] = la[(size_t)i * W];
      g_buf[i] = g[(size_t)i * W];
    }
  }
  float h = h0[ch];
  for (int t0 = 0; t0 < T; t0 += kPrefetch) {
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const int t = t0 + i;
      if (t < T) {
        const float a = xla_expf(la_buf[i]);
        const float a2 = xla_expf(__fadd_rn(la_buf[i], la_buf[i]));
        const float s = sqrtf(fmaxf(__fsub_rn(1.0f, a2), 0.0f));
        h = fmaf(a, h, __fmul_rn(s, g_buf[i]));
        out[(size_t)t * W] = h;
        const int tn = t + kPrefetch;
        if (tn < T) {
          la_buf[i] = la[(size_t)tn * W];
          g_buf[i] = g[(size_t)tn * W];
        }
      }
    }
  }
  hT[ch] = h;
}

}  // namespace rglru

// Plain C entry point (bound with ctypes).  Layouts, all contiguous fp32:
// log_a and gx (B, T, W), h0 (B, W); outputs hs (B, T, W) and hT (B, W).
// T >= 1.  Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int rglru_scan_launch(const void* log_a, const void* gx,
                                 const void* h0, void* hs, void* hT, int B,
                                 int T, int W, void* stream) {
  const long long channels = (long long)B * W;
  const long long blocks =
      (channels + rglru::kThreads - 1) / rglru::kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rglru::scan_kernel<<<static_cast<unsigned>(blocks), rglru::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(gx),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(hT), B, T, W);
  return static_cast<int>(cudaGetLastError());
}
