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
// floats and writes one, so the least time is (2 reads + 1 write) x B x T x
// W x 4 bytes over 3.35 TB/s: 75 us at B = 4, T = 2048, W = 2560, 19 us at
// B = 1.  The ~59 fp32 operations of a step (two exps of ~26 each, a sqrt,
// the products; an fma counted as two) take 18 us at B = 4 over the card's
// 67 TFLOP/s.  The one-thread-a-channel kernel before this design reached
// neither: each of B x W threads (2.4 warps an SM at B = 4) walked its
// whole chain of two exps, a sqrt and the fma step by step, waiting on
// instruction latency, ~0.57 us a step.
//
// The design: only the last fma of a step depends on h.  a_t and b_t =
// sqrt(max(1 - a_t^2, 0)) * g_t depend on the inputs alone, so they are
// computed in parallel over a tile of T, and the serial chain is one fma a
// step.
//  - Each CTA owns a strip of C consecutive channels of one batch row and
//    walks all of T.  C is the widest of 32, 16, 8 that still gives at
//    least two CTAs an SM (B = 4, W = 2560: C = 32, 320 CTAs; B = 1: C = 8,
//    320 CTAs on 132 SMs).  A ragged last strip masks its channels.
//  - T goes in tiles of kTileElems / C steps (32, 64 or 128), a (steps x C)
//    block of log_a and one of gx.  Four producer warps stream the tiles
//    through a ring of kStages slots in shared memory with cp.async (16
//    bytes where W % 4 == 0 and the inputs are 16-byte aligned, 4 bytes
//    otherwise; rows past T and channels past W are zero-filled), the
//    next tile in flight while they compute the current one.  Each
//    producer thread copies and then computes the same quads (4 channels
//    of one step), so its own cp.async.wait_group is all the
//    synchronisation the raw data needs; it writes a_t over log_a and b_t
//    over gx in place.
//  - One chain warp walks each tile, lane c on channel c:
//    h = fmaf(a_t, h, b_t).  It loads the next kBatch steps' (a_t, b_t)
//    while the fmas of the current kBatch run, keeps their h in registers
//    and stores them to hs after the batch (the warp's C consecutive
//    channels are one store a step), so that no load or store waits inside
//    the fma chain.  The last h goes to hT.
//  - The chain of tile k runs while the producers compute tile k + 1 and
//    the loads of tile k + 2 are in flight.  Producers and chain meet only
//    at two mbarriers a slot (full: the 128 producers' arrivals; empty:
//    the chain warp's 32), never at a CTA-wide barrier.
//  - Variants that were slower on an H100 (PERF.md, section 6): more slots
//    (more tiles of loads in flight), 8 or 2 producer warps, tiles of 2048
//    elements, a chain that stored h after every step, and h kept in the
//    slot for the producers to write out.
//
// Numerics: the recurrence is ill-conditioned near a = 1, where 1 - a^2
// cancels and one ulp of exp moves sqrt(1 - a^2) by many, so the kernel
// evaluates each step with the operations XLA emits for the reference's
// compiled scan, as the plain version (kernels/rglru/ref.py) does: XLA's
// fp32 exp (the Cephes polynomial, its range reduction and Horner steps as
// fmaf), a^2 as exp(2 * log_a) (XLA rewrites exp(x) * exp(x) into
// exp(x + x)), IEEE sqrtf, b = s * g rounded on its own, and h = fmaf(a,
// h, b).  Every other product and sum is rounded on its own (__fmul_rn /
// __fadd_rn / __fsub_rn), so nvcc contracts nothing else; no fast-math flag
// is set.  That is why this is not a two-pass associative scan over blocks
// of T: combining blocks reassociates the products of the a_t, so hs would
// no longer be the sequential fp32 result, and near a = 1 the difference
// is not small.  Here every a_t, b_t and h_t is computed by exactly the
// operations, in exactly the order, of the one-thread-a-channel kernel
// this design replaced, whatever C, the tile or the grid: hs is bit-equal
// to that kernel's in every channel, a row does not depend on B, and a
// scan split into two calls (the second started from the first's hT)
// equals one call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace rglru {
namespace {

constexpr int kProducerWarps = 4;
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kThreads = 32 + kProducers;  // the chain warp first
constexpr int kTileElems = 1024;            // steps x channels of a tile
constexpr int kStages = 3;                  // ring slots
constexpr int kAhead = kStages - 2;         // tiles in flight past compute
constexpr int kBatch = 32;                  // chain steps loaded ahead
constexpr int kTailBatch = 8;               // the same in a partial tile
constexpr int kSlotFloats = 2 * kTileElems; // a tile of log_a and of gx
constexpr int kSmemBytes =
    kStages * kSlotFloats * 4 + 2 * kStages * 8;  // + full / empty
static_assert(kSmemBytes <= 48 * 1024, "no opt-in for more shared memory");

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

// a_t over log_a and b_t over g, in place: the step's h-independent part
__device__ __forceinline__ void coefficients(float& la, float& g) {
  const float a = xla_expf(la);
  const float a2 = xla_expf(__fadd_rn(la, la));
  const float s = sqrtf(fmaxf(__fsub_rn(1.0f, a2), 0.0f));
  g = __fmul_rn(s, g);
  la = a;
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// N bytes global -> shared; with `full` false nothing is read and the
// destination is zero-filled
template <int N>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src,
                                         bool full) {
  const unsigned n = full ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem(bar)),
               "r"(count)
               : "memory");
}
// release: this thread's earlier shared-memory accesses are ordered
// before the waiter's acquire
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(
          smem(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// VEC: 16-byte copies (W % 4 == 0, 16-byte aligned inputs); C: the
// strip's channels
template <bool VEC, int C>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ gx, const float* __restrict__ h0,
                  float* __restrict__ hs, float* __restrict__ hT, int T,
                  int W, int strips) {
  constexpr int kTileT = kTileElems / C;  // steps a tile
  constexpr int kRowQuads = C / 4;
  constexpr int kPer = kTileElems / 4 / kProducers;  // quads a thread
  static_assert(kPer * 4 * kProducers == kTileElems, "tile");
  static_assert(kTileT % kBatch == 0 && kTileT % kTailBatch == 0, "batch");
  // a slot holds a tile as kTileT rows of 2 C floats: log_a's C channels
  // (a_t once computed), then gx's (b_t)
  extern __shared__ __align__(16) float ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kSlotFloats);
  uint64_t* empty = full + kStages;

  const int b = blockIdx.x / strips;
  const int w0 = (blockIdx.x % strips) * C;
  const size_t base = (size_t)b * T * W + w0;  // element (b, 0, w0)
  const int tiles = (T + kTileT - 1) / kTileT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kProducers);
      mbar_init(&empty[s], 32);
    }
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // the chain warp: lane c walks channel w0 + c
    const int c = threadIdx.x;
    const bool live = c < C && w0 + c < W;
    float h = live ? h0[(size_t)b * W + w0 + c] : 0.0f;
    for (int k = 0; k < tiles; ++k) {
      const int s = k % kStages;
      mbar_wait(&full[s], (k / kStages) & 1);
      const float* slot = ring + s * kSlotFloats;
      const int nt = min(kTileT, T - k * kTileT);
      float* o = hs + base + c + (size_t)k * kTileT * W;
      if (c < C && nt == kTileT) {
        float a[kBatch], bt[kBatch], an[kBatch], bn[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          a[u] = slot[u * 2 * C + c];
          bt[u] = slot[u * 2 * C + C + c];
        }
#pragma unroll
        for (int i = 0; i < kTileT; i += kBatch) {
          if (i + kBatch < kTileT) {
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              an[u] = slot[(i + kBatch + u) * 2 * C + c];
              bn[u] = slot[(i + kBatch + u) * 2 * C + C + c];
            }
          }
          float hv[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            hv[u] = h = fmaf(a[u], h, bt[u]);
            a[u] = an[u];
            bt[u] = bn[u];
          }
          if (live) {
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              *o = hv[u];
              o += W;
            }
          }
        }
      } else if (c < C) {  // the last tile of a T that is not a multiple
        for (int i = 0; i < nt; i += kTailBatch) {
          float a[kTailBatch], bt[kTailBatch];
#pragma unroll
          for (int u = 0; u < kTailBatch; ++u) {
            a[u] = slot[(i + u) * 2 * C + c];
            bt[u] = slot[(i + u) * 2 * C + C + c];
          }
#pragma unroll
          for (int u = 0; u < kTailBatch; ++u) {
            if (i + u < nt) {
              h = fmaf(a[u], h, bt[u]);
              if (live) o[(size_t)(i + u) * W] = h;
            }
          }
        }
      }
      mbar_arrive(&empty[s]);
    }
    if (live) hT[(size_t)b * W + w0 + c] = h;
    return;
  }

  // producers: thread p owns quads p, p + 128, ... of every tile, quad q
  // being channels 4 (q % kRowQuads) .. + 3 of row q / kRowQuads
  const int p = threadIdx.x - 32;
  auto issue = [&](int k) {  // tile k's loads into its slot
    float* slot = ring + (k % kStages) * kSlotFloats;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = p + j * kProducers;
      const int r = q / kRowQuads, w = 4 * (q % kRowQuads);
      const int t = k * kTileT + r;
      const unsigned dla = smem(slot + r * 2 * C + w);
      const unsigned dg = dla + 4 * C;
      if constexpr (VEC) {
        const bool ok = t < T && w0 + w < W;  // W % 4 == 0: all or none
        const size_t off = ok ? base + (size_t)t * W + w : 0;
        cp_async<16>(dla, log_a + off, ok);
        cp_async<16>(dg, gx + off, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = t < T && w0 + w + e < W;
          const size_t off = ok ? base + (size_t)t * W + w + e : 0;
          cp_async<4>(dla + 4 * e, log_a + off, ok);
          cp_async<4>(dg + 4 * e, gx + off, ok);
        }
      }
    }
  };

  for (int k = 0; k < kAhead; ++k) {
    if (k < tiles) issue(k);
    cp_async_commit();
  }
  for (int k = 0; k < tiles; ++k) {
    const int j = k + kAhead;
    if (j < tiles) {
      // slot j % kStages last held tile j - kStages: wait for the chain
      if (j >= kStages) mbar_wait(&empty[j % kStages], (j / kStages - 1) & 1);
      issue(j);
    }
    cp_async_commit();
    cp_async_wait<kAhead>();  // this thread's copies of tile k have landed
    float* slot = ring + (k % kStages) * kSlotFloats;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = p + i * kProducers;
      const int r = q / kRowQuads, w = 4 * (q % kRowQuads);
      float4* la = reinterpret_cast<float4*>(slot + r * 2 * C + w);
      float4* g = reinterpret_cast<float4*>(slot + r * 2 * C + C + w);
      float4 x = *la, y = *g;
      coefficients(x.x, y.x);
      coefficients(x.y, y.y);
      coefficients(x.z, y.z);
      coefficients(x.w, y.w);
      *la = x;
      *g = y;
    }
    mbar_arrive(&full[k % kStages]);
  }
}

template <bool VEC, int C>
cudaError_t launch(const float* log_a, const float* gx, const float* h0,
                   float* hs, float* hT, int B, int T, int W,
                   cudaStream_t stream) {
  const int strips = (W + C - 1) / C;
  const long long blocks = (long long)B * strips;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rglru_scan_kernel<VEC, C>
      <<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, stream>>>(
          log_a, gx, h0, hs, hT, T, W, strips);
  return cudaGetLastError();
}

// C: the widest strip that still gives at least two CTAs an SM
template <bool VEC>
cudaError_t by_strip(const float* log_a, const float* gx, const float* h0,
                     float* hs, float* hT, int B, int T, int W,
                     cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((long long)B * ((W + 31) / 32) >= 2LL * sms)
    return launch<VEC, 32>(log_a, gx, h0, hs, hT, B, T, W, stream);
  if ((long long)B * ((W + 15) / 16) >= 2LL * sms)
    return launch<VEC, 16>(log_a, gx, h0, hs, hT, B, T, W, stream);
  return launch<VEC, 8>(log_a, gx, h0, hs, hT, B, T, W, stream);
}

}  // namespace
}  // namespace rglru

// Plain C entry point (bound with ctypes).  Layouts, all contiguous fp32:
// log_a and gx (B, T, W), h0 (B, W); outputs hs (B, T, W) and hT (B, W).
// T >= 1.  Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int rglru_scan_launch(const void* log_a, const void* gx,
                                 const void* h0, void* hs, void* hT, int B,
                                 int T, int W, void* stream) {
  if (B < 0 || T < 1 || W < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * W == 0) return 0;
  const auto* la = static_cast<const float*>(log_a);
  const auto* g = static_cast<const float*>(gx);
  const auto* h = static_cast<const float*>(h0);
  auto* out = static_cast<float*>(hs);
  auto* last = static_cast<float*>(hT);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = W % 4 == 0 && ((reinterpret_cast<uintptr_t>(la) |
                                   reinterpret_cast<uintptr_t>(g)) &
                                  15) == 0;
  const cudaError_t err =
      vec ? rglru::by_strip<true>(la, g, h, out, last, B, T, W, st)
          : rglru::by_strip<false>(la, g, h, out, last, B, T, W, st);
  return static_cast<int>(err);
}
