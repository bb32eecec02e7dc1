// lstm_cell: ONE LSTM step, gates = h . U + xw_t, as a grid of independent
// CTAs, each owning a slice of 8 hidden units with all four gate columns.
//
// Replaces the TPU kernel lstm_cell_pallas / _kernel
// (src/repro/kernels/lstm_cell/kernel.py:76 / :39).  Same function:
// gates = h . U + xw_t in fp32 (gate order i, f, g, o), c = f * c_prev +
// i * g, h = o * tanh(c); h comes out in h_prev's dtype, c in fp32.  The
// Pallas grid walks (j over H output columns, k over reduction stripes of
// block_k rows) in order with an fp32 accumulator in VMEM; a CUDA grid has
// no order between blocks, and a single step has no chain between its
// hidden units, so here every CTA is independent: no cluster, no DSMEM,
// no atomics.  block_h and block_k (the TPU tile) are accepted by the
// Python wrapper, checked and not passed: the split below comes from the
// shape alone.
//
// What bounds it on an H100: a step reads U once (H x 4H: 0.46 MB in
// bf16 at H = 340, 8.4 MB at H = 1024) and does 8 B H^2 fp32 operations
// -- well under a microsecond of memory traffic at H = 340, 2.5 us from
// HBM at H = 1024.  The per_step schedule launches it once per (layer,
// step), 150 times for a BYSDNE forward at T = 30, so at H = 340 the
// launch and the latency of one pass through memory set its time, and at
// H = 1024 the bytes do.
//
// The split (mirrored in Python as kernels.common.cell_split; from (H,
// U's type) alone, never from B or a timing):
//   * CTA x owns the hidden units [8x, min(8x + 8, H)) (kUnits): the gate
//     epilogue and c stay in the CTA, as in the decode split
//     (decode_cluster.cuh).  ceil(H / 8) CTAs: 43 at H = 340, 128 at
//     H = 1024, 512 at H = 4096; so U is spread over the whole card.
//   * Its 4 * 8 = 32 gate columns split into Q = 32 / V vectors of V
//     adjacent units: V = 8 bf16 values (one 16-byte load) where H % 8 ==
//     0, V = 4 (8 bytes of bf16, 16 of fp32) where H % 4 == 0
//     (cluster.cuh's unit_align), else V = 1; slices start on multiples
//     of 8 units, so every vector is aligned.
//   * Its 256 threads split the H rows into KG = 256 / Q contiguous
//     groups of KR = ceil(H / KG) rows; thread (kg, q) sums its rows of
//     its vector in row order in fp32, with up to 256 bytes (at most 32
//     rows) of its loads in flight at once, held in registers as loaded
//     (the first batch issued before h is staged).  Each
//     output is then the sum of its KG partials in group order, in shared
//     memory.  The last CTA's columns past H are masked (no load, no
//     store).
//   * Up to RB = 4 batch rows a CTA (h staged once in shared memory in
//     fp32, interleaved by row, so one shared load feeds RB * V FMAs per
//     weight vector); grid.y walks groups of 4 rows when B > 4.  A row's
//     sums never depend on the other rows, so its outputs are bit-equal
//     at B = 1, 4 and 5, run to run, and between a CUDA-graph replay and
//     the eager call.
//
// Shared memory: h of RB rows (4 * RB * H bytes), then -- after a barrier,
// in the same bytes -- the partials (4 * KG * RB * 32 bytes).  So the
// kernel takes every H whose h rows fit the 227 KB a CTA may opt in to
// (H <= 14,528 at 4 rows), as the design before it did; past that the
// launch is refused, never served by the plain version.
//
// What was tried (PERF.md; NVIDIA H100 80GB HBM3 at 700 W, ms a launch in
// a CUDA graph of the per_step schedule's 150 launches, B = 4, bf16 U):
// the design before this one -- a CTA per 128 units, each thread walking
// all H rows of one unit's four columns with 2-byte loads, 3 CTAs at H =
// 340 -- took 0.036 at H = 340 and 0.63 at H = 1024 (U from HBM).  This
// split with the weights converted to fp32 as they load (rnn_common's
// loadv: 64 values a thread, so 8 rows of 16-byte vectors in flight, two
// trips to HBM at H = 1024) took 0.0040 and 0.0101; kept as loaded (Raw
// below), 16 such rows fit 64 registers, one trip: 0.0040 and 0.0092,
// 3.6x the bytes bound at H = 1024.  At H = 340 the kernel's ~4 us is
// latency (a launch, one pass through L2, three barriers, a 32-deep
// partial sum), not bytes (0.29 us).

#include "cluster.cuh"
#include "rnn_common.cuh"

namespace lstm {
// internal linkage: the per-instance opt-in statics stay this library's own
namespace {

using namespace rnn;
using cluster::kMaxSmem;
using cluster::load_f32;
using cluster::unit_align;

constexpr int kThreads = 256;
constexpr int kUnits = 8;           // hidden units a CTA
constexpr int kCols = 4 * kUnits;   // its gate columns
constexpr int kInFlight = 256;      // bytes of U a thread has in flight
constexpr int kMaxChunk = 32;       // ... in at most this many rows

// V adjacent weights of type T as one load puts them in registers (16
// bytes: 8 bf16 or 4 fp32; 8 bytes: 4 bf16; or one value), and as fp32.
template <typename T, int V>
struct Raw {
  static_assert(V == 1, "vectors of 8 or 4 bf16, or of 4 fp32");
  T v;
  __device__ void load(const T* p) { v = *p; }
  __device__ void get(float (&w)[V]) const { w[0] = to_f32(v); }
};
template <>
struct Raw<bf16, 8> {
  uint4 v;
  __device__ void load(const bf16* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  __device__ void get(float (&w)[8]) const {
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
      w[2 * i] = f.x;
      w[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Raw<bf16, 4> {
  uint2 v;
  __device__ void load(const bf16* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ void get(float (&w)[4]) const {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
  }
};
template <>
struct Raw<float, 4> {
  float4 v;
  __device__ void load(const float* p) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ void get(float (&w)[4]) const {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
};

// RB adjacent fp32 values of shared memory (one vector load).
template <int RB>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[RB]) {
  if constexpr (RB == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (RB == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

template <int RB>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[RB]) {
  if constexpr (RB == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (RB == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    p[0] = v[0];
}

template <typename UT, int V, int RB>
__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const UT* __restrict__ U, const void* __restrict__ xw,
                 const void* __restrict__ h, const float* __restrict__ c,
                 void* __restrict__ h_out, float* __restrict__ c_out, int B,
                 int H, int xw_bf16, int h_bf16) {
  constexpr int Q = kCols / V;           // vectors of a row's slice
  constexpr int KG = kThreads / Q;       // row groups
  constexpr int CH_ = kInFlight / (V * (int)sizeof(UT));
  constexpr int CH = CH_ < kMaxChunk ? CH_ : kMaxChunk;  // rows in flight
  // h_s [H][RB] (fp32), then in the same bytes part_s [KG][RB][kCols]
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;
  float* part_s = smem;

  const int tid = threadIdx.x;
  const int q = tid % Q, kg = tid / Q;
  const int u0 = blockIdx.x * kUnits;
  const int nu = min(kUnits, H - u0);
  const int b0 = blockIdx.y * RB;
  const int nrows = min(RB, B - b0);
  const size_t G4 = 4 * (size_t)H;

  // this thread's vector: gate g, units u0 + j0 .. u0 + j0 + V - 1, and
  // its rows [k_lo, k_lo + J); a vector past H has no rows
  const int g = q / (kUnits / V), j0 = q % (kUnits / V) * V;
  const int KR = (H + KG - 1) / KG;
  const int k_lo = min(H, kg * KR);
  const int J = j0 < nu ? min(H, k_lo + KR) - k_lo : 0;
  const UT* src = U + (size_t)k_lo * G4 + (size_t)g * H + u0 + j0;

  Raw<UT, V> w[CH];
  auto load = [&](int i0) {
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if (i0 + i < J) w[i].load(src + (size_t)(i0 + i) * G4);
  };
  load(0);  // in flight while h is staged

  // the epilogue's operands, one gate of one (row, unit) a thread of the
  // first RB warps: o = (r * kUnits + u) * 4 + gate
  const int o_gate = tid & 3, o_unit = (tid >> 2) % kUnits;
  const int o_row = tid / kCols;
  const bool cell = tid < RB * kCols && o_row < nrows && o_unit < nu;
  const size_t state = (size_t)(b0 + o_row) * H + u0 + o_unit;
  float xw_o = 0.f, c_o = 0.f;
  if (cell) {
    xw_o = load_f32(xw, (size_t)(b0 + o_row) * G4 + (size_t)o_gate * H + u0
                        + o_unit, xw_bf16);
    if (o_gate == 0) c_o = c[state];
  }

  if (H % 4 == 0) {
    // four adjacent k of each row a thread: one 16-byte (fp32) or 8-byte
    // (bf16) load a row
    for (int k = 4 * tid; k < H; k += 4 * kThreads) {
      float v[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const size_t i = (size_t)(b0 + r) * H + k;
        if (r >= nrows) {
          v[r][0] = v[r][1] = v[r][2] = v[r][3] = 0.f;
        } else if (h_bf16) {
          Raw<bf16, 4> x;
          x.load(static_cast<const bf16*>(h) + i);
          x.get(v[r]);
        } else {
          Raw<float, 4> x;
          x.load(static_cast<const float*>(h) + i);
          x.get(v[r]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float col[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) col[r] = v[r][j];
        store_rows<RB>(h_s + (size_t)(k + j) * RB, col);
      }
    }
  } else {
    for (int k = tid; k < H; k += kThreads) {
      float v[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        v[r] = r < nrows ? load_f32(h, (size_t)(b0 + r) * H + k, h_bf16)
                         : 0.f;
      store_rows<RB>(h_s + (size_t)k * RB, v);
    }
  }
  __syncthreads();

  float acc[RB][V];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
  for (int i0 = 0; i0 < J; i0 += CH) {
    if (i0 > 0) load(i0);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (i0 + i < J) {
        float hk[RB], wf[V];
        load_rows<RB>(h_s + (size_t)(k_lo + i0 + i) * RB, hk);
        w[i].get(wf);
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[r][e] = fmaf(hk[r], wf[e], acc[r][e]);
      }
    }
  }
  __syncthreads();  // h_s read by every thread: its bytes take the partials

#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < V; ++e)
      part_s[((size_t)kg * RB + r) * kCols + q * V + e] = acc[r][e];
  __syncthreads();

  if (tid < RB * kCols) {  // whole warps: the shuffles take every lane
    const float* p = part_s + (size_t)o_row * kCols + o_gate * kUnits
                     + o_unit;
    float s = p[0];
#pragma unroll 4
    for (int k = 1; k < KG; ++k) s += p[(size_t)k * RB * kCols];
    float x4[4], s4[4];
    const int base = tid & 31 & ~3;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x4[e] = __shfl_sync(0xffffffffu, xw_o, base + e);
      s4[e] = __shfl_sync(0xffffffffu, s, base + e);
    }
    if (cell && o_gate == 0) {
      float c_new = 0.f;
      const float h_new = LstmCell::update(x4, s4, 0.f, c_o, c_new);
      c_out[state] = c_new;
      if (h_bf16)
        static_cast<bf16*>(h_out)[state] = from_f32<bf16>(h_new);
      else
        static_cast<float*>(h_out)[state] = h_new;
    }
  }
}

// ---------------------------------------------------------------------------
// host side

struct Args {
  const void *U, *xw, *h, *c;
  void *h_out, *c_out;
  int B, H, u_bf16, xw_bf16, h_bf16;
  cudaStream_t stream;
};

// What a launch takes, without launching: CTAs (x: unit slices, y: groups
// of RB rows), V, KG and the shared memory (-1: past the card's).
struct Shape {
  int ctas_x, ctas_y, V, KG, smem;
};

template <typename UT_, int V, int RB>
struct Inst {
  typedef UT_ UT;
  static auto kernel() { return lstm_cell_kernel<UT_, V, RB>; }
  static Shape shape(const Args& a) {
    constexpr int KG = kThreads / (kCols / V);
    const size_t h_bytes = sizeof(float) * RB * (size_t)a.H;
    const size_t part_bytes = sizeof(float) * KG * RB * kCols;
    const size_t smem = h_bytes > part_bytes ? h_bytes : part_bytes;
    return Shape{(a.H + kUnits - 1) / kUnits, (a.B + RB - 1) / RB, V, KG,
                 smem > (size_t)kMaxSmem ? -1 : static_cast<int>(smem)};
  }
};

struct LaunchOp {
  template <class I>
  cudaError_t run(const Args& a) const {
    // past 48 KB of dynamic shared memory a kernel must opt in: once per
    // instance, to the most a CTA may take
    static const cudaError_t opted = cudaFuncSetAttribute(
        I::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (opted != cudaSuccess) return opted;
    const Shape s = I::shape(a);
    if (s.smem < 0 || s.ctas_y > 65535) return cudaErrorInvalidValue;
    const auto kernel = I::kernel();
    kernel<<<dim3(s.ctas_x, s.ctas_y), kThreads, s.smem, a.stream>>>(
        static_cast<const typename I::UT*>(a.U), a.xw, a.h,
        static_cast<const float*>(a.c), a.h_out,
        static_cast<float*>(a.c_out), a.B, a.H, a.xw_bf16, a.h_bf16);
    return cudaGetLastError();
  }
};

struct ShapeOp {
  Shape* out;
  template <class I>
  cudaError_t run(const Args& a) const {
    *out = I::shape(a);
    return out->smem < 0 ? cudaErrorInvalidValue : cudaSuccess;
  }
};

template <typename UT, int V, class Op>
cudaError_t by_rows(const Args& a, const Op& op) {
  switch (rows_per_block(a.B)) {
    case 1: return op.template run<Inst<UT, V, 1>>(a);
    case 2: return op.template run<Inst<UT, V, 2>>(a);
    default: return op.template run<Inst<UT, V, 4>>(a);
  }
}

// V from the slice alignment and U's type (see the header), then the
// rows a CTA.
template <class Op>
cudaError_t dispatch(const Args& a, const Op& op) {
  if (a.B < 1 || a.H < 1) return cudaErrorInvalidValue;
  const int A = unit_align(a.H);
  if (a.u_bf16) {
    if (A == 8) return by_rows<bf16, 8>(a, op);
    if (A == 4) return by_rows<bf16, 4>(a, op);
    return by_rows<bf16, 1>(a, op);
  }
  if (A >= 4) return by_rows<float, 4>(a, op);
  return by_rows<float, 1>(a, op);
}

}  // namespace
}  // namespace lstm

// Plain C entry points (bound with ctypes).  Layouts, all contiguous:
// U (H, 4, H); xw (B, 4, H); h (B, H); c (B, H) fp32; outputs h_out (B, H)
// in h's dtype and c_out (B, H) fp32.  *_bf16 flags pick bfloat16 over
// fp32 per operand.  lstm_cell_launch launches on `stream` and returns
// cudaGetLastError() (0 = ok; a refused configuration -- shared memory
// past the card's at this H -- returns cudaErrorInvalidValue and launches
// nothing).  lstm_cell_shape writes what a launch at (B, H, U's type)
// takes -- CTAs along x and y, V, KG, shared memory -- into out[0..4].
extern "C" int lstm_cell_launch(const void* U, const void* xw, const void* h,
                                const void* c, void* h_out, void* c_out,
                                int B, int H, int u_bf16, int xw_bf16,
                                int h_bf16, void* stream) {
  const lstm::Args a{U, xw, h, c, h_out, c_out, B, H, u_bf16, xw_bf16,
                     h_bf16, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(lstm::dispatch(a, lstm::LaunchOp{}));
}

extern "C" int lstm_cell_shape(int B, int H, int u_bf16, int* out) {
  const lstm::Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     B, H, u_bf16, 0, 0, nullptr};
  lstm::Shape s{};
  const int rc = static_cast<int>(lstm::dispatch(a, lstm::ShapeOp{&s}));
  out[0] = s.ctas_x;
  out[1] = s.ctas_y;
  out[2] = s.V;
  out[3] = s.KG;
  out[4] = s.smem;
  return rc;
}
