// The cluster design shared by the two decode kernels (lstm_decode.cu,
// gru_decode.cu): one T=1 tick through all L layers of a recurrent stack
// in ONE launch, with each layer's hidden units spread over the S CTAs of
// a thread-block cluster.  A kernel file instantiates `cluster_kernel`
// with its cell (rnn_common.cuh's LstmCell or GruCell: the gate count G
// and the update of one hidden unit from its G input halves and its G
// recurrent products).  The split and the copy and barrier helpers are
// cluster.cuh's, shared with the sequence kernels.
//
// Shape of a launch.  The grid is S x B: one cluster of S CTAs
// (cudaLaunchKernelEx, cluster dimension S along x) per batch row, every
// cluster reading the weights (from L2 after the first).  S comes from
// (H, G) alone (`splits`, mirrored in Python as
// kernels.common.decode_splits): the fewest CTAs, a power of two up to 16,
// whose slices hold at most kSliceCols gate columns each -- 16 at both of
// the paper's widths (H = 340 and 1024).  S = 16 is a non-portable cluster
// size, opted in per instance.  The card holds 7 such clusters at once,
// so up to 7 rows run side by side.
//
// The split.  CTA `rank` owns the contiguous hidden units [u0, u0 + nu)
// (`slice`) with all G gate columns of each, so the cell update, the LSTM
// cell state and the GRU's coupling n = tanh(xw_n + r * (U_n h)) stay in
// the CTA.  Slices start and end on multiples of A = 8 units when H % 8
// == 0, of A = 4 when H % 4 == 0, else of 1 (`unit_align`), which is what
// the vector loads need: a CTA reads, for each weight row k, G segments of
// nu units, segment g starting at element k * G * H + g * H + u0.
//
// Inside a CTA.  Its 512 threads split the slice's G * nu columns into Q
// vectors of V adjacent units (V = 8 bf16 values, one 16-byte load, when
// W and U are bf16 and A = 8; V = 4 when A >= 4: 8 bytes of bf16, 16 of
// fp32; V = 1, plain loads, otherwise), and the H weight rows into KG =
// 512 / Q contiguous groups; thread (kg, q) sums its rows of its vector
// in fp32, in row order.  Each output is then the sum of its KG partials
// in group order.  No partial sum crosses CTAs, and the order depends on
// (H, G, V) only -- never on B or the run -- so a row's outputs are
// bit-equal at B = 1 and B = 4, run to run, and between a graph replay
// and the eager call.
//
// The weight stream.  A thread's loads form one stream over the tick's
// 2L - 1 matrices in the order the chain uses them (U_0, U_1, W_1, U_2,
// W_2, ...); W_0 is never read.  Each load lands through cp.async in the
// thread's own ring of kRingBytes / 512 / SLOT slots in shared memory
// (SLOT = 8 or 16 bytes), and a thread reads only the slots it filled, so
// the ring needs no barrier.  The ring runs ahead across layer
// boundaries: while the chain waits for a layer's input, the coming
// layers' W and U rows are already in flight.
//
// The chain.  Layer l's recurrent product U_l . h0[l] does not depend on
// the chain (h0 is known at launch), so each layer computes it first; only
// y . W_l and the cell update wait for the previous layer's output y.
// After its cell update each CTA writes its slice of y into every CTA's
// y buffer through distributed shared memory (map_shared_rank; four units
// to a vector store where slices align to 4) and arrives on the cluster
// barrier; the wait comes only before the next layer's y . W_l, after
// that layer's U product.  y is double-buffered by layer parity: a CTA
// writes y_l only after every CTA has arrived past y_(l-1)'s reads, so two
// buffers suffice.  The first arrive goes out at launch and its wait
// precedes the first remote write (every CTA of the cluster has then
// started); the last layer writes no y, so no CTA can receive a remote
// write after its last wait and none waits at exit.
//
// Rounding points (the reference's _decode_kernel): y . W_l accumulated in
// fp32 and rounded to xw_dtype = promote(h0.dtype, W.dtype); b_l, cast to
// xw_dtype, added in xw_dtype; the result to fp32.  The inter-layer y is h
// rounded through h0's dtype.  U is upcast to fp32 before its product, so
// its type (UT) is independent of W's (WT, which alone sets xw_dtype).
#pragma once

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "rnn_common.cuh"

namespace decode {
// internal linkage: the function-local statics below (the per-instance
// opt-ins) stay each library's own
namespace {

namespace cg = cooperative_groups;
using namespace cluster;
using namespace rnn;

constexpr int kCtaThreads = 512;
// a thread's ring of weight loads, over the CTA's 512 threads
constexpr int kRingBytes = 64 * 1024;
// h0[l + 1], one value a thread per 512 units, held in registers
constexpr int kHeldH = kMaxH / kCtaThreads;

// V adjacent weights of type T from a ring slot, as fp32.
template <typename T, int V>
__device__ __forceinline__ void unpack(const unsigned char* slot,
                                       float (&w)[V]) {
  constexpr int NW = V * (int)sizeof(T) / 4;  // 32-bit words
  uint32_t words[NW];
  if constexpr (NW == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(slot);
    words[0] = v.x; words[1] = v.y; words[2] = v.z; words[3] = v.w;
  } else {
    static_assert(NW == 2, "a ring slot holds 8 or 16 bytes of one row");
    const uint2 v = *reinterpret_cast<const uint2*>(slot);
    words[0] = v.x; words[1] = v.y;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if constexpr (sizeof(T) == 2) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
      w[2 * i] = f.x;
      w[2 * i + 1] = f.y;
    } else {
      w[i] = __uint_as_float(words[i]);
    }
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One thread's stream of weight rows through its ring (see the header):
// the issue side walks a global pointer row by row and matrix by matrix,
// both sides walk their ring slot by a masked offset (the ring is a power
// of two), so a row costs a few integer operations besides its copy.
template <typename WT, typename UT, int V>
struct Stream {
  static constexpr int SLOT =
      V * (int)(sizeof(WT) > sizeof(UT) ? sizeof(WT) : sizeof(UT));
  static constexpr int STAGES = kRingBytes / (kCtaThreads * SLOT);
  static constexpr unsigned STEP = kCtaThreads * SLOT;  // slot to slot
  static constexpr unsigned MASK = kRingBytes - 1;
  static constexpr int kUnroll = STAGES >= 16 ? 4 : 2;  // rows a wait
  static constexpr bool kSame = sizeof(WT) == sizeof(UT);
  // shared memory of the ring (none for plain loads)
  static constexpr size_t kBytes = V > 1 ? kRingBytes : 0;

  const WT* Ws;
  const UT* Us;
  size_t col, GH, LH;  // the vector's column; a row's and a layer's size
  int k_lo, J, M;      // the thread's rows [k_lo, k_lo + J); 2L - 1 matrices
  int im, left;        // issue: the matrix, its rows still to issue
  const char* src;     // ... the next row's address
  size_t step;         // ... the matrix's row stride in bytes
  unsigned ring_s, w_off, r_off;  // the thread's ring lane; issue, consume
  const unsigned char* ring_g;

  __device__ void init(const WT* Ws_, const UT* Us_, unsigned char* ring,
                       size_t col_, size_t GH_, int H, int k_lo_, int J_,
                       int L) {
    Ws = Ws_;
    Us = Us_;
    col = col_;
    GH = GH_;
    LH = (size_t)H * GH_;
    k_lo = k_lo_;
    J = J_;
    M = 2 * L - 1;
    im = J > 0 ? 0 : M;
    start(0);
    ring_g = ring + threadIdx.x * SLOT;
    ring_s = static_cast<unsigned>(__cvta_generic_to_shared(ring_g));
    w_off = r_off = 0;
  }

  __device__ static bool is_u(int m) { return m == 0 || (m & 1); }

  // Issue from matrix m of the stream, at the thread's first row and
  // column: U_0, then U_l (odd m) and W_l (even m) for l = (m + 1) / 2.
  __device__ void start(int m) {
    const size_t off = (size_t)((m + 1) >> 1) * LH + (size_t)k_lo * GH + col;
    src = is_u(m) ? reinterpret_cast<const char*>(Us + off)
                  : reinterpret_cast<const char*>(Ws + off);
    step = GH * (is_u(m) ? sizeof(UT) : sizeof(WT));
    left = J;
  }

  // Put the stream's next row in flight (an empty group past the end
  // keeps the group count).
  __device__ void issue() {
    if constexpr (V > 1) {
      if (im < M) {
        if (kSame || is_u(im))
          cp_async<V * (int)sizeof(UT)>(ring_s + w_off, src);
        else
          cp_async<V * (int)sizeof(WT)>(ring_s + w_off, src);
        src += step;
        if (--left == 0 && ++im < M) start(im);
      }
      cp_async_commit();
      w_off = (w_off + STEP) & MASK;
    }
  }

  // The ring's first rows, before the chain starts: kUnroll slots stay
  // free for the first wait's issues.
  __device__ void prologue() {
    if constexpr (V > 1) {
#pragma unroll 1
      for (int t = 0; t < STAGES - kUnroll; ++t) issue();
    }
  }

  // acc[e] = sum over the thread's rows k of x[k] * mat[k][col + e] in
  // fp32, in row order: the next matrix of the stream (V > 1), or mat read
  // directly (V = 1).
  template <typename T>
  __device__ void product(const T* __restrict__ mat,
                          const float* __restrict__ x_s, float (&acc)[V]) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    const float* x_k = x_s + k_lo;
    if constexpr (V > 1) {
      auto consume = [&](int i) {
        float w[V];
        unpack<T, V>(ring_g + r_off, w);
        r_off = (r_off + STEP) & MASK;
        const float x = x_k[i];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(x, w[e], acc[e]);
      };
      // kUnroll rows share one wait, so their loads and FMAs interleave:
      // STAGES - kUnroll rows are in flight between waits, and the
      // kUnroll issued before a wait fill the slots last consumed
      int i = 0;
      for (; i + kUnroll <= J; i += kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) issue();
        cp_async_wait<STAGES - kUnroll>();  // rows i .. i + kUnroll - 1
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) consume(i + u);
      }
      for (; i < J; ++i) {
        issue();
        cp_async_wait<STAGES - kUnroll>();
        consume(i);
      }
    } else {
      const T* p = mat + (size_t)k_lo * GH + col;
#pragma unroll 4
      for (int i = 0; i < J; ++i)
        acc[0] = fmaf(x_k[i], to_f32(p[(size_t)i * GH]), acc[0]);
    }
  }
};

template <class Cell, typename WT, typename UT, int V>
__global__ void __launch_bounds__(kCtaThreads, 1)
cluster_kernel(const void* __restrict__ xw0, const WT* __restrict__ Ws,
               const WT* __restrict__ bs, const UT* __restrict__ Us,
               const void* __restrict__ h0, const float* __restrict__ c0,
               void* __restrict__ hn, float* __restrict__ cn, int L, int B,
               int H, int x_bf16, int h_bf16) {
  constexpr int G = Cell::G;
  typedef Stream<WT, UT, V> St;
  extern __shared__ __align__(16) unsigned char smem[];
  float* y_s = reinterpret_cast<float*>(smem + St::kBytes);  // [2][H]
  float* hp_s = y_s + 2 * H;                // [H] this layer's h0
  float* sum_s = hp_s + H;                  // [G * nu] reduced sums
  float* part_s = sum_s + kCtaThreads;      // [KG][G * nu] partials

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int b = blockIdx.y;  // this cluster's batch row
  const Slice sl = slice(H, S, rank);
  const int u0 = sl.u0, nu = sl.nu, GN = G * nu;
  const int cpg = nu / V;  // vectors per gate segment
  const int Q = G * cpg;
  const int KG = kCtaThreads / Q;
  const int KR = (H + KG - 1) / KG;
  const int q = tid % Q, kg = tid / Q;
  const int k_lo = min(H, kg * KR);
  const size_t GH = (size_t)G * H;

  St st;
  st.init(Ws, Us, smem, (size_t)(q / cpg) * H + u0 + (q % cpg) * V, GH, H,
          k_lo, kg < KG ? min(H, k_lo + KR) - k_lo : 0, L);

  // the unit this thread updates
  const bool cell = tid < nu;
  const int cu = cell ? tid : 0;
  const bool xw_bf16 = h_bf16 && sizeof(WT) == 2;

  auto load_h = [&](int l, float (&regs)[kHeldH]) {
#pragma unroll
    for (int n = 0; n < kHeldH; ++n) {
      const int k = tid + n * kCtaThreads;
      if (k < H) regs[n] = load_f32(h0, ((size_t)l * B + b) * H + k, h_bf16);
    }
  };
  auto store_h = [&](const float (&regs)[kHeldH]) {
#pragma unroll
    for (int n = 0; n < kHeldH; ++n) {
      const int k = tid + n * kCtaThreads;
      if (k < H) hp_s[k] = regs[n];
    }
  };
  // matrix l of U (w = false) or W times x_s, reduced into sum_s: each
  // thread's V sums to the partials [kg][column], then every output's KG
  // partials in group order by all threads; ends with a barrier
  auto product_sums = [&](int l, bool w, const float* x_s) {
    float acc[V];
    if (w)
      st.template product<WT>(Ws + (size_t)l * st.LH, x_s, acc);
    else
      st.template product<UT>(Us + (size_t)l * st.LH, x_s, acc);
    if (kg < KG) {
#pragma unroll
      for (int e = 0; e < V; ++e) part_s[(size_t)kg * GN + q * V + e] = acc[e];
    }
    __syncthreads();
    for (int o = tid; o < GN; o += kCtaThreads) {
      const float* p = part_s + o;
      float s = p[0];
#pragma unroll 4
      for (int k = 1; k < KG; ++k) s += p[(size_t)k * GN];
      sum_s[o] = s;
    }
    __syncthreads();
  };
  auto sums = [&](float (&out)[G]) {
#pragma unroll
    for (int g = 0; g < G; ++g) out[g] = sum_s[g * nu + cu];
  };

  cluster_arrive();  // this CTA has started (waited on before y_0 goes out)
  st.prologue();
  float hreg[kHeldH];
  load_h(0, hreg);
  store_h(hreg);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const size_t state = ((size_t)l * B + b) * H + u0 + cu;
    float xw[G] = {}, bias[G] = {}, hu[G] = {};
    float h_prev = 0.f, c_prev = 0.f;
    if (cell) {
      h_prev = hp_s[u0 + cu];
      if constexpr (Cell::kHasC) c_prev = c0[state];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const size_t j = (size_t)g * H + u0 + cu;
        if (l == 0)
          xw[g] = load_f32(xw0, (size_t)b * GH + j, x_bf16);
        else
          bias[g] = to_f32(bs[(size_t)l * GH + j]);
      }
    }
    if (l + 1 < L) load_h(l + 1, hreg);  // in flight during the products

    product_sums(l, false, hp_s);  // then part_s and hp_s are free
    if (cell) sums(hu);
    if (l + 1 < L) store_h(hreg);
    if (l > 0) {
      cluster_wait();  // y_(l-1) is in every CTA's y_s[(l - 1) & 1]
      product_sums(l, true, y_s + (size_t)((l - 1) & 1) * H);
      if (cell) {
        float aw[G];
        sums(aw);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (xw_bf16)
            xw[g] = round_bf16(round_bf16(aw[g]) + round_bf16(bias[g]));
          else
            xw[g] = aw[g] + bias[g];
        }
      }
    }
    if (l == 0) __syncthreads();  // h0[1] stored

    float y = 0.f;
    if (cell) {
      float c = 0.f;
      const float h = Cell::update(xw, hu, h_prev, c_prev, c);
      if (h_bf16) {
        const bf16 hb = __float2bfloat16_rn(h);
        y = __bfloat162float(hb);
        static_cast<bf16*>(hn)[state] = hb;
      } else {
        y = h;
        static_cast<float*>(hn)[state] = h;
      }
      if constexpr (Cell::kHasC) cn[state] = c;
    }
    if (l == 0) cluster_wait();  // every CTA of the cluster has started
    if (l + 1 < L) {
      float* dst = y_s + (size_t)(l & 1) * H + u0;
      if (V > 1) {
        // four adjacent units, gathered in each of their lanes, go out as
        // one vector store to each CTA, the four lanes taking the CTAs in
        // turn (slices align to 4 units, and nu is a multiple of 4)
        float y4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y4[e] = __shfl_sync(0xffffffffu, y, (tid & 31 & ~3) + e);
        if (cell) {
          const float4 v = make_float4(y4[0], y4[1], y4[2], y4[3]);
          for (int r = cu % 4; r < S; r += 4)
            *reinterpret_cast<float4*>(
                cluster.map_shared_rank(dst + (cu & ~3), r)) = v;
        }
      } else if (cell) {
        for (int r = 0; r < S; ++r) *cluster.map_shared_rank(dst + cu, r) = y;
      }
      cluster_arrive();  // y_l written by this thread
    }
  }
}

// ---------------------------------------------------------------------------
// host side

struct Args {
  const void *xw0, *Ws, *bs, *Us, *h0, *c0;
  void *hn, *cn;
  int L, B, H, w_bf16, u_bf16, x_bf16, h_bf16;
  cudaStream_t stream;
};

template <class Cell_, typename WT_, typename UT_, int V_>
struct Inst {
  typedef Cell_ Cell;
  typedef WT_ WT;
  typedef UT_ UT;
  static constexpr int V = V_;
  static auto kernel() { return cluster_kernel<Cell_, WT_, UT_, V_>; }
  // the ring; y (two buffers), h0, the sums and the partials
  static size_t smem(int H) {
    return Stream<WT_, UT_, V_>::kBytes
           + sizeof(float) * (3 * (size_t)H + (size_t)kCtaThreads * (V_ + 1));
  }
};

// The grid, cluster and shared memory of a launch; the instance's opt-ins
// (shared memory past 48 KB, a cluster of 16) once per instance.
template <class I>
cudaError_t configure(Config& c, const Args& a, int* splits_out) {
  static const cudaError_t opted = opt_in(I::kernel());
  if (opted != cudaSuccess) return opted;
  const int G = I::Cell::G;
  const int S = splits(a.H, G);
  const int A = unit_align(a.H), n = a.H / A;
  const int nu_max = (n + S - 1) / S * A;
  const size_t smem = I::smem(a.H);
  if (G * nu_max > kCtaThreads || smem > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  if (splits_out) *splits_out = S;
  c.set(dim3(S, a.B), kCtaThreads, smem, a.stream, S);
  return cudaSuccess;
}

struct LaunchOp {
  template <class I>
  cudaError_t run(const Args& a) const {
    Config c;
    cudaError_t err = configure<I>(c, a, nullptr);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(
        &c.cfg, I::kernel(), a.xw0, static_cast<const typename I::WT*>(a.Ws),
        static_cast<const typename I::WT*>(a.bs),
        static_cast<const typename I::UT*>(a.Us), a.h0,
        static_cast<const float*>(a.c0), a.hn, static_cast<float*>(a.cn),
        a.L, a.B, a.H, a.x_bf16, a.h_bf16);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
};

struct OccupancyOp {
  int* splits;
  int* clusters;
  template <class I>
  cudaError_t run(const Args& a) const {
    Config c;
    cudaError_t err = configure<I>(c, a, splits);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(clusters, I::kernel(), &c.cfg);
  }
};

// V from the slice alignment and the weights' types: one 16-byte load of
// 8 bf16 values where both W and U are bf16 and slices align to 8 units,
// else 4 values (8 or 16 bytes) where they align to 4, else plain loads.
template <class Cell, typename WT, typename UT, class Op>
cudaError_t by_vec(const Args& a, const Op& op) {
  const int A = unit_align(a.H);
  if constexpr (sizeof(WT) == 2 && sizeof(UT) == 2) {
    if (A == 8) return op.template run<Inst<Cell, WT, UT, 8>>(a);
  }
  if (A >= 4) return op.template run<Inst<Cell, WT, UT, 4>>(a);
  return op.template run<Inst<Cell, WT, UT, 1>>(a);
}

// The weight types (fp32 W with bf16 U is refused: the wrapper upcasts
// such a U) and the shape's limits.
template <class Cell, class Op>
cudaError_t dispatch(const Args& a, const Op& op) {
  if (a.L < 1 || a.B < 1 || a.H < 1 || a.H > kMaxH || a.B > 65535)
    return cudaErrorInvalidValue;
  if (a.w_bf16)
    return a.u_bf16 ? by_vec<Cell, bf16, bf16>(a, op)
                    : by_vec<Cell, bf16, float>(a, op);
  if (a.u_bf16) return cudaErrorInvalidValue;
  return by_vec<Cell, float, float>(a, op);
}

// The bodies of a kernel file's two C entry points: one launch; the
// cluster size S the kernel takes at H into *splits and how many of the
// instance's clusters at (B, H, weight types) can be resident on the card
// at once (cudaOccupancyMaxActiveClusters) into *clusters.  Both return
// the CUDA error (0 = ok); any error is a refused configuration (the
// launch itself runs asynchronously).
template <class Cell>
int launch(const Args& a) {
  return static_cast<int>(dispatch<Cell>(a, LaunchOp{}));
}

template <class Cell>
int occupancy(int B, int H, int w_bf16, int u_bf16, int* splits,
              int* clusters) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, 1, B, H, w_bf16, u_bf16, 0, 0, nullptr};
  return static_cast<int>(
      dispatch<Cell>(a, OccupancyOp{splits, clusters}));
}

}  // namespace
}  // namespace decode
