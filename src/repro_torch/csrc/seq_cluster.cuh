// The cluster design shared by the two sequence kernels (lstm_seq.cu,
// gru_seq.cu): G independent recurrences over T steps in ONE launch, each
// recurrence spread over the S CTAs of a thread-block cluster that keep
// their slices of U in shared memory for the whole walk.  A kernel file
// instantiates `seq_kernel` with its cell (rnn_common.cuh's LstmCell or
// GruCell) through `launch` and `query`.
//
// Shape of a launch.  The grid is S x ceil(B / R) x G: one cluster of S
// CTAs (cudaLaunchKernelEx, cluster dimension S along x) per (recurrence
// g, group of up to R = 4 batch rows; rnn::rows_per_block).  S comes from
// (H, gates) alone (cluster.cuh `splits`: 16 at H = 340, 1024 and 2048;
// mirrored in Python as kernels.common.seq_splits).  Clusters are
// independent: where the card holds fewer at once than a launch has, they
// run in waves.  A launch whose cluster the card cannot hold at all
// (cudaOccupancyMaxActiveClusters == 0) is refused before it is made.
//
// The split.  CTA `rank` owns the hidden units [u0, u0 + nu) (cluster.cuh
// `slice`) with all gate columns of each, so the cell update, the LSTM
// cell state, the GRU's coupling n = tanh(xw_n + r * hu_n), the int8
// scale and the mask freeze stay in the CTA.  Its 512 threads split the
// slice's C = gates * nu columns into Q vectors of V units (`vec_width`:
// 8 for bf16 and int8 U where slices align to 8 units, 4 where they align
// to 4, else 1, plain loads) and the Hr rows of U into KG = 512 / Q
// contiguous groups of KR rows; thread (kg, q) sums its rows of its
// vector for the CTA's R batch rows in fp32, in row order, and each
// output's KG partials are then added in group order.  The order depends
// on (H, gates, U's type, Hr) only -- never on B, G, the run or the split
// of T into launches.
//
// U resident.  At launch each thread copies its own first KRres rows of
// U (in U's stored type) into shared memory with cp.async, at ((kg *
// KRres + i) * Q + q) * V, and reads only those.  KRres is KR where the
// whole slice fits (H = 340 in any type: at most 131 KB a CTA in fp32);
// where it does not (H = 1024 and 2048), the rest of each thread's rows
// stream from L2 every step through its own cp.async ring (kRingBytes
// over the CTA), which runs ahead across steps while the CTA waits for h;
// with V = 1 the rest is read from global memory directly.  `plan` sizes
// both from (H, gates, U's element size, Hr) at R = 4, so the residency
// never depends on B.
//
// A step.  (1) wait for h_t (below); (2) the product of the thread's rows
// with h_t, read from the CTA's own fp32 copy ([H][R], so one load gives
// a row's R values); (3) the partials to shared memory, a CTA barrier,
// each output's partials added by one thread, a CTA barrier; (4) thread
// (unit, row) applies the int8 scale (__fmul_rn, before xw is added and
// before the GRU's r coupling), updates its cell with xw_t prefetched in
// registers, freezes a masked row, stores hs; (5) it sends h_(t+1) to
// every CTA with st.async stores (four values a vector store) that
// complete their bytes on that CTA's mbarrier for the buffer.
//
// The exchange.  h is double-buffered by step parity, an mbarrier a
// buffer whose phase expects the R * H * 4 bytes of every CTA's slice;
// a step waits only for its data, with no cluster barrier.  Thread 0 sets
// a buffer's next phase right after its wait; the data of that phase
// needs this CTA's own next push first, which follows the CTA barriers of
// the step, so no store can reach a phase before it is set, and no CTA
// writes a buffer before every CTA has read it (a CTA pushes h_(t+1) only
// after all of h_t arrived, which each CTA sent after reading h_(t-1)
// from the buffer h_(t+1) goes to).  The one cluster barrier, arrive at
// launch and wait before the first push, covers the mbarriers' init; the
// last step sends nothing, so every CTA has received all its data when it
// exits.  The next phase's data also needs every cell thread's push, so
// it orders a step's reads of the sums before the next step's partials.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

#include "cluster.cuh"
#include "rnn_common.cuh"

namespace seq {
// internal linkage: the function-local statics below (the per-instance
// opt-ins and occupancy answers) stay each library's own
namespace {

namespace cg = cooperative_groups;
using namespace cluster;
using namespace rnn;

constexpr int kThreads = 512;
constexpr int kRows = 4;  // batch rows a cluster carries at most
// the per-thread rings of a CTA that streams part of its slice
constexpr int kRingBytes = 64 * 1024;

// Units a thread's column vector holds: 8 (one 16-byte load of bf16, 8
// bytes of int8) where slices align to 8 and U has 1- or 2-byte elements,
// else 4 where they align to 4, else 1 (plain loads).
__host__ __device__ inline int vec_width(int H, int esize) {
  const int A = unit_align(H);
  return A == 8 && esize <= 2 ? 8 : (A >= 4 ? 4 : 1);
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// One CTA's threads over its slice (see the header).
struct Layout {
  int u0, nu, Q, KG, KR;
};

__host__ __device__ inline Layout layout(int H, int gates, int esize,
                                         int Hr, int S, int rank) {
  const Slice sl = slice(H, S, rank);
  const int Q = gates * sl.nu / vec_width(H, esize);
  const int KG = kThreads / Q;
  return Layout{sl.u0, sl.nu, Q, KG, (Hr + KG - 1) / KG};
}

// Shared memory of everything but U: the two h buffers' mbarriers, the
// rows index of a compacted U, the two h buffers and the partials, all at
// R = kRows.
__host__ __device__ inline size_t fixed_bytes(int H, int esize, int Hr) {
  return 16 + align16(sizeof(int) * (size_t)Hr)
         + sizeof(float) * (2 * (size_t)kRows * H
                            + (size_t)kThreads * kRows * vec_width(H, esize));
}

// Bytes of resident U that one row index i takes across a CTA's threads.
__host__ __device__ inline size_t row_bytes(const Layout& l, int V,
                                            int esize) {
  return (size_t)l.KG * l.Q * V * esize;
}

struct Plan {
  int S;
  int ring;       // bytes of the CTA's rings (0: the whole slice resident)
  size_t budget;  // bytes of resident U a CTA holds at most
  size_t smem;    // ring + fixed_bytes + budget
};

// The cluster size, the rings and the residency from (H, gates, U's
// element size, Hr) alone: the whole slice resident where every rank's
// fits beside the fixed part, else a ring (V > 1) and as many leading rows
// of each thread as the rest of the card's 227 KB holds.
inline Plan plan(int H, int gates, int esize, int Hr) {
  Plan p{splits(H, gates), 0, 0, 0};
  const int V = vec_width(H, esize);
  const size_t fixed = fixed_bytes(H, esize, Hr);
  size_t full = 0;
  for (int r = 0; r < p.S; ++r) {
    const Layout l = layout(H, gates, esize, Hr, p.S, r);
    full = std::max(full, (size_t)l.KR * row_bytes(l, V, esize));
  }
  if (fixed + full <= (size_t)kMaxSmem) {
    p.budget = full;
  } else {
    p.ring = V > 1 ? kRingBytes : 0;
    const size_t room = (size_t)kMaxSmem - std::min(
        (size_t)kMaxSmem, fixed + p.ring);
    for (int r = 0; r < p.S; ++r) {
      const Layout l = layout(H, gates, esize, Hr, p.S, r);
      const size_t rb = row_bytes(l, V, esize);
      p.budget = std::max(p.budget,
                          std::min((size_t)l.KR, room / rb) * rb);
    }
  }
  p.smem = p.ring + fixed + p.budget;
  return p;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// V adjacent elements of U copied into shared memory: one cp.async where
// they make 4, 8 or 16 bytes, else a plain load and store.
template <typename UT, int V>
__device__ __forceinline__ void copy_in(UT* dst, const UT* src) {
  if constexpr (V * sizeof(UT) >= 4)
    cp_async<V * (int)sizeof(UT)>(smem_u32(dst), src);
  else
    *dst = *src;
}

// R fp32 values at p (the R batch rows of one unit of h).
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float (&h)[R]) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
  } else if constexpr (R == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    h[0] = v.x; h[1] = v.y;
  } else {
    h[0] = p[0];
  }
}

__device__ __forceinline__ void store_f32(void* p, size_t i, float v,
                                          int bf) {
  if (bf)
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// V adjacent elements of U as fp32 (V = 8: bf16 or int8), from an address
// aligned to their size (shared memory: a resident row or a ring slot).
template <int V, typename UT>
__device__ __forceinline__ void load_vec(const UT* p, float (&w)[V]) {
  if constexpr (V == 8 && sizeof(UT) == 1) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const char4 a = *reinterpret_cast<const char4*>(&v.x);
    const char4 b = *reinterpret_cast<const char4*>(&v.y);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else if constexpr (V == 8) {
    load8(reinterpret_cast<const bf16*>(p), w);
  } else {
    loadv<V>(p, w);
  }
}

// One thread's stream of the rows of U it does not hold: n rows a step
// (the same rows every step), V elements a row, through its own lane of a
// ring of STAGES slots.  Each issue commits one cp.async group (an empty
// one past the last step keeps the count), and a thread reads only the
// slots it filled, so the ring needs no barrier.
template <typename UT, int V>
struct Ring {
  static constexpr int SLOT = V * (int)sizeof(UT);
  static constexpr int STAGES = kRingBytes / (kThreads * SLOT);
  static constexpr unsigned STEP = kThreads * SLOT;  // slot to slot
  static constexpr unsigned MASK = kRingBytes - 1;
  static constexpr int kUnroll = STAGES >= 16 ? 4 : 2;  // rows a wait

  const char* first;  // the thread's first streamed row
  size_t stride;      // a row of U in bytes
  int n, i;           // rows a step; the next row to issue
  long long left;     // rows still to issue in the launch
  unsigned ring_s, w_off, r_off;
  const unsigned char* ring_g;

  __device__ void init(unsigned char* ring, const UT* first_, size_t ld,
                       int n_, int T) {
    first = reinterpret_cast<const char*>(first_);
    stride = ld * sizeof(UT);
    n = n_;
    i = 0;
    left = (long long)T * n_;
    ring_g = ring + threadIdx.x * SLOT;
    ring_s = smem_u32(ring_g);
    w_off = r_off = 0;
  }

  __device__ void issue() {
    if (left > 0) {
      cp_async<SLOT>(ring_s + w_off, first + (size_t)i * stride);
      if (++i == n) i = 0;
      --left;
    }
    cp_async_commit();
    w_off = (w_off + STEP) & MASK;
  }

  // the first rows, before the walk: kUnroll slots stay free for the
  // first wait's issues
  __device__ void prologue() {
#pragma unroll 1
    for (int s = 0; s < STAGES - kUnroll; ++s) issue();
  }

  // f(j, w) for this step's rows j = 0 .. n - 1 in order; kUnroll rows
  // share one wait, so their loads and FMAs interleave
  template <class F>
  __device__ void consume(F&& f) {
    auto one = [&](int j) {
      float w[V];
      load_vec<V>(reinterpret_cast<const UT*>(ring_g + r_off), w);
      r_off = (r_off + STEP) & MASK;
      f(j, w);
    };
    int j = 0;
    for (; j + kUnroll <= n; j += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) issue();
      cp_async_wait<STAGES - kUnroll>();
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) one(j + u);
    }
    for (; j < n; ++j) {
      issue();
      cp_async_wait<STAGES - kUnroll>();
      one(j);
    }
  }
};

// The h exchange: an mbarrier per h buffer, whose transaction count is
// the bytes every CTA's slice brings (st.async completes them).
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// acquire at cluster scope: the other CTAs' st.async data is visible
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// the address of the same shared variable in CTA `rank` of the cluster
__device__ __forceinline__ unsigned mapa(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_async(unsigned addr, float4 v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

template <class Cell, typename UT, int R, int V>
__global__ void __launch_bounds__(kThreads, 1)
seq_kernel(const UT* __restrict__ U, const float* __restrict__ scales,
           const int* __restrict__ rows, const void* __restrict__ xw,
           const void* __restrict__ h0, const float* __restrict__ c0,
           const int* __restrict__ mask, void* __restrict__ hs,
           void* __restrict__ hT, float* __restrict__ cT, int B, int T,
           int H, int Hr, int x_bf16, int h_bf16, int ring_bytes,
           int budget) {
  constexpr int G = Cell::G;
  constexpr int ES = sizeof(UT);
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ring_bytes);  // [2]
  int* rows_s = reinterpret_cast<int*>(bars + 2);
  float* h_s = reinterpret_cast<float*>(
      smem + ring_bytes + 16 + align16(sizeof(int) * (size_t)Hr));  // [2][H][R]
  // [KG][V][Q][R], column q * V + e at (e, q); the sums in group 0's place
  float* part_s = h_s + 2 * kRows * H;
  UT* res_s = reinterpret_cast<UT*>(part_s + kThreads * kRows * V);

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int g = blockIdx.z;
  const int b0 = blockIdx.y * R;
  const int nrows = min(R, B - b0);
  const size_t row0 = (size_t)g * B + b0;  // the cluster's first (g, b) row
  const Layout ly = layout(H, G, ES, Hr, S, rank);
  const int u0 = ly.u0, nu = ly.nu, Q = ly.Q, KG = ly.KG, KR = ly.KR;
  const int C = G * nu, cpg = nu / V;
  const int q = tid % Q, kg = tid / Q;
  const int k_lo = min(Hr, kg * KR);
  const int J = kg < KG ? min(Hr, k_lo + KR) - k_lo : 0;
  const int KRres = min(KR, (int)(budget / row_bytes(ly, V, ES)));
  const int Jr = min(J, KRres);
  const size_t ld = (size_t)G * H;
  const UT* Ug = U + (size_t)g * Hr * ld;
  const size_t col = (size_t)(q / cpg) * H + u0 + (q % cpg) * V;
  const bool streaming = ring_bytes > 0;
  // the bytes one step's h brings into each CTA: every CTA's slice
  const unsigned h_bytes = sizeof(float) * R * H;

  if (tid == 0) {
    mbar_init(smem_u32(bars));
    mbar_init(smem_u32(bars + 1));
    // h_1 (pushed at step 0) into buffer 1, h_2 into buffer 0
    if (T > 1) mbar_expect(smem_u32(bars + 1), h_bytes);
    if (T > 2) mbar_expect(smem_u32(bars), h_bytes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this CTA has started and its mbarriers are set (waited on before the
  // first push)
  cluster_arrive();

  // the thread's resident rows, each copied by the thread that reads it
  UT* res_t = res_s + ((size_t)kg * KRres * Q + q) * V;
  for (int i = 0; i < Jr; ++i)
    copy_in<UT, V>(res_t + (size_t)i * Q * V, Ug + (size_t)(k_lo + i) * ld + col);
  cp_async_commit();
  Ring<UT, V> ring;
  if constexpr (V > 1) {
    if (streaming) {
      ring.init(smem, Ug + (size_t)(k_lo + Jr) * ld + col, ld, J - Jr, T);
      ring.prologue();
    }
  }
  if (rows != nullptr)
    for (int k = tid; k < Hr; k += kThreads) rows_s[k] = rows[(size_t)g * Hr + k];
  for (int i = tid; i < H * R; i += kThreads) {
    const int k = i / R, r = i % R;
    h_s[i] = r < nrows ? load_f32(h0, (row0 + r) * H + k, h_bf16) : 0.f;
  }

  // the (unit, row) this thread updates; rows past B stay zero and are
  // never stored
  const int ci = tid;
  const bool cell = ci < R * nu;
  const int cu = cell ? ci / R : 0, cr = ci % R;
  const bool live = cell && cr < nrows;
  const size_t crow = row0 + cr;
  const size_t state = crow * H + u0 + cu;
  const bool keep = live && (mask == nullptr || mask[crow] != 0);
  float h_prev = 0.f, c_prev = 0.f, sc[G], xr[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    sc[j] = scales != nullptr ? scales[(size_t)g * G + j] : 1.f;
    xr[j] = 0.f;
  }
  auto load_x = [&](int t) {
#pragma unroll
    for (int j = 0; j < G; ++j)
      xr[j] = load_f32(xw, ((crow * T + t) * G + j) * H + u0 + cu, x_bf16);
  };
  if (live) {
    h_prev = load_f32(h0, state, h_bf16);
    if constexpr (Cell::kHasC) c_prev = c0[state];
    load_x(0);
  }
  // pushes of four adjacent (unit, row) values as one vector store
  const bool vec4 = (unit_align(H) * R) % 4 == 0;

  if (streaming) {
    if constexpr (V > 1)
      cp_async_wait<Ring<UT, V>::STAGES - Ring<UT, V>::kUnroll>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // acc[r][e] = sum over the thread's rows k of h[k][r] * U[k][col + e]
  auto product = [&](auto sparse, const float* hb, float (&acc)[R][V]) {
    constexpr bool SP = decltype(sparse)::value;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
    auto row = [&](int k, const float (&w)[V]) {
      float h[R];
      load_rows<R>(hb + (size_t)(SP ? rows_s[k] : k) * R, h);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] = fmaf(h[r], w[e], acc[r][e]);
    };
#pragma unroll 4
    for (int i = 0; i < Jr; ++i) {
      float w[V];
      load_vec<V>(res_t + (size_t)i * Q * V, w);
      row(k_lo + i, w);
    }
    if constexpr (V > 1) {
      if (streaming)
        ring.consume([&](int j, const float (&w)[V]) { row(k_lo + Jr + j, w); });
    } else {
      const UT* p = Ug + (size_t)(k_lo + Jr) * ld + col;
#pragma unroll 4
      for (int i = Jr; i < J; ++i, p += ld) {
        const float w[1] = {to_f32(*p)};
        row(k_lo + i, w);
      }
    }
  };

  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
    if (t > 0) {
      // h_t from every CTA (the buffer's phase (t - 1) / 2); thread 0 then
      // sets the buffer's next phase, whose data needs this CTA's push of
      // step t + 1 first
      mbar_wait(smem_u32(bars + p), ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 2 < T) mbar_expect(smem_u32(bars + p), h_bytes);
    }
    const float* hb = h_s + (size_t)p * kRows * H;
    float acc[R][V];
    if (rows != nullptr)
      product(std::true_type{}, hb, acc);
    else
      product(std::false_type{}, hb, acc);
    if (kg < KG) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float* pp = part_s + (((size_t)kg * V + e) * Q + q) * R;
        if constexpr (R == 4)
          *reinterpret_cast<float4*>(pp) =
              make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
        else if constexpr (R == 2)
          *reinterpret_cast<float2*>(pp) = make_float2(acc[0][e], acc[1][e]);
        else
          pp[0] = acc[0][e];
      }
    }
    __syncthreads();
    // each (column, row)'s KG partials in group order, the sum in place of
    // group 0's partial (C * R outputs, the layout's order)
    for (int o = tid; o < C * R; o += kThreads) {
      const float* pp = part_s + o;
      float sum = pp[0];
      for (int k = 1; k < KG; ++k) sum += pp[(size_t)k * C * R];
      part_s[o] = sum;
    }
    __syncthreads();

    if (cell) {
      float hu[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int c = j * nu + cu;
        hu[j] = part_s[((size_t)(c % V) * Q + c / V) * R + cr];
        if (scales != nullptr) hu[j] = __fmul_rn(hu[j], sc[j]);
      }
      float c_new = 0.f;
      const float h_new = Cell::update(xr, hu, h_prev, c_prev, c_new);
      if (keep) {
        h_prev = h_new;
        c_prev = c_new;
      }
      if (live) {
        store_f32(hs, (crow * T + t) * H + u0 + cu, h_prev, h_bf16);
        if (t + 1 < T) load_x(t + 1);
      }
    }
    if (t == 0) cluster_wait();  // every CTA has started, its mbarriers set
    if (t + 1 < T) {
      // h_(t+1) into buffer p ^ 1 of every CTA, each store completing its
      // bytes on that CTA's mbarrier
      const unsigned dst = smem_u32(h_s + (size_t)(p ^ 1) * kRows * H
                                    + (size_t)u0 * R);
      const unsigned bar = smem_u32(bars + (p ^ 1));
      if (vec4) {
        // four adjacent values of the slice, gathered in each of their
        // lanes, go out as one vector store to each CTA, the four lanes
        // taking the CTAs in turn
        float y4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y4[e] = __shfl_sync(0xffffffffu, h_prev, (tid & 31 & ~3) + e);
        if (cell) {
          const float4 v = make_float4(y4[0], y4[1], y4[2], y4[3]);
          const unsigned at = dst + sizeof(float) * (ci & ~3);
          for (int d = ci % 4; d < S; d += 4)
            st_async(mapa(at, d), v, mapa(bar, d));
        }
      } else if (cell) {
        const unsigned at = dst + sizeof(float) * ci;
        for (int d = 0; d < S; ++d) st_async(mapa(at, d), h_prev, mapa(bar, d));
      }
    }
  }

  if (live) {
    store_f32(hT, state, h_prev, h_bf16);
    if constexpr (Cell::kHasC) cT[state] = c_prev;
  }
}

// ---------------------------------------------------------------------------
// host side

struct Args {
  const void* U;
  const float* scales;
  const int* rows;
  const void *xw, *h0;
  const float* c0;
  const int* mask;
  void *hs, *hT;
  float* cT;
  int G, B, T, H, Hr, u_type, x_bf16, h_bf16;
  cudaStream_t stream;
};

// What `query` reports of a launch: its cluster size, rows a cluster,
// ring bytes (0: U resident), shared memory a CTA, clusters the card
// holds at once.
struct Shape {
  int S, R, ring, smem, clusters;
};

template <class Cell, typename UT, int R, int V>
struct Inst {
  static auto kernel() { return seq_kernel<Cell, UT, R, V>; }

  // the instance's opt-ins once; the card's answer to
  // cudaOccupancyMaxActiveClusters once per (S, shared memory)
  static cudaError_t configure(Config& c, const Args& a, const Plan& p,
                               int* clusters) {
    static const cudaError_t opted = opt_in(kernel());
    if (opted != cudaSuccess) return opted;
    c.set(dim3(p.S, (a.B + R - 1) / R, a.G), kThreads, p.smem, a.stream,
          p.S);
    static std::mutex m;
    static int seen_S = 0, seen_n = 0;
    static size_t seen_smem = 0;
    std::lock_guard<std::mutex> lock(m);
    if (seen_S != p.S || seen_smem != p.smem) {
      int n = 0;
      const cudaError_t e =
          cudaOccupancyMaxActiveClusters(&n, kernel(), &c.cfg);
      if (e != cudaSuccess) return e;
      seen_S = p.S;
      seen_smem = p.smem;
      seen_n = n;
    }
    *clusters = seen_n;
    return cudaSuccess;
  }

  static cudaError_t run(const Args& a, const Plan& p, Shape* shape) {
    Config c;
    int clusters = 0;
    cudaError_t err = configure(c, a, p, &clusters);
    if (err != cudaSuccess) return err;
    if (shape) {
      *shape = Shape{p.S, R, p.ring, (int)p.smem, clusters};
      return cudaSuccess;
    }
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    err = cudaLaunchKernelEx(
        &c.cfg, kernel(), static_cast<const UT*>(a.U), a.scales, a.rows,
        a.xw, a.h0, a.c0, a.mask, a.hs, a.hT, a.cT, a.B, a.T, a.H, a.Hr,
        a.x_bf16, a.h_bf16, p.ring, (int)p.budget);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
};

template <class Cell, typename UT, int V>
cudaError_t by_rows(const Args& a, const Plan& p, Shape* shape) {
  switch (rows_per_block(a.B)) {
    case 1: return Inst<Cell, UT, 1, V>::run(a, p, shape);
    case 2: return Inst<Cell, UT, 2, V>::run(a, p, shape);
    default: return Inst<Cell, UT, 4, V>::run(a, p, shape);
  }
}

template <class Cell, typename UT>
cudaError_t by_vec(const Args& a, Shape* shape) {
  const Plan p = plan(a.H, Cell::G, sizeof(UT), a.Hr);
  if (p.smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  switch (vec_width(a.H, sizeof(UT))) {
    case 8:
      if constexpr (sizeof(UT) <= 2) return by_rows<Cell, UT, 8>(a, p, shape);
      return cudaErrorInvalidValue;
    case 4: return by_rows<Cell, UT, 4>(a, p, shape);
    default: return by_rows<Cell, UT, 1>(a, p, shape);
  }
}

// The shape's limits, then U's type: 0 fp32, 1 bf16, 2 int8.
template <class Cell>
cudaError_t dispatch(const Args& a, Shape* shape) {
  if (a.G < 1 || a.G > 65535 || a.B < 1 || (a.B + 3) / 4 > 65535
      || a.T < 1 || a.H < 1 || a.H > kMaxH || a.Hr < 0 || a.Hr > a.H)
    return cudaErrorInvalidValue;
  switch (a.u_type) {
    case 0: return by_vec<Cell, float>(a, shape);
    case 1: return by_vec<Cell, bf16>(a, shape);
    case 2: return by_vec<Cell, int8_t>(a, shape);
    default: return cudaErrorInvalidValue;
  }
}

// The bodies of a kernel file's two C entry points: one launch, and the
// launch's Shape (nothing launched).  Both return the CUDA error (0 =
// ok); any error is a refused configuration (the launch itself runs
// asynchronously).
template <class Cell>
int launch(const Args& a) {
  return static_cast<int>(dispatch<Cell>(a, nullptr));
}

template <class Cell>
int query(int B, int H, int Hr, int u_type, int* out) {
  Args a{};
  a.G = 1;
  a.B = B;
  a.T = 1;
  a.H = H;
  a.Hr = Hr;
  a.u_type = u_type;
  Shape s{};
  const cudaError_t e = dispatch<Cell>(a, &s);
  out[0] = s.S;
  out[1] = s.R;
  out[2] = s.ring;
  out[3] = s.smem;
  out[4] = s.clusters;
  return static_cast<int>(e);
}

}  // namespace
}  // namespace seq
