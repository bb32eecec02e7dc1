// decode_attention: one query token per sequence against its KV cache
// (single-query GQA flash-decode with a per-row count of live slots).
//
// Replaces the TPU kernel decode_attention_pallas / _kernel
// (src/repro/kernels/decode_attention/kernel.py:63 / :26).  Same function:
// q (B, Hq, D), caches (B, T, Hk, D), valid (B,) int32; query head
// h * G + g (G = Hq / Hk) attends to kv head h.  Everything in fp32
// (kernel.py:44-62): s = q . k / sqrt(D), slots at or past valid masked to
// NEG_INF = -1e30, softmax statistics (m, l) and p . v in fp32 with p kept
// in fp32; the output is acc / max(l, 1e-30), rounded to q's dtype.  A
// valid below 1 masks every slot, so p = 1 everywhere and the output is
// the average of v over all T slots, as the Pallas kernel computes it.
//
// What bounds it on an H100: bytes.  Each (b, kv head) needs its live keys
// and values once, and each live slot 4 G D operations: at B = 4, T = 2048,
// Hk = 1, D = 256 bf16 a full ring is 8.4 MB, 0.0025 ms at 3.35 TB/s.
//
// The design: split-T over a thread-block cluster, all query heads of a kv
// head in one CTA, one launch.
//  - The grid is (S CTAs) x (kv heads x groups of <= 16 query heads) x
//    (rows); the S CTAs of one (row, kv head) form one cluster
//    (cudaLaunchKernelEx with a cluster dimension of S along x).  S comes
//    from T alone (kernels/decode_attention/ops.py splits(): the largest of
//    1, 2, 4, 8, 16 that leaves every CTA two tiles of a full ring), never
//    from B or valid; S = 16 is a non-portable cluster size, opted in per
//    instance.
//  - The ring is read in tiles of 32 slots, and CTA r takes tiles r,
//    r + S, r + 2 S, ... for all G query heads of its kv head: K and V
//    cross HBM once per launch, not G times, and a ring of ~70 live slots
//    is spread over three CTAs, not left to one.  Tiles that begin at or
//    past valid are not read, and in the last live tile only the slots
//    below valid are (valid < 1 reads every tile).
//  - A CTA streams its tiles through a ring of 2-4 stages in shared memory
//    (cp.async, 16-byte pieces, all of a full ring's tiles in flight at
//    once for bf16 D = 256; rows padded by 16 bytes so that neighbouring
//    rows fall on other banks; plain loads for a D that is not a multiple
//    of the 16-byte vector), and keeps a running (m, l) per head and its
//    acc in fp32.  Per step: (1) the partial dots q . k of every head and
//    slot; (2) a warp per head (lane = slot) takes the step's max and
//    exp-sum by shuffles and updates (m, l); (3) acc = acc * alpha + p v.
//  - bf16 q and caches with D % 16 == 0, the model's path, take the
//    tensor cores (mma.sync m16n8k16, fp32 accumulation), two tiles a step:
//    (1) 16 head rows (the G = 10 heads and zero rows) by 8 slots a warp
//    over half of D, the two halves added in order; (3) the 16 head rows
//    of p by 8 columns of v a warp, over the step's slots.  p stays fp32:
//    it enters (3) as three bf16 planes whose sum is p exactly (8 + 8 + 8
//    bits of its 24-bit significand), each plane's products exact in fp32.
//    The products of bf16 q and k are exact in fp32 as well, so the tensor
//    cores change only the order and grouping of the fp32 sums.  (wgmma,
//    whose M is 64, would pad the 10 heads to 84%; mma.sync's M of 16 pads
//    them to 37.5%.)
//  - Every other instance (fp32 q or caches, a D that is not a multiple of
//    16) takes the CUDA cores, a tile a step: (1) the 16 warps split D, a
//    lane per slot, and the 16 partial dots are added in warp order; (3)
//    D / 4 column threads times the remaining slot groups, 4 columns and
//    every head a thread, the groups' sums added in group order at the end.
//  - The merge runs inside the launch, through distributed shared memory:
//    each CTA that read a tile stores its (m, l) into every CTA of the
//    cluster; after cluster.sync() each computes the weights exp(m_r -
//    m_row) and l = sum_r l_r w_r by shuffle trees over the ranks, and
//    stores its acc, times its weight, into the receive buffer of the CTA
//    that owns those outputs; after a second cluster.sync() each CTA adds
//    its outputs' S contributions in rank order and divides by l.  A CTA
//    that read no tile never enters the merge (its m would be -1e30 and
//    its l its tile count).  No CTA reads another's memory after the
//    second barrier, no atomics, no scratch in device memory, no second
//    launch.
//  - Every output's order of summation depends on (T, D) and the row's own
//    valid only, never on B or on the run: two runs are bit-equal, and a
//    row of a B = 4 call equals the same row at B = 1 bit for bit.
//  - The (m, l) form (a non-null ml): for a ring sharded over T across
//    ranks, which combine their slices' outputs.  The kernel then also
//    writes each head's softmax statistics, m (the max of its live
//    scores) and l (sum of exp(s - m)), the merge's own m_row and l, into
//    ml (B, Hq) as float2, and its output o in fp32, unrounded, into out.
//    A row with no live slot (valid < 1) gives the combine's identity,
//    o = 0, m = -inf, l = 0, where the plain form averages v.

#include <cooperative_groups.h>

#include "rnn_common.cuh"

namespace cg = cooperative_groups;

namespace dattn {
// internal linkage: the function-local statics below (the per-instance
// opt-ins) stay this library's own
namespace {

using namespace rnn;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // slots per tile: a lane each in (2)
constexpr int kHeads = 16;           // query heads per CTA at most
static_assert(kWarps >= kHeads, "(2) takes a warp per head");
constexpr int kPStride = kHeads + 4; // a slot's p of every head, padded
constexpr int kPRow = 2 * kTile + 8; // a head's p of a step's slots, padded
constexpr int kMaxSplits = 16;
constexpr int kMaxStages = 4;
// the ring's target size: 4 stages (a full ring's 4 tiles a CTA, and the
// two-tile steps' prefetch) for bf16 up to D = 256
constexpr int kRingBytes = 136 * 1024;
constexpr int kMaxSmem = 232448;       // what an H100 block may opt in to
constexpr float kNegInf = -1e30f;

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

// PW adjacent fp32 values in shared memory: one 16-byte access for PW = 4
// (16-byte aligned), a scalar one for PW = 1
template <int PW>
__device__ __forceinline__ void store_pw(float* p, const float* x) {
  if constexpr (PW == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    p[0] = x[0];
}
template <int PW>
__device__ __forceinline__ void load_pw(const float* p, float* x) {
  if constexpr (PW == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
  } else {
    x[0] = p[0];
  }
}

// D (16 x 8, fp32) += A (16 x 16, bf16, row-major) . B (16 x 8, bf16,
// column-major): one warp's mma.sync; a, b, d in the PTX fragment layout
// (thread t holds rows t / 4 and t / 4 + 8, columns 2 (t % 4) + {0, 1}
// and + 8 of A; rows 2 (t % 4) + {0, 1} and + 8, column t / 4 of B)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: thread i gives
// the address of row i % 8 of matrix i / 8 (16 bytes each); thread t gets
// element (2 (t % 4) + {0, 1}, t / 4) of each, packed in r[0 .. 3]
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Bytes of one cached row (D elements) in the ring: padded to 16 bytes,
// plus 16 so that consecutive rows start on other banks.
__host__ __device__ inline int row_bytes(int D, int elt) {
  return (D * elt + 15) / 16 * 16 + 16;
}

// The ring's stages: as many as fit in kRingBytes, 2 to kMaxStages.
__host__ __device__ inline int ring_stages(int D, int elt) {
  const int stage = 2 * kTile * row_bytes(D, elt);  // K and V tiles
  const int n = kRingBytes / stage;
  return n < 2 ? 2 : (n > kMaxStages ? kMaxStages : n);
}

// (3)'s layout: D / pw column threads (pw columns each) times the slot
// groups that fill the CTA
__host__ __device__ inline int slot_groups(int D, int pw) {
  return kThreads / (D / pw);
}

// Byte offsets of the CTA's dynamic shared memory; every one a multiple
// of 16.  The ring's region also holds, after the last tile, every slot
// group's partial acc; the tile's partial dots and, after the last tile,
// the CTA's acc share one region.
struct Smem {
  int q, acc, p, stats, bytes;
};
__host__ __device__ inline Smem smem_layout(int D, int elt, int pw,
                                            bool mma) {
  Smem s;
  const int ring = ring_stages(D, elt) * 2 * kTile * row_bytes(D, elt);
  // the slot groups' partial acc, then the pushes of the merge
  const int parts = mma ? 0 : slot_groups(D, pw) * kHeads * D * 4;
  const int recv = (kHeads * D + kMaxSplits * pw) * 4;
  int off = ring > parts ? ring : parts;
  off = off > recv ? off : recv;
  s.q = off;                  // [kHeads][D] fp32, MMA [kHeads][D + 8] bf16
  off += mma ? kHeads * (D + 8) * 2 : kHeads * D * 4;
  s.acc = off;                                // [partials][kHeads][slots]
  const int red = (mma ? 2 * 2 : kWarps) * kHeads * kTile;  // or [kHeads][D]
  off += (red > kHeads * D ? red : kHeads * D) * 4;
  s.p = off;                                  // [kTile][kPStride] fp32
  const int pf = kTile * kPStride * 4;        //   or 3 x [kHeads][kPRow]
  const int pb = 3 * kHeads * kPRow * 2;      //   bf16
  off += pf > pb ? pf : pb;
  s.stats = off;               // (m, l), every CTA's, alpha, den, w
  off += (2 + 2 * kMaxSplits + 2 + kMaxSplits) * kHeads * 4;
  s.bytes = off;
  return s;
}

// NH: the query heads of the instance, the CTA's ng <= NH rounded up to a
// multiple of 4; heads ng .. NH-1 are zero queries whose outputs are not
// written, so no loop over heads branches.  MMA: q . k and p . v on the
// tensor cores (bf16 q and caches, D % 16 == 0; NH = 16), else on the
// CUDA cores.
template <typename QT, typename KT, int VEC, int NH, bool MMA>
__global__ void __launch_bounds__(kThreads, 1)
attn_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
            const KT* __restrict__ v, const int* __restrict__ valid,
            QT* __restrict__ out, float2* __restrict__ ml, int T, int Hk,
            int G, int D) {
  constexpr int PW = VEC > 1 ? 4 : 1;  // columns per thread in (3)
  static_assert(!MMA || (kWarps == 16 && kHeads == 16 && kTile == 32),
                "the tensor-core layout: 2 x 8 warps of 8 slots, 16 rows");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int HG = (G + kHeads - 1) / kHeads;
  const int h = blockIdx.y / HG, g0 = (blockIdx.y % HG) * kHeads;
  const int ng = min(kHeads, G - g0);
  const int b = blockIdx.z;
  const int Hq = Hk * G;
  const int stages = ring_stages(D, sizeof(KT));
  const int rs = row_bytes(D, sizeof(KT));
  const Smem L = smem_layout(D, sizeof(KT), PW, MMA);
  // after the last tile: the slot groups' partial acc, then the pushes
  float* part_s = reinterpret_cast<float*>(smem);
  float* recv_s = part_s;
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* red_s = reinterpret_cast<float*>(smem + L.acc);
  float* acc_s = red_s;
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float2* ml_s = reinterpret_cast<float2*>(smem + L.stats);  // (m, l)
  float2* mlx_s = ml_s + kHeads;  // [kMaxSplits][kHeads]: every CTA's
  float* alpha_s = reinterpret_cast<float*>(mlx_s + kMaxSplits * kHeads);
  float* den_s = alpha_s + kHeads;
  float* w_s = den_s + kHeads;  // [kHeads][kMaxSplits]
  bf16* pb_s = reinterpret_cast<bf16*>(smem + L.p);  // [3][kHeads][kPRow]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;  // the mma fragments' indices
  // MMA: a step takes two of the CTA's tiles (64 slots); else one
  constexpr int TPS = MMA ? 2 : 1;
  // MMA (1): warp = (half kq of D, block nb of 8 slots of tile tsel); its
  // k steps of 16 columns [ks_lo, ks_hi)
  const int kq = warp / 8, tsel = warp % 8 / 4, nb = warp % 4;
  const int KS = D / 16;
  const int ks_lo = kq * KS / 2, ks_hi = (kq + 1) * KS / 2;

  // this CTA's queries in registers first (their loads in flight with
  // valid's), staged in shared memory after the ring's first stages went
  // out; heads ng .. NH-1 are zeros
  constexpr int kQPer = MMA ? 1 : (NH * 256 + kThreads - 1) / kThreads;
  const QT* qb = q + ((size_t)b * Hq + (size_t)h * G + g0) * D;
  float qv[kQPer];
  uint4 q16;  // MMA: one 16-byte piece of this CTA's queries (bf16)
  bf16* qb_s = reinterpret_cast<bf16*>(smem + L.q);  // MMA: [kHeads][D + 8]
  const int qpieces = D / 8;  // MMA: 16-byte pieces of a query row
  if constexpr (MMA) {
    // kHeads x D / 8 <= kThreads pieces: at most one a thread
    const int r = threadIdx.x / qpieces;
    q16 = r < ng ? *reinterpret_cast<const uint4*>(
                       qb + r * D + threadIdx.x % qpieces * 8)
                 : make_uint4(0u, 0u, 0u, 0u);
  } else {
#pragma unroll
    for (int u = 0; u < kQPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      qv[u] = i < ng * D ? to_f32(qb[i]) : 0.f;
    }
  }
  const int vb = valid[b];
  // the (m, l) form's identity for a row with no live slot; every CTA of
  // the cluster (one row) returns here, before the first cluster barrier
  float* out32 = reinterpret_cast<float*>(out) +
                 ((size_t)b * Hq + (size_t)h * G + g0) * D;
  float2* mlb =
      ml == nullptr ? nullptr : ml + (size_t)b * Hq + (size_t)h * G + g0;
  if (ml != nullptr && vb < 1) {
    if (split == 0) {
      for (int i = threadIdx.x; i < ng * D; i += kThreads) out32[i] = 0.f;
      for (int g = threadIdx.x; g < ng; g += kThreads)
        mlb[g] = make_float2(-__int_as_float(0x7f800000), 0.f);
    }
    return;
  }
  const bool all_masked = vb < 1;
  const int vlim = all_masked ? T : min(vb, T);  // slots to read
  // this CTA's tiles of the ring: split, split + S, split + 2 S, ... of
  // the ceil(vlim / kTile) tiles that hold a slot to read
  const int n_tiles = max(0, ((vlim + kTile - 1) / kTile - split + S - 1) / S);

  const size_t row = (size_t)Hk * D;  // elements per cache slot
  const KT* kb = k + (size_t)b * T * row + (size_t)h * D;
  const KT* vbase = v + (size_t)b * T * row + (size_t)h * D;
  auto tile_start = [&](int t) { return (split + t * S) * kTile; };
  auto tile_rows = [&](int t) { return min(kTile, vlim - tile_start(t)); };
  auto stage_at = [&](int t) {
    return smem + (size_t)(t % stages) * 2 * kTile * rs;
  };
  // a thread's first 16-byte piece of a tile (row j0, piece pc0) and its
  // stride through the tile's rows
  constexpr int kPiece = 16 / sizeof(KT);
  const int pieces = VEC > 1 ? D / kPiece : 1;
  const int j0 = threadIdx.x / pieces, pc0 = threadIdx.x % pieces;
  const int dj = kThreads / pieces, dpc = kThreads % pieces;
  // tile t's keys (rows 0 .. kTile-1 of its stage) and values (rows kTile
  // ..), only its live slots; one commit group per tile, empty past the end
  auto issue = [&](int t) {
    if (t < n_tiles) {
      unsigned char* st = stage_at(t);
      const int nt = tile_rows(t);
      const size_t t0 = (size_t)tile_start(t) * row;
      if constexpr (VEC > 1) {
        for (int j = j0, pc = pc0; j < nt;) {
          const size_t off = t0 + (size_t)j * row + pc * kPiece;
          cp_async16(st + j * rs + pc * 16, kb + off);
          cp_async16(st + (kTile + j) * rs + pc * 16, vbase + off);
          j += dj;
          pc += dpc;
          if (pc >= pieces) {
            pc -= pieces;
            ++j;
          }
        }
        if constexpr (MMA) {
          // the tensor cores multiply every value row of the tile by its
          // p: rows past the tile's live slots (p = 0) must be finite
          for (int i = threadIdx.x; i < (kTile - nt) * pieces;
               i += kThreads)
            *reinterpret_cast<uint4*>(st + (kTile + nt + i / pieces) * rs
                                      + i % pieces * 16) =
                make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
        for (int i = threadIdx.x; i < nt * D; i += kThreads) {
          const int j = i / D, d = i % D;
          const size_t off = t0 + (size_t)j * row + d;
          reinterpret_cast<KT*>(st + j * rs)[d] = kb[off];
          reinterpret_cast<KT*>(st + (kTile + j) * rs)[d] = vbase[off];
        }
      }
    }
    cp_async_commit();
  };
  auto wait_step = [&]() {  // all but the newest stages - TPS groups landed
    if (stages - TPS == 1) cp_async_wait<1>();
    else if (stages - TPS == 2) cp_async_wait<2>();
    else cp_async_wait<3>();
  };

  for (int t = 0; t < stages - TPS; ++t) issue(t);
  if constexpr (MMA) {
    if (threadIdx.x < kHeads * qpieces) {
      const int r = threadIdx.x / qpieces;
      *reinterpret_cast<uint4*>(qb_s + r * (D + 8)
                                + threadIdx.x % qpieces * 8) = q16;
    }
    // p's planes start at 0, alpha at 1
    for (int i = threadIdx.x; i < 3 * kHeads * kPRow / 8; i += kThreads)
      reinterpret_cast<uint4*>(pb_s)[i] = make_uint4(0u, 0u, 0u, 0u);
    if (threadIdx.x < kHeads) alpha_s[threadIdx.x] = 1.f;
  } else {
#pragma unroll
    for (int u = 0; u < kQPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < NH * D) q_s[i] = qv[u];
    }
  }
  const float sqrt_d = sqrtf(static_cast<float>(D));
  // (1): warp `warp` adds the vectors [v_lo, v_hi) of each row
  const int NV = D / VEC;
  const int v_lo = warp * NV / kWarps, v_hi = (warp + 1) * NV / kWarps;
  // (2): warp `warp` < NH keeps head `warp`'s running statistics
  float m_run = kNegInf, l_run = 0.f;
  // (3): column thread `col` (PW columns) of slot group `sg`
  const int CT = D / PW, SG = slot_groups(D, PW);
  const int col = threadIdx.x % CT, sg = threadIdx.x / CT;
  float acc[MMA ? 1 : NH][PW];
#pragma unroll
  for (int g = 0; g < (MMA ? 1 : NH); ++g)
#pragma unroll
    for (int e = 0; e < PW; ++e) acc[g][e] = 0.f;
  // MMA (3): warp `warp` owns the 8-column blocks warp and warp + 16 of
  // every head's output, as mma accumulator fragments
  const int NB = D / 8;
  float oacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int t = 0; t < n_tiles; t += TPS) {
    for (int u = 0; u < TPS; ++u) issue(t + stages - TPS + u);
    wait_step();
    __syncthreads();  // the step's tiles (and q_s) visible to every thread
    const unsigned char* st = stage_at(t);
    const int nt = tile_rows(t);
    // MMA: the step's second tile (nt2 = 0 past the CTA's last)
    const unsigned char* st2 = stage_at(t + 1);
    const int nt2 = TPS > 1 && t + 1 < n_tiles ? tile_rows(t + 1) : 0;
    // (1) partial dots
    if constexpr (MMA) {
      // 16 heads x the warp's 8 slots over its half of D
      if (!all_masked && (tsel ? nt2 : nt) > 0) {
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
        const unsigned char* kr =
            (tsel ? st2 : st) + (nb * 8 + gid) * rs + tig * 4;
        const bf16* qr = qb_s + gid * (D + 8) + tig * 2;
        auto ld32 = [](const void* p) {
          return *reinterpret_cast<const uint32_t*>(p);
        };
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (ks_lo + u < ks_hi) {
            const int c = (ks_lo + u) * 16;  // 16 columns a step
            const uint32_t a[4] = {ld32(qr + c), ld32(qr + 8 * (D + 8) + c),
                                   ld32(qr + c + 8),
                                   ld32(qr + 8 * (D + 8) + c + 8)};
            mma_bf16(c4, a, ld32(kr + c * 2), ld32(kr + c * 2 + 16));
          }
        }
        float* r0 = red_s + (kq * kHeads + gid) * 2 * kTile + tsel * kTile
                    + nb * 8 + tig * 2;
        float* r1 = r0 + 8 * 2 * kTile;
        r0[0] = c4[0];
        r0[1] = c4[1];
        r1[0] = c4[2];
        r1[1] = c4[3];
      }
    } else if (!all_masked && lane < nt) {
      // lane = slot, the warp's share of D, every head
      const KT* kr = reinterpret_cast<const KT*>(st + lane * rs);
      float dot[NH];
#pragma unroll
      for (int g = 0; g < NH; ++g) dot[g] = 0.f;
      for (int vi = v_lo; vi < v_hi; ++vi) {
        float kv[VEC];
        loadv<VEC>(kr + vi * VEC, kv);
#pragma unroll
        for (int g = 0; g < NH; ++g) {
          const float* qg = q_s + g * D + vi * VEC;
          float qq[VEC];
          if constexpr (VEC % 4 == 0) {
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 f = *reinterpret_cast<const float4*>(qg + e);
              qq[e] = f.x; qq[e + 1] = f.y; qq[e + 2] = f.z; qq[e + 3] = f.w;
            }
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) qq[e] = qg[e];
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot[g] = fmaf(qq[e], kv[e], dot[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < NH; ++g)
        red_s[(warp * kHeads + g) * kTile + lane] = dot[g];
    }
    __syncthreads();
    // (2) a warp per head: the step's scores, max and exp-sum (lane =
    // slot of the first tile and, MMA, of the second); p to p_s
    if (warp < NH) {
      const int g = warp;
      const bool live = lane < nt, live2 = lane < nt2;
      constexpr int kParts = MMA ? 2 : kWarps;  // partial dots per score
      constexpr int kRow = MMA ? 2 * kTile : kTile;
      float s = kNegInf, s2 = kNegInf;
      if (!all_masked) {
        if (live) {
          float dot = 0.f;
#pragma unroll
          for (int w = 0; w < kParts; ++w)
            dot = __fadd_rn(dot, red_s[(w * kHeads + g) * kRow + lane]);
          s = __fdiv_rn(dot, sqrt_d);
        }
        if (live2) {
          float dot = 0.f;
#pragma unroll
          for (int w = 0; w < kParts; ++w)
            dot = __fadd_rn(dot,
                            red_s[(w * kHeads + g) * kRow + kTile + lane]);
          s2 = __fdiv_rn(dot, sqrt_d);
        }
      }
      float mx = fmaxf(s, s2);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      const float p = live ? expf(__fsub_rn(s, m_new)) : 0.f;
      const float p2 = live2 ? expf(__fsub_rn(s2, m_new)) : 0.f;
      float sum = __fadd_rn(p, p2);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      const float alpha = expf(__fsub_rn(m_run, m_new));
      l_run = __fadd_rn(__fmul_rn(l_run, alpha), sum);
      m_run = m_new;
      if constexpr (MMA) {
        // p as three bf16 planes whose sum is p exactly (8 + 8 + 8 bits
        // of its 24-bit significand)
        auto planes = [&](float x, bf16* pg) {
          const bf16 hi = __float2bfloat16_rn(x);
          const float r1 = __fsub_rn(x, __bfloat162float(hi));
          const bf16 mid = __float2bfloat16_rn(r1);
          pg[0] = hi;
          pg[kHeads * kPRow] = mid;
          pg[2 * kHeads * kPRow] =
              __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
        };
        planes(p, pb_s + g * kPRow + lane);
        planes(p2, pb_s + g * kPRow + kTile + lane);
      } else {
        p_s[lane * kPStride + g] = p;
      }
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();
    // (3) acc = acc * alpha + p . v
    if constexpr (MMA) {
      // the warp's 8-column blocks: 16 heads x 8 columns, over each tile's
      // two k steps of 16 slots, each plane of p in turn
      const float a_lo = alpha_s[gid], a_hi = alpha_s[gid + 8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        oacc[i][0] = __fmul_rn(oacc[i][0], a_lo);
        oacc[i][1] = __fmul_rn(oacc[i][1], a_lo);
        oacc[i][2] = __fmul_rn(oacc[i][2], a_hi);
        oacc[i][3] = __fmul_rn(oacc[i][3], a_hi);
      }
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        if (tt ? nt2 == 0 : nt == 0) break;
        const unsigned char* vrows = (tt ? st2 : st) + kTile * rs;
        uint32_t pa[2][3][4];  // p's A fragments: 2 k steps x 3 planes
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int pl = 0; pl < 3; ++pl) {
            const bf16* pp = pb_s + pl * kHeads * kPRow + tt * kTile
                             + ks * 16 + tig * 2;
            pa[ks][pl][0] =
                *reinterpret_cast<const uint32_t*>(pp + gid * kPRow);
            pa[ks][pl][1] =
                *reinterpret_cast<const uint32_t*>(pp + (gid + 8) * kPRow);
            pa[ks][pl][2] =
                *reinterpret_cast<const uint32_t*>(pp + gid * kPRow + 8);
            pa[ks][pl][3] = *reinterpret_cast<const uint32_t*>(
                pp + (gid + 8) * kPRow + 8);
          }
        uint32_t vb4[2][4];  // per block: slots 0-7, 8-15, 16-23, 24-31
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (warp + 16 * i < NB)
            ldmatrix_x4_trans(vb4[i], vrows + lane * rs + (warp + 16 * i) * 16);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (warp + 16 * i < NB)
                mma_bf16(oacc[i], pa[ks][pl], vb4[i][2 * ks],
                         vb4[i][2 * ks + 1]);
      }
    } else if (sg < SG) {
#pragma unroll
      for (int g = 0; g < NH; ++g) {
        const float a = alpha_s[g];
#pragma unroll
        for (int e = 0; e < PW; ++e) acc[g][e] = __fmul_rn(acc[g][e], a);
      }
      const unsigned char* vrows = st + kTile * rs;
      for (int j = sg; j < nt; j += SG) {
        float vv[PW];
        loadv<PW>(reinterpret_cast<const KT*>(vrows + j * rs) + col * PW, vv);
        const float* pj = p_s + j * kPStride;
#pragma unroll
        for (int g4 = 0; g4 < NH; g4 += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pj + g4);
          const float pg[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < PW; ++e)
              acc[g4 + u][e] = fmaf(pg[u], vv[e], acc[g4 + u][e]);
        }
      }
    }
    __syncthreads();  // the stage, red_s and p_s are rewritten next
  }
  cp_async_wait<0>();  // (the groups past the last tile are empty)

  // the CTA's (m, l) and its acc (the CUDA cores' slot groups' partial
  // sums through the ring's memory, added in group order); its (m, l) then
  // goes to every CTA of the cluster
  auto live_chunk = [&](int r) { return r * kTile < vlim; };
  if (n_tiles > 0) {
    if (warp < NH && lane == 0) ml_s[warp] = make_float2(m_run, l_run);
    if constexpr (MMA) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int blk = warp + 16 * i;
        if (blk >= NB) break;
        float* a0 = acc_s + gid * D + blk * 8 + tig * 2;
        float* a1 = a0 + 8 * D;
        a0[0] = oacc[i][0];
        a0[1] = oacc[i][1];
        a1[0] = oacc[i][2];
        a1[1] = oacc[i][3];
      }
    } else if (sg < SG) {
#pragma unroll
      for (int g = 0; g < NH; ++g)
        store_pw<PW>(part_s + (sg * NH + g) * D + col * PW, acc[g]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (MMA ? 0 : NH * CT); i += kThreads) {
      float sum[PW], part[PW];
      load_pw<PW>(part_s + i * PW, sum);
      for (int grp = 1; grp < SG; ++grp) {
        load_pw<PW>(part_s + grp * NH * D + i * PW, part);
#pragma unroll
        for (int e = 0; e < PW; ++e) sum[e] = __fadd_rn(sum[e], part[e]);
      }
      store_pw<PW>(acc_s + i * PW, sum);
    }
    for (int i = threadIdx.x; i < S * ng; i += kThreads)
      *cluster.map_shared_rank(mlx_s + split * kHeads + i % ng, i / ng) =
          ml_s[i % ng];
  }
  cluster.sync();  // every CTA holds every live CTA's (m, l)

  // CTA r read a tile when its first tile, r, holds a slot below vlim
  // (every CTA when valid < 1); CTA 0 always did.  Each head's weights:
  // lane r of a group of S lanes takes CTA r's (m, l); m_row, the max over
  // the live CTAs, and l = sum_r l_r w_r, w_r = exp(m_r - m_row), by
  // shuffle trees over the group
  {
    const int g = threadIdx.x / S, r = threadIdx.x % S;
    const bool live = g < ng && live_chunk(r);
    const float2 ml = live ? mlx_s[r * kHeads + g] : make_float2(kNegInf, 0.f);
    float m_row = ml.x;
    for (int off = S / 2; off > 0; off >>= 1)
      m_row = fmaxf(m_row, __shfl_xor_sync(0xffffffffu, m_row, off));
    const float w = live ? expf(__fsub_rn(ml.x, m_row)) : 0.f;
    float l = __fmul_rn(ml.y, w);
    for (int off = S / 2; off > 0; off >>= 1)
      l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, off));
    if (g < ng) {
      w_s[g * kMaxSplits + r] = w;
      if (r == 0) den_s[g] = fmaxf(l, 1e-30f);
      if (r == 0 && mlb != nullptr) mlb[g] = make_float2(m_row, l);
    }
  }
  __syncthreads();
  // CTA j owns the output units [j share, (j + 1) share) of the ng x D
  // outputs, PW adjacent ones a unit; this CTA's acc of each unit, times
  // its weight, goes to the owner's receive buffer (in the ring's memory,
  // free once every CTA passed the cluster barrier above), row `split`
  const int n_units = ng * D / PW;
  const int share = (n_units + S - 1) / S;
  if (n_tiles > 0) {
    for (int u = threadIdx.x; u < n_units; u += kThreads) {
      const int j = u / share, i = u * PW;
      const float w = w_s[(i / D) * kMaxSplits + split];
      float a[PW];
      load_pw<PW>(acc_s + i, a);
#pragma unroll
      for (int e = 0; e < PW; ++e) a[e] = __fmul_rn(a[e], w);
      store_pw<PW>(cluster.map_shared_rank(
                       recv_s + (split * share + u - j * share) * PW, j),
                   a);
    }
  }
  cluster.sync();  // every push has landed; no CTA reads another's memory
                   // after this
  // this CTA's units: the live CTAs' weighted acc added in rank order,
  // over l
  const int lo = split * share, hi = min(n_units, lo + share);
  QT* ob = out + ((size_t)b * Hq + (size_t)h * G + g0) * D;
  for (int u = lo + threadIdx.x; u < hi; u += kThreads) {
    const int i = u * PW;
    float sum[PW], part[PW];
#pragma unroll
    for (int e = 0; e < PW; ++e) sum[e] = 0.f;
    for (int r = 0; r < S; ++r) {
      if (!live_chunk(r)) break;  // the live CTAs are 0 .. some r
      load_pw<PW>(recv_s + (r * share + u - lo) * PW, part);
#pragma unroll
      for (int e = 0; e < PW; ++e) sum[e] = __fadd_rn(sum[e], part[e]);
    }
    const float den = den_s[i / D];
    if (mlb != nullptr) {
#pragma unroll
      for (int e = 0; e < PW; ++e) out32[i + e] = __fdiv_rn(sum[e], den);
    } else {
#pragma unroll
      for (int e = 0; e < PW; ++e)
        ob[i + e] = from_f32<QT>(__fdiv_rn(sum[e], den));
    }
  }
}

struct Config {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
};

// The grid and cluster of a launch; the shared memory and a cluster above
// 8 CTAs are opted in once per instance.
template <typename QT, typename KT, int VEC, int NH, bool MMA>
cudaError_t configure(Config& c, int B, int Hk, int G, int D, int S,
                      cudaStream_t stream) {
  auto kern = attn_kernel<QT, KT, VEC, NH, MMA>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return opt_in;
  if (S > 8) {
    static const cudaError_t opt_in16 = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (opt_in16 != cudaSuccess) return opt_in16;
  }
  c.cfg = cudaLaunchConfig_t{};
  c.cfg.gridDim = dim3(S, Hk * ((G + kHeads - 1) / kHeads), B);
  c.cfg.blockDim = dim3(kThreads);
  c.cfg.dynamicSmemBytes =
      smem_layout(D, sizeof(KT), VEC > 1 ? 4 : 1, MMA).bytes;
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
  const void *q, *k, *v;
  const int* valid;
  void* out;
  float2* ml;
  int B, T, Hk, G, D, S;
  cudaStream_t stream;
  template <typename QT, typename KT, int VEC, int NH, bool MMA>
  cudaError_t run() const {
    Config c;
    cudaError_t err =
        configure<QT, KT, VEC, NH, MMA>(c, B, Hk, G, D, S, stream);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&c.cfg, attn_kernel<QT, KT, VEC, NH, MMA>,
                             static_cast<const QT*>(q),
                             static_cast<const KT*>(k),
                             static_cast<const KT*>(v), valid,
                             static_cast<QT*>(out), ml, T, Hk, G, D);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
};

struct OccupancyOp {
  int B, T, Hk, G, D, S;
  int* clusters;
  template <typename QT, typename KT, int VEC, int NH, bool MMA>
  cudaError_t run() const {
    Config c;
    cudaError_t err =
        configure<QT, KT, VEC, NH, MMA>(c, B, Hk, G, D, S, nullptr);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(
        clusters, attn_kernel<QT, KT, VEC, NH, MMA>, &c.cfg);
  }
};

// NH: a CTA's heads, min(G, kHeads), rounded up to a multiple of 4
template <typename QT, typename KT, int VEC, typename Op>
cudaError_t by_heads(const Op& op) {
  const int nh = (min(op.G, kHeads) + 3) / 4 * 4;
  if (nh == 4) return op.template run<QT, KT, VEC, 4, false>();
  if (nh == 8) return op.template run<QT, KT, VEC, 8, false>();
  if (nh == 12) return op.template run<QT, KT, VEC, 12, false>();
  return op.template run<QT, KT, VEC, 16, false>();
}

// bf16 q and caches with D % 16 == 0 take the tensor cores
template <typename QT, typename KT, typename Op>
cudaError_t by_vec(const Op& op) {
  constexpr int V = 16 / sizeof(KT);  // one 16-byte piece per vector
  if constexpr (sizeof(QT) == 2 && sizeof(KT) == 2)
    if (op.D % 16 == 0) return op.template run<QT, KT, V, kHeads, true>();
  if (op.D % V == 0) return by_heads<QT, KT, V>(op);
  return by_heads<QT, KT, 1>(op);
}

template <typename Op>
cudaError_t by_types(const Op& op, int q_type, int kv_type) {
  const int S = op.S;
  if (op.B < 1 || op.T < 1 || op.Hk < 1 || op.G < 1 || op.D < 1 ||
      op.D > 256 || S < 1 || S > kMaxSplits || (S & (S - 1)) != 0 ||
      op.B > 65535 ||
      op.Hk * ((op.G + kHeads - 1) / kHeads) > 65535)
    return cudaErrorInvalidValue;
  if (q_type == 0 && kv_type == 0) return by_vec<float, float>(op);
  if (q_type == 0 && kv_type == 1) return by_vec<float, bf16>(op);
  if (q_type == 1 && kv_type == 0) return by_vec<bf16, float>(op);
  if (q_type == 1 && kv_type == 1) return by_vec<bf16, bf16>(op);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dattn

// Plain C entry points (bound with ctypes).  Layouts, all contiguous:
// q (B, Hq, D) and out (B, Hq, D) in q's type, k and v (B, T, Hk, D) in
// the cache type (0 = fp32, 1 = bf16 for q_type / kv_type), valid (B,)
// int32; ml null, or (B, Hq) float2 (m, l) with out then fp32.  Hq = Hk * G; 1 <= D <= 256; splits S in {1, 2, 4, 8, 16}, the
// CTAs of one cluster.

// Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* valid,
                                       void* out, void* ml, int B, int T,
                                       int Hk, int G, int D, int splits,
                                       int q_type, int kv_type,
                                       void* stream) {
  const dattn::LaunchOp op{q, k, v, static_cast<const int*>(valid), out,
                           static_cast<float2*>(ml), B, T, Hk, G, D, splits,
                           static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dattn::by_types(op, q_type, kv_type));
}

// How many clusters of the instance a launch at (B, T, Hk, G, D, splits)
// takes can be resident on the card at once
// (cudaOccupancyMaxActiveClusters), into *clusters; returns the CUDA error
// (0 = ok).
extern "C" int decode_attention_max_clusters(int B, int T, int Hk, int G,
                                             int D, int splits, int q_type,
                                             int kv_type, int* clusters) {
  const dattn::OccupancyOp op{B, T, Hk, G, D, splits, clusters};
  return static_cast<int>(dattn::by_types(op, q_type, kv_type));
}
