// decode_attention: one query token per sequence against its KV cache
// (single-query GQA flash-decode with a per-row count of live slots).
//
// Replaces the TPU kernel decode_attention_pallas / _kernel
// (src/repro/kernels/decode_attention/kernel.py:63 / :26).  Same function:
// q (B, Hq, D), caches (B, T, Hk, D), valid (B,) int32; query head
// h * G + g (G = Hq / Hk) attends to kv head h.  The cache is walked in
// tiles of block_t slots with the Pallas kernel's online softmax, all in
// fp32 (kernel.py:44-62): s = q . k / sqrt(D), slots at or past valid
// masked to NEG_INF = -1e30, m_new = max(m, max_t s), p = exp(s - m_new),
// alpha = exp(m - m_new), l = l * alpha + sum_t p, acc = acc * alpha +
// p . v; the output is acc / max(l, 1e-30), rounded to q's dtype.
//
// What bounds it on an H100: bytes.  Each (b, kv head) needs its T x D
// keys and values once, and each slot 4 Hq D / Hk operations: at B = 4,
// T = 2048, Hk = 1, D = 256 bf16 the caches are 8.4 MB, 0.0025 ms at
// 3.35 TB/s.
//
// What the design does about it: the Pallas grid walks (b, t) in order
// with (m, l, acc) in VMEM scratch; a CUDA grid has no order, so one block
// walks all of a sequence's tiles itself, with its query, the tile's
// scores and acc in shared memory in fp32.  A block owns ONE query head
// (b, h * G + g): the G heads of a kv head are independent softmaxes, and
// one block per query head gives B x Hq blocks (40 at B = 4, Hq = 10)
// where one per kv head gave 4, whose dependent loads left each SM idle
// (1.54 ms per launch, PERF.md).  The G blocks of a kv head read the same
// keys and values, the later ones mostly from the 50 MB L2.  Per tile:
// each thread takes whole slots and reads a slot's key in 16-byte vectors
// (VEC = 8 bf16 or 4 fp32 elements; VEC = 1 when D is not a multiple);
// the block reduces the tile's max and exp-sum in a fixed order; then
// D / VEC column threads times NG slot groups read the values in 16-byte
// vectors, and the NG partial p . v sums are added in a fixed order.
// Tiles that begin at or past valid are skipped: there every p is exactly
// 0 and alpha exactly 1, so skipping them leaves every number as it was
// (unless valid < 1, when all tiles are walked, as the Pallas kernel
// does).  Splitting T across blocks with a combine pass (flash-decoding)
// is the lever for more parallelism, and later work.

#include "rnn_common.cuh"

namespace dattn {

using namespace rnn;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// the sum of v over the block, the same value in every thread: warp
// shuffles, then the kWarps partials added in a fixed order
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // red may still be read by an earlier reduction
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, red[w]);
  return s;
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float m = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

template <typename QT, typename KT, int VEC>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
            const KT* __restrict__ v, const int* __restrict__ valid,
            QT* __restrict__ out, int T, int Hk, int G, int D, int bt) {
  extern __shared__ float smem[];
  const int CT = D / VEC;            // column threads of the p . v phase
  const int NG = kThreads / CT;      // slot groups of the p . v phase
  float* q_s = smem;                 // D        the query head, fp32
  float* acc_s = q_s + D;            // D        the running p . v
  float* s_s = acc_s + D;            // bt       the tile's scores, then p
  float* part_s = s_s + bt;          // NG x D   p . v partial sums
  float* red_s = part_s + NG * D;    // kWarps   reductions

  const int qh = blockIdx.x, b = blockIdx.y;
  const int Hq = Hk * G, h = qh / G;
  const float sqrt_d = sqrtf(static_cast<float>(D));
  const QT* qb = q + ((size_t)b * Hq + qh) * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    q_s[d] = to_f32(qb[d]);
    acc_s[d] = 0.f;
  }
  const int vb = valid[b];
  const int n_t = T / bt;
  const int n_live = vb >= 1 ? min(n_t, (min(vb, T) + bt - 1) / bt) : n_t;
  const size_t row = (size_t)Hk * D;  // elements per cache slot
  const KT* kb = k + (size_t)b * T * row + (size_t)h * D;
  const KT* vbase = v + (size_t)b * T * row + (size_t)h * D;
  float m = kNegInf, l = 0.f;  // the same values in every thread
  __syncthreads();

  for (int tile = 0; tile < n_live; ++tile) {
    const int t0 = tile * bt;
    // (1) scores: a thread per slot, the key read in VEC-wide vectors
    float mx = kNegInf;
    for (int j = threadIdx.x; j < bt; j += kThreads) {
      const KT* kt = kb + (size_t)(t0 + j) * row;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += VEC) {
        float kv[VEC];
        loadv<VEC>(kt + d, kv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(q_s[d + e], kv[e], dot);
      }
      const float s = t0 + j < vb ? __fdiv_rn(dot, sqrt_d) : kNegInf;
      s_s[j] = s;
      mx = fmaxf(mx, s);
    }
    // (2) the tile's max and exp-sum, then the running statistics
    const float m_new = fmaxf(m, block_max(mx, red_s));
    float sum = 0.f;
    for (int j = threadIdx.x; j < bt; j += kThreads) {
      const float p = expf(__fsub_rn(s_s[j], m_new));
      s_s[j] = p;
      sum = __fadd_rn(sum, p);
    }
    sum = block_sum(sum, red_s);  // also orders the p writes before (3)
    const float alpha = expf(__fsub_rn(m, m_new));
    l = __fadd_rn(__fmul_rn(l, alpha), sum);
    m = m_new;
    // (3) p . v: NG slot groups x CT column threads of VEC columns each
    const int grp = threadIdx.x / CT, c = threadIdx.x % CT;
    if (grp < NG) {
      float pv[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) pv[e] = 0.f;
      const KT* vt = vbase + (size_t)t0 * row + c * VEC;
#pragma unroll 4
      for (int j = grp; j < bt; j += NG) {
        float vv[VEC];
        loadv<VEC>(vt + (size_t)j * row, vv);
        const float p = s_s[j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) pv[e] = fmaf(p, vv[e], pv[e]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) part_s[grp * D + c * VEC + e] = pv[e];
    }
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float s = 0.f;
      for (int g = 0; g < NG; ++g) s = __fadd_rn(s, part_s[g * D + d]);
      acc_s[d] = __fadd_rn(__fmul_rn(acc_s[d], alpha), s);
    }
    __syncthreads();  // s_s and part_s are rewritten by the next tile
  }

  QT* ob = out + ((size_t)b * Hq + qh) * D;
  const float denom = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads)
    ob[d] = from_f32<QT>(__fdiv_rn(acc_s[d], denom));
}

template <typename QT, typename KT, int VEC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* valid, void* out, int B, int T, int Hk, int G,
                   int D, int bt, cudaStream_t stream) {
  const int NG = kThreads / (D / VEC);
  const size_t smem = sizeof(float) * ((size_t)2 * D + bt + (size_t)NG * D
                                       + kWarps);
  const cudaError_t err = reserve_smem(attn_kernel<QT, KT, VEC>, smem);
  if (err != cudaSuccess) return err;
  attn_kernel<QT, KT, VEC><<<dim3(Hk * G, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), valid, static_cast<QT*>(out), T, Hk, G, D,
      bt);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t by_vec(const void* q, const void* k, const void* v,
                   const int* valid, void* out, int B, int T, int Hk, int G,
                   int D, int bt, cudaStream_t s) {
  constexpr int V = 16 / sizeof(KT);  // one 16-byte load per vector
  if (D % V == 0)
    return launch<QT, KT, V>(q, k, v, valid, out, B, T, Hk, G, D, bt, s);
  return launch<QT, KT, 1>(q, k, v, valid, out, B, T, Hk, G, D, bt, s);
}

}  // namespace dattn

// Plain C entry point (bound with ctypes).  Layouts, all contiguous:
// q (B, Hq, D) and out (B, Hq, D) in q's type, k and v (B, T, Hk, D) in
// the cache type (0 = fp32, 1 = bf16 for q_type / kv_type), valid (B,)
// int32.  Hq = Hk * G; 1 <= D <= 256; T a multiple of block_t >= 1.
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* valid,
                                       void* out, int B, int T, int Hk,
                                       int G, int D, int block_t,
                                       int q_type, int kv_type,
                                       void* stream) {
  using rnn::bf16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(valid);
  if (B < 1 || T < 1 || Hk < 1 || G < 1 || D < 1 || D > dattn::kThreads ||
      block_t < 1 || T % block_t != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (q_type == 0 && kv_type == 0)
    err = dattn::by_vec<float, float>(q, k, v, vl, out, B, T, Hk, G, D,
                                      block_t, s);
  else if (q_type == 0 && kv_type == 1)
    err = dattn::by_vec<float, bf16>(q, k, v, vl, out, B, T, Hk, G, D,
                                     block_t, s);
  else if (q_type == 1 && kv_type == 0)
    err = dattn::by_vec<bf16, float>(q, k, v, vl, out, B, T, Hk, G, D,
                                     block_t, s);
  else if (q_type == 1 && kv_type == 1)
    err = dattn::by_vec<bf16, bf16>(q, k, v, vl, out, B, T, Hk, G, D,
                                    block_t, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
