// gru_decode: one T=1 decode tick through all L layers of a GRU stack in
// ONE launch.
//
// Replaces the TPU kernel gru_decode_pallas / _decode_kernel
// (src/repro/kernels/gru_cell/kernel.py:217 / :176).  Same function:
// layer 0 takes the hoisted input half xw0; layer l > 0 computes its input
// half y . W_l + b_l from the previous layer's fresh output y, then the GRU
// cell against h0[l].  Output h_n (L, B, H) in h0's dtype; no cell state.
//
// What bounds it on an H100: a tick is L serially dependent layers, each
// two matrix-vector products against (H x 3H) weights (W_l and U_l; 0.69
// MB each in bf16 at H = 340) at a batch of a few rows, so the tick is a
// chain of small weight streams through one SM per row group: bound by
// that SM's L2 read rate and FMA rate, and by the serial layer chain.
//
// What the design does about it (the lstm_decode.cu design): a CUDA grid
// has no order, but batch rows are independent, so each block owns a
// group of up to 4 rows and walks the L layers itself with the
// inter-layer value y in shared memory: one launch per tick, no barrier
// between blocks.  Each weight element is loaded once per layer and reused
// across the block's rows; both products of a layer share one pass over
// the columns, and the n gate's recurrent product is kept apart from its
// input half until the reset gate is known.  Vector loads need H % 4 == 0
// (3H-wide rows); other H take the scalar instantiation.
//
// Rounding points copied from the reference (kernel.py:192-214): y . W_l
// is accumulated in fp32 and rounded to xw_dtype = promote(h0.dtype,
// W.dtype); b_l, cast to xw_dtype, is added in xw_dtype; the result goes
// to fp32.  h = (1 - z) * n + z * h0[l] with h0[l] read in its stored
// dtype; the inter-layer value y is h rounded through h0's dtype.  W[0] is
// never read.  U is upcast to fp32 before its product, so its type (UT) is
// independent of W's (WT, which alone sets xw_dtype).

#include "rnn_common.cuh"

namespace gru {

using namespace rnn;

template <bool XW_BF16>
__device__ __forceinline__ float round_xw(float x) {
  return XW_BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <typename WT, typename UT, typename XT, typename HT, int RB, int VEC>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const XT* __restrict__ xw0, const WT* __restrict__ Ws,
              const WT* __restrict__ bs, const UT* __restrict__ Us,
              const HT* __restrict__ h0, HT* __restrict__ hn, int L, int B,
              int H) {
  // xw_dtype is bf16 only when both the activations and the weights are
  constexpr bool XW_BF16 = sizeof(HT) == 2 && sizeof(WT) == 2;
  extern __shared__ float smem[];
  const int G3 = 3 * H;
  float* y_s = smem;            // RB x H   the layer chain's wire
  float* hp_s = y_s + RB * H;   // RB x H   this layer's h0[l], fp32
  float* xw_s = hp_s + RB * H;  // RB x 3H  this layer's input half
  float* hu_s = xw_s + RB * G3; // RB x 3H  this layer's raw h . U

  const int b0 = blockIdx.x * RB;
  const int nrows = min(RB, B - b0);
  // rows past B are never written below; keep their products finite
  for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x) y_s[idx] = 0.f;

  for (int l = 0; l < L; ++l) {
    const size_t state0 = ((size_t)l * B + b0) * H;
    for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x)
      hp_s[idx] = idx / H < nrows ? to_f32(h0[state0 + idx]) : 0.f;
    __syncthreads();

    const UT* Ul = Us + (size_t)l * H * G3;
    const WT* Wl = Ws + (size_t)l * H * G3;
    for (int q = threadIdx.x; q < G3 / VEC; q += blockDim.x) {
      const int col = VEC * q;
      float au[RB][VEC], aw[RB][VEC];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) au[r][e] = aw[r][e] = 0.f;
      if (l == 0) {
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
          float uk[VEC];
          loadv<VEC>(Ul + (size_t)k * G3 + col, uk);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float hk = hp_s[r * H + k];
#pragma unroll
            for (int e = 0; e < VEC; ++e) au[r][e] = fmaf(hk, uk[e], au[r][e]);
          }
        }
      } else {
#pragma unroll 2
        for (int k = 0; k < H; ++k) {
          float uk[VEC], wk[VEC];
          loadv<VEC>(Ul + (size_t)k * G3 + col, uk);
          loadv<VEC>(Wl + (size_t)k * G3 + col, wk);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float hk = hp_s[r * H + k];
            const float yk = y_s[r * H + k];
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              au[r][e] = fmaf(hk, uk[e], au[r][e]);
              aw[r][e] = fmaf(yk, wk[e], aw[r][e]);
            }
          }
        }
      }
      float bq[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) bq[e] = 0.f;
      if (l > 0) loadv<VEC>(bs + (size_t)l * G3 + col, bq);
#pragma unroll
      for (int e = 0; e < VEC; ++e) bq[e] = round_xw<XW_BF16>(bq[e]);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= nrows) continue;
        float xv[VEC];
        if (l == 0) {
          loadv<VEC>(xw0 + (size_t)(b0 + r) * G3 + col, xv);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            xv[e] = round_xw<XW_BF16>(round_xw<XW_BF16>(aw[r][e]) + bq[e]);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          xw_s[r * G3 + col + e] = xv[e];
          hu_s[r * G3 + col + e] = au[r][e];
        }
      }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
      const int r = idx / H, j = idx % H;
      const float* xw = xw_s + r * G3;
      const float* hu = hu_s + r * G3;
      const float z = sigmoid(xw[j] + hu[j]);
      const float rg = sigmoid(xw[H + j] + hu[H + j]);
      const float n = tanhf(xw[2 * H + j] + rg * hu[2 * H + j]);
      const HT h = from_f32<HT>((1.f - z) * n + z * hp_s[idx]);
      hn[state0 + idx] = h;
      y_s[idx] = to_f32(h);
    }
    __syncthreads();
  }
}

struct DecodeArgs {
  const void* xw0;
  const void* Ws;
  const void* bs;
  const void* Us;
  const void* h0;
  void* hn;
  int L, B, H;
  int w_bf16, u_bf16, xw_bf16, h_bf16;
  cudaStream_t stream;
};

template <typename WT, typename UT, typename XT, typename HT, int RB, int VEC>
int launch_vec(const DecodeArgs& a) {
  auto kernel = decode_kernel<WT, UT, XT, HT, RB, VEC>;
  const size_t smem = sizeof(float) * RB * 8 * (size_t)a.H;
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.B + RB - 1) / RB);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const XT*>(a.xw0), static_cast<const WT*>(a.Ws),
      static_cast<const WT*>(a.bs), static_cast<const UT*>(a.Us),
      static_cast<const HT*>(a.h0), static_cast<HT*>(a.hn), a.L, a.B, a.H);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT, typename UT, typename XT, typename HT, int RB>
int launch_rb(const DecodeArgs& a) {
  return a.H % 4 == 0 ? launch_vec<WT, UT, XT, HT, RB, 4>(a)
                      : launch_vec<WT, UT, XT, HT, RB, 1>(a);
}

template <typename WT, typename UT, typename XT, typename HT>
int launch_typed(const DecodeArgs& a) {
  switch (rows_per_block(a.B)) {
    case 1: return launch_rb<WT, UT, XT, HT, 1>(a);
    case 2: return launch_rb<WT, UT, XT, HT, 2>(a);
    default: return launch_rb<WT, UT, XT, HT, 4>(a);
  }
}

template <typename WT, typename UT, typename XT>
int launch_h(const DecodeArgs& a) {
  return a.h_bf16 ? launch_typed<WT, UT, XT, bf16>(a)
                  : launch_typed<WT, UT, XT, float>(a);
}

template <typename WT, typename UT>
int launch_x(const DecodeArgs& a) {
  return a.xw_bf16 ? launch_h<WT, UT, bf16>(a) : launch_h<WT, UT, float>(a);
}

}  // namespace gru

// Plain C entry point (bound with ctypes).  Layouts, all contiguous:
// xw0 (B, 3, H); Ws (L, H, 3, H) and bs (L, 3, H) in one dtype; Us
// (L, H, 3, H) in Ws's dtype or, under bf16 Ws, fp32 (the fake-quantized
// U of a bf16 stack under a reduced recurrent-weight precision); h0
// (L, B, H); output hn (L, B, H) in h0's dtype.  *_bf16 flags pick
// bfloat16 over fp32 per operand (fp32 Ws with bf16 Us is refused: the
// wrapper upcasts such a U).  Launches on `stream` and returns
// cudaGetLastError() (0 = ok).
extern "C" int gru_decode_launch(const void* xw0, const void* Ws,
                                 const void* bs, const void* Us,
                                 const void* h0, void* hn, int L, int B,
                                 int H, int w_bf16, int u_bf16, int xw_bf16,
                                 int h_bf16, void* stream) {
  gru::DecodeArgs a{xw0, Ws, bs, Us, h0, hn, L, B, H, w_bf16, u_bf16,
                    xw_bf16, h_bf16, static_cast<cudaStream_t>(stream)};
  if (a.w_bf16)
    return a.u_bf16 ? gru::launch_x<gru::bf16, gru::bf16>(a)
                    : gru::launch_x<gru::bf16, float>(a);
  return a.u_bf16 ? static_cast<int>(cudaErrorInvalidValue)
                  : gru::launch_x<float, float>(a);
}
