// lstm_decode: one T=1 decode tick through all L layers of an LSTM stack
// in ONE launch.
//
// Replaces the TPU kernel lstm_decode_pallas / _decode_kernel
// (src/repro/kernels/lstm_cell/kernel.py:337 / :279).  Same function:
// layer 0 takes the hoisted input half xw0; layer l > 0 computes its input
// half y . W_l + b_l from the previous layer's fresh output y, then the
// cell against (h0[l], c0[l]).  Outputs h_n (L, B, H) in h0's dtype and
// c_n (L, B, H) fp32.
//
// What bounds it on an H100: a tick is L serially dependent layers, each
// two matrix-vector products against (H x 4H) weights (W_l and U_l; 0.92
// MB each in bf16 at H = 340) at a batch of a few rows, so the tick is a
// chain of small weight streams through one SM per row group — bound by
// that SM's L2 read rate and FMA rate, and by the serial layer chain.
//
// What the design does about it: the Pallas kernel chains the layers
// through grid order and VMEM scratch (kernel.py:283-292); a CUDA grid has
// no order, but batch rows are independent, so each block owns a group of
// up to 4 rows and walks the L layers itself with the inter-layer value y
// in shared memory: one launch per tick and no barrier between blocks.
// Each weight element is loaded once per layer and reused across the
// block's rows; both products of a layer share one pass over the columns.
//
// Rounding points copied from the reference (kernel.py:314-319, :332):
// y . W_l is accumulated in fp32 and rounded to xw_dtype =
// promote(h0.dtype, W.dtype); b_l, cast to xw_dtype, is added in xw_dtype
// (one rounding of the fp32 sum); the result goes to fp32.  The
// inter-layer value y is h rounded through h0's dtype.  W[0] is never read.
// U is upcast to fp32 before its product, so its type (UT) is independent
// of W's (WT, which alone sets xw_dtype).

#include "rnn_common.cuh"

namespace lstm {

using namespace rnn;

template <bool XW_BF16>
__device__ __forceinline__ float round_xw(float x) {
  return XW_BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <typename WT, typename UT, typename XT, typename HT, int RB>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const XT* __restrict__ xw0, const WT* __restrict__ Ws,
              const WT* __restrict__ bs, const UT* __restrict__ Us,
              const HT* __restrict__ h0, const float* __restrict__ c0,
              HT* __restrict__ hn, float* __restrict__ cn, int L, int B,
              int H) {
  // xw_dtype is bf16 only when both the activations and the weights are
  constexpr bool XW_BF16 = sizeof(HT) == 2 && sizeof(WT) == 2;
  extern __shared__ float smem[];
  const int G4 = 4 * H;
  float* y_s = smem;              // RB x H   the layer chain's wire
  float* hp_s = y_s + RB * H;     // RB x H   this layer's h0[l], fp32
  float* gates_s = hp_s + RB * H; // RB x 4H  this layer's pre-activations

  const int b0 = blockIdx.x * RB;
  const int nrows = min(RB, B - b0);
  // rows past B are never written below; keep their products finite
  for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x) y_s[idx] = 0.f;

  for (int l = 0; l < L; ++l) {
    const size_t state0 = ((size_t)l * B + b0) * H;
    for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x)
      hp_s[idx] = idx / H < nrows ? to_f32(h0[state0 + idx]) : 0.f;
    __syncthreads();

    const UT* Ul = Us + (size_t)l * H * G4;
    const WT* Wl = Ws + (size_t)l * H * G4;
    for (int q = threadIdx.x; q < H; q += blockDim.x) {
      const int col = 4 * q;
      float au[RB][4], aw[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) au[r][e] = aw[r][e] = 0.f;
      if (l == 0) {
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
          const float4 uk = load4(Ul + (size_t)k * G4 + col);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float hk = hp_s[r * H + k];
            au[r][0] = fmaf(hk, uk.x, au[r][0]);
            au[r][1] = fmaf(hk, uk.y, au[r][1]);
            au[r][2] = fmaf(hk, uk.z, au[r][2]);
            au[r][3] = fmaf(hk, uk.w, au[r][3]);
          }
        }
      } else {
#pragma unroll 2
        for (int k = 0; k < H; ++k) {
          const float4 uk = load4(Ul + (size_t)k * G4 + col);
          const float4 wk = load4(Wl + (size_t)k * G4 + col);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float hk = hp_s[r * H + k];
            const float yk = y_s[r * H + k];
            au[r][0] = fmaf(hk, uk.x, au[r][0]);
            au[r][1] = fmaf(hk, uk.y, au[r][1]);
            au[r][2] = fmaf(hk, uk.z, au[r][2]);
            au[r][3] = fmaf(hk, uk.w, au[r][3]);
            aw[r][0] = fmaf(yk, wk.x, aw[r][0]);
            aw[r][1] = fmaf(yk, wk.y, aw[r][1]);
            aw[r][2] = fmaf(yk, wk.z, aw[r][2]);
            aw[r][3] = fmaf(yk, wk.w, aw[r][3]);
          }
        }
      }
      float4 bias = make_float4(0.f, 0.f, 0.f, 0.f);
      if (l > 0) bias = load4(bs + (size_t)l * G4 + col);
      const float bq[4] = {round_xw<XW_BF16>(bias.x),
                           round_xw<XW_BF16>(bias.y),
                           round_xw<XW_BF16>(bias.z),
                           round_xw<XW_BF16>(bias.w)};
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= nrows) continue;
        float xv[4];
        if (l == 0) {
          const float4 x = load4(xw0 + (size_t)(b0 + r) * G4 + col);
          xv[0] = x.x; xv[1] = x.y; xv[2] = x.z; xv[3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xv[e] = round_xw<XW_BF16>(round_xw<XW_BF16>(aw[r][e]) + bq[e]);
        }
        float* gr = gates_s + r * G4 + col;
#pragma unroll
        for (int e = 0; e < 4; ++e) gr[e] = xv[e] + au[r][e];
      }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
      const int r = idx / H, j = idx % H;
      const float* gr = gates_s + r * G4;
      const float i_g = sigmoid(gr[j]);
      const float f_g = sigmoid(gr[H + j]);
      const float g_g = tanhf(gr[2 * H + j]);
      const float o_g = sigmoid(gr[3 * H + j]);
      const float c = f_g * c0[state0 + idx] + i_g * g_g;
      const HT h = from_f32<HT>(o_g * tanhf(c));
      hn[state0 + idx] = h;
      cn[state0 + idx] = c;
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
  const float* c0;
  void* hn;
  float* cn;
  int L, B, H;
  int w_bf16, u_bf16, xw_bf16, h_bf16;
  cudaStream_t stream;
};

template <typename WT, typename UT, typename XT, typename HT, int RB>
int launch_rb(const DecodeArgs& a) {
  auto kernel = decode_kernel<WT, UT, XT, HT, RB>;
  const size_t smem = sizeof(float) * RB * 6 * (size_t)a.H;
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.B + RB - 1) / RB);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const XT*>(a.xw0), static_cast<const WT*>(a.Ws),
      static_cast<const WT*>(a.bs), static_cast<const UT*>(a.Us),
      static_cast<const HT*>(a.h0), a.c0, static_cast<HT*>(a.hn), a.cn, a.L,
      a.B, a.H);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace lstm

// Plain C entry point (bound with ctypes).  Layouts, all contiguous:
// xw0 (B, 4, H); Ws (L, H, 4, H) and bs (L, 4, H) in one dtype; Us
// (L, H, 4, H) in Ws's dtype or, under bf16 Ws, fp32 (the fake-quantized
// U of a bf16 stack under a reduced recurrent-weight precision); h0
// (L, B, H); c0 (L, B, H) fp32; outputs hn (L, B, H) in h0's dtype and
// cn (L, B, H) fp32.  *_bf16 flags pick bfloat16 over fp32 per operand
// (fp32 Ws with bf16 Us is refused: the wrapper upcasts such a U).
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int lstm_decode_launch(const void* xw0, const void* Ws,
                                  const void* bs, const void* Us,
                                  const void* h0, const void* c0, void* hn,
                                  void* cn, int L, int B, int H, int w_bf16,
                                  int u_bf16, int xw_bf16, int h_bf16,
                                  void* stream) {
  lstm::DecodeArgs a{xw0, Ws, bs, Us, h0, static_cast<const float*>(c0),
                     hn, static_cast<float*>(cn), L, B, H, w_bf16, u_bf16,
                     xw_bf16, h_bf16, static_cast<cudaStream_t>(stream)};
  if (a.w_bf16)
    return a.u_bf16 ? lstm::launch_x<lstm::bf16, lstm::bf16>(a)
                    : lstm::launch_x<lstm::bf16, float>(a);
  return a.u_bf16 ? static_cast<int>(cudaErrorInvalidValue)
                  : lstm::launch_x<float, float>(a);
}
