// lstm_seq: G independent LSTM recurrences over T steps in ONE launch.
//
// Replaces the TPU kernel lstm_seq_pallas / _seq_kernel
// (src/repro/kernels/lstm_cell/kernel.py:205 / :113).  Same function: per
// step gates = xw[:, t] + h . U (gate order i, f, g, o), c = f*c + i*g,
// h = o*tanh(c); masked rows (b_mask == 0) freeze h and c; hs and h_T come
// out in h0's dtype, c_T in fp32.
//
// What bounds it on an H100: each step reads all of U (H x 4H; 0.92 MB in
// bf16, 1.85 MB in fp32 at H = 340) and depends on the previous step's h,
// so one recurrence is a chain of T small matrix-vector products.  A CUDA
// grid gives no order between blocks, so the time loop runs inside one
// block per (g, group of up to 4 batch rows): the step rate of one
// recurrence is bound by how fast ONE SM can stream U out of L2 (U fits
// the 50 MB L2 and stays there across steps) and by that SM's FMA rate,
// not by device memory.
//
// What the design does about it: (h, c) stay in shared memory in fp32 for
// the whole walk (the Pallas kernel's VMEM scratch, kernel.py:151-154), so
// state never leaves the SM between steps; each U element is loaded once
// per step and reused across the block's rows; loads are four columns
// wide; xw streams in per step.  Batch rows are independent, so blocks
// need no barrier between them.  Spreading one recurrence over a cluster
// of SMs (h exchanged through distributed shared memory each step) is
// later work (ROADMAP.md, Queue 2).
//
// The reference's two weight branches (kernel.py:170-177), both chosen at
// run time so they add no kernel instances beyond one U type:
//  - int8 U (`scales` given): the payload is upcast to fp32 WITHOUT its
//    scale and accumulated in fp32; the per-gate scale then multiplies the
//    (rows, 4, H) accumulate before xw is added, as (h . Uq) * s.  h is
//    never quantized.  An int8 U is a quarter of fp32's bytes per step.
//  - row-compacted U (`rows` given): U holds only the Ha rows whose
//    8-row tiles are not all zero, and the dot runs over those Ha rows with
//    h gathered from the block's fp32 h in shared memory through the row
//    index (staged in shared memory once per launch).  Padding rows are
//    zero U rows at index 0 and add exactly 0.0.
//
// Numerics copied from the reference: U is upcast to fp32 before the
// product and accumulated in fp32; h is carried in fp32 between steps and
// rounded to h0's dtype only where it is stored (hs, h_T), so block_t
// (a planning parameter) cannot change the result.

#include "rnn_common.cuh"

namespace lstm {

using namespace rnn;

template <typename UT, typename XT, typename HT, int RB>
__global__ void __launch_bounds__(kThreads)
seq_kernel(const UT* __restrict__ U, const float* __restrict__ scales,
           const int* __restrict__ rows, const XT* __restrict__ xw,
           const HT* __restrict__ h0, const float* __restrict__ c0,
           const int* __restrict__ mask, HT* __restrict__ hs,
           HT* __restrict__ hT, float* __restrict__ cT, int B, int T, int H,
           int Hr) {
  extern __shared__ float smem[];
  const int G4 = 4 * H;
  float* h_s = smem;              // RB x H   recurrent h, fp32
  float* c_s = h_s + RB * H;      // RB x H   cell state, fp32
  float* gates_s = c_s + RB * H;  // RB x 4H  this step's pre-activations
  int* rows_s = reinterpret_cast<int*>(gates_s + RB * G4);  // Hr (sparse)

  const int g = blockIdx.x;
  const int b0 = blockIdx.y * RB;
  const int nrows = min(RB, B - b0);
  const UT* Ug = U + (size_t)g * Hr * G4;
  const float* scales_g = scales == nullptr ? nullptr : scales + 4 * g;
  const size_t row0 = (size_t)g * B + b0;  // first (g, b) row of the block

  for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x) {
    const int r = idx / H;
    float hv = 0.f, cv = 0.f;  // rows past B stay zero and are never stored
    if (r < nrows) {
      const size_t o = (row0 + r) * H + idx % H;
      hv = to_f32(h0[o]);
      cv = c0[o];
    }
    h_s[idx] = hv;
    c_s[idx] = cv;
  }
  if (rows != nullptr)
    for (int k = threadIdx.x; k < Hr; k += blockDim.x)
      rows_s[k] = rows[(size_t)g * Hr + k];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // phase 1: gates[r, col] = xw[r, t, col] + sum_k h[r, k] * U[k, col]
    // (times the gate's scale for int8 U; over the gathered rows of h for
    // row-compacted U)
    for (int q = threadIdx.x; q < H; q += blockDim.x) {
      const int col = 4 * q;
      float acc[RB][4];
      if (rows != nullptr)
        recurrent_dot<true>(Ug + col, G4, h_s, rows_s, Hr, H, acc);
      else
        recurrent_dot<false>(Ug + col, G4, h_s, rows_s, Hr, H, acc);
      if (scales_g != nullptr) scale_acc(scales_g, col, H, acc);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nrows) {
          const float4 x = load4(xw + ((row0 + r) * T + t) * G4 + col);
          float* gr = gates_s + r * G4 + col;
          gr[0] = x.x + acc[r][0];
          gr[1] = x.y + acc[r][1];
          gr[2] = x.z + acc[r][2];
          gr[3] = x.w + acc[r][3];
        }
      }
    }
    __syncthreads();

    // phase 2: the pointwise tail, one (row, unit) per thread
    for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
      const int r = idx / H, j = idx % H;
      const float* gr = gates_s + r * G4;
      const float i_g = sigmoid(gr[j]);
      const float f_g = sigmoid(gr[H + j]);
      const float g_g = tanhf(gr[2 * H + j]);
      const float o_g = sigmoid(gr[3 * H + j]);
      const float c_new = f_g * c_s[idx] + i_g * g_g;
      const float h_new = o_g * tanhf(c_new);
      if (mask == nullptr || mask[row0 + r] != 0) {
        c_s[idx] = c_new;
        h_s[idx] = h_new;
      }
      hs[((row0 + r) * T + t) * H + j] = from_f32<HT>(h_s[idx]);
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
    const size_t o = (row0 + idx / H) * H + idx % H;
    hT[o] = from_f32<HT>(h_s[idx]);
    cT[o] = c_s[idx];
  }
}

struct SeqArgs {
  const void* U;
  const float* scales;
  const int* rows;
  const void* xw;
  const void* h0;
  const float* c0;
  const int* mask;
  void* hs;
  void* hT;
  float* cT;
  int G, B, T, H, Hr;
  int u_type, xw_bf16, h_bf16;
  cudaStream_t stream;
};

template <typename UT, typename XT, typename HT, int RB>
int launch_rb(const SeqArgs& a) {
  auto kernel = seq_kernel<UT, XT, HT, RB>;
  const size_t smem = sizeof(float) * RB * 6 * (size_t)a.H +
                      (a.rows != nullptr ? sizeof(int) * (size_t)a.Hr : 0);
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.G, (a.B + RB - 1) / RB);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const UT*>(a.U), a.scales, a.rows,
      static_cast<const XT*>(a.xw), static_cast<const HT*>(a.h0), a.c0,
      a.mask, static_cast<HT*>(a.hs), static_cast<HT*>(a.hT), a.cT, a.B,
      a.T, a.H, a.Hr);
  return static_cast<int>(cudaGetLastError());
}

template <typename UT, typename XT, typename HT>
int launch_typed(const SeqArgs& a) {
  switch (rows_per_block(a.B)) {
    case 1: return launch_rb<UT, XT, HT, 1>(a);
    case 2: return launch_rb<UT, XT, HT, 2>(a);
    default: return launch_rb<UT, XT, HT, 4>(a);
  }
}

template <typename UT, typename XT>
int launch_h(const SeqArgs& a) {
  return a.h_bf16 ? launch_typed<UT, XT, bf16>(a)
                  : launch_typed<UT, XT, float>(a);
}

template <typename UT>
int launch_x(const SeqArgs& a) {
  return a.xw_bf16 ? launch_h<UT, bf16>(a) : launch_h<UT, float>(a);
}

}  // namespace lstm

// Plain C entry point (bound with ctypes).  Layouts, all contiguous:
// U (G, Hr, 4, H) with Hr = H, or Hr = Ha rows when `rows` is given;
// scales (G, 4) fp32 or NULL; rows (G, Ha) int32 or NULL; xw (G, B, T, 4,
// H); h0 (G, B, H); c0 (G, B, H) fp32; mask (G, B) int32 or NULL; outputs
// hs (G, B, T, H) and hT (G, B, H) in h0's dtype, cT (G, B, H) fp32.
// u_type picks U's type (0 fp32, 1 bf16, 2 int8, which comes with
// scales); *_bf16 flags pick bfloat16 over fp32 for xw and h.  Launches
// on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int lstm_seq_launch(const void* U, const void* scales,
                               const void* rows, const void* xw,
                               const void* h0, const void* c0,
                               const void* mask, void* hs, void* hT,
                               void* cT, int G, int B, int T, int H, int Hr,
                               int u_type, int xw_bf16, int h_bf16,
                               void* stream) {
  lstm::SeqArgs a{U, static_cast<const float*>(scales),
                  static_cast<const int*>(rows), xw, h0,
                  static_cast<const float*>(c0),
                  static_cast<const int*>(mask), hs, hT,
                  static_cast<float*>(cT), G, B, T, H, Hr, u_type, xw_bf16,
                  h_bf16, static_cast<cudaStream_t>(stream)};
  switch (a.u_type) {
    case 0: return lstm::launch_x<float>(a);
    case 1: return lstm::launch_x<lstm::bf16>(a);
    case 2: return lstm::launch_x<int8_t>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
