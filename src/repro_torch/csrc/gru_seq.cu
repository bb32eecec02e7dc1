// gru_seq: G independent GRU recurrences over T steps in ONE launch.
//
// Replaces the TPU kernel gru_seq_pallas / _seq_kernel
// (src/repro/kernels/gru_cell/kernel.py:111 / :31).  Same function: per
// step hu = h . U (gate order z, r, n), z = sigmoid(xw_z + hu_z),
// r = sigmoid(xw_r + hu_r), n = tanh(xw_n + r * hu_n),
// h = (1 - z) * n + z * h; masked rows (b_mask == 0) freeze h, and hs
// repeats it; hs and h_T come out in h0's dtype.  There is no cell state.
//
// What bounds it on an H100: each step reads all of U (H x 3H; 0.69 MB in
// bf16, 1.39 MB in fp32 at H = 340) and depends on the previous step's h,
// so one recurrence is a chain of T small matrix-vector products.  As in
// lstm_seq.cu, the time loop runs inside one block per (g, group of up to
// 4 batch rows), so the step rate is bound by how fast ONE SM streams U
// out of L2 (U stays resident in the 50 MB L2 across steps) and by that
// SM's FMA rate, not by device memory.
//
// What the design does about it: h stays in shared memory in fp32 for the
// whole walk (the Pallas kernel's VMEM scratch, kernel.py:151-154); each U
// element is loaded once per step and reused across the block's rows;
// loads are four columns wide when H % 4 == 0.  The reset gate couples the
// recurrent product multiplicatively (n = tanh(xw_n + r * hu_n),
// kernel.py:93), so hu_n cannot be pre-summed with xw_n the way LSTM gates
// are: phase 1 keeps the raw h . U of all three gates in shared memory and
// phase 2 applies r only once it is known.  3H columns are a multiple of
// four only when H is, so an H % 4 != 0 takes the scalar (VEC = 1)
// instantiation instead of the vector loads, which would read out of line.
//
// The reference's two weight branches (kernel.py:69-89), chosen at run
// time as in lstm_seq.cu: int8 U (`scales` given) is upcast without its
// scale and accumulated in fp32, and the per-gate scale multiplies the raw
// h . U of all three gates in phase 1 — BEFORE phase 2 couples r * hu_n
// into the candidate (kernel.py:88-93), so the gates see (h . Uq) * s;
// row-compacted U (`rows` given) runs the dot over its Ha rows with h
// gathered through the row index, padding rows adding exactly 0.0.
//
// Numerics copied from the reference: U is upcast to fp32 before the
// product and accumulated in fp32; h is seeded from h0 in fp32, carried in
// fp32 between steps and rounded to h0's dtype only where it is stored
// (hs, h_T; kernel.py:66, :103-108), so block_t (a planning parameter)
// cannot change the result.

#include "rnn_common.cuh"

namespace gru {

using namespace rnn;

template <typename UT, typename XT, typename HT, int RB, int VEC>
__global__ void __launch_bounds__(kThreads)
seq_kernel(const UT* __restrict__ U, const float* __restrict__ scales,
           const int* __restrict__ rows, const XT* __restrict__ xw,
           const HT* __restrict__ h0, const int* __restrict__ mask,
           HT* __restrict__ hs, HT* __restrict__ hT, int B, int T, int H,
           int Hr) {
  extern __shared__ float smem[];
  const int G3 = 3 * H;
  float* h_s = smem;          // RB x H   recurrent h, fp32
  float* hu_s = h_s + RB * H; // RB x 3H  this step's raw h . U
  int* rows_s = reinterpret_cast<int*>(hu_s + RB * G3);  // Hr (sparse)

  const int g = blockIdx.x;
  const int b0 = blockIdx.y * RB;
  const int nrows = min(RB, B - b0);
  const UT* Ug = U + (size_t)g * Hr * G3;
  const float* scales_g = scales == nullptr ? nullptr : scales + 3 * g;
  const size_t row0 = (size_t)g * B + b0;  // first (g, b) row of the block

  for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x) {
    const int r = idx / H;
    // rows past B stay zero and are never stored
    h_s[idx] = r < nrows ? to_f32(h0[(row0 + r) * H + idx % H]) : 0.f;
  }
  if (rows != nullptr)
    for (int k = threadIdx.x; k < Hr; k += blockDim.x)
      rows_s[k] = rows[(size_t)g * Hr + k];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // phase 1: hu[r, col] = sum_k h[r, k] * U[k, col], VEC columns a
    // thread (times the gate's scale for int8 U; over the gathered rows of
    // h for row-compacted U)
    for (int q = threadIdx.x; q < G3 / VEC; q += blockDim.x) {
      const int col = VEC * q;
      float acc[RB][VEC];
      if (rows != nullptr)
        recurrent_dot<true>(Ug + col, G3, h_s, rows_s, Hr, H, acc);
      else
        recurrent_dot<false>(Ug + col, G3, h_s, rows_s, Hr, H, acc);
      if (scales_g != nullptr) scale_acc(scales_g, col, H, acc);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nrows) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) hu_s[r * G3 + col + e] = acc[r][e];
        }
      }
    }
    __syncthreads();

    // phase 2: the gates and the update, one (row, unit) per thread; the
    // reset gate scales the n gate's recurrent product only
    for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
      const int r = idx / H, j = idx % H;
      const XT* x = xw + ((row0 + r) * T + t) * G3;
      const float* hu = hu_s + r * G3;
      const float z = sigmoid(to_f32(x[j]) + hu[j]);
      const float rg = sigmoid(to_f32(x[H + j]) + hu[H + j]);
      const float n = tanhf(to_f32(x[2 * H + j]) + rg * hu[2 * H + j]);
      const float h_new = (1.f - z) * n + z * h_s[idx];
      if (mask == nullptr || mask[row0 + r] != 0) h_s[idx] = h_new;
      hs[((row0 + r) * T + t) * H + j] = from_f32<HT>(h_s[idx]);
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x)
    hT[(row0 + idx / H) * H + idx % H] = from_f32<HT>(h_s[idx]);
}

struct SeqArgs {
  const void* U;
  const float* scales;
  const int* rows;
  const void* xw;
  const void* h0;
  const int* mask;
  void* hs;
  void* hT;
  int G, B, T, H, Hr;
  int u_type, xw_bf16, h_bf16;
  cudaStream_t stream;
};

template <typename UT, typename XT, typename HT, int RB, int VEC>
int launch_vec(const SeqArgs& a) {
  auto kernel = seq_kernel<UT, XT, HT, RB, VEC>;
  const size_t smem = sizeof(float) * RB * 4 * (size_t)a.H +
                      (a.rows != nullptr ? sizeof(int) * (size_t)a.Hr : 0);
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.G, (a.B + RB - 1) / RB);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const UT*>(a.U), a.scales, a.rows,
      static_cast<const XT*>(a.xw), static_cast<const HT*>(a.h0), a.mask,
      static_cast<HT*>(a.hs), static_cast<HT*>(a.hT), a.B, a.T, a.H, a.Hr);
  return static_cast<int>(cudaGetLastError());
}

template <typename UT, typename XT, typename HT, int RB>
int launch_rb(const SeqArgs& a) {
  return a.H % 4 == 0 ? launch_vec<UT, XT, HT, RB, 4>(a)
                      : launch_vec<UT, XT, HT, RB, 1>(a);
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

}  // namespace gru

// Plain C entry point (bound with ctypes).  Layouts, all contiguous:
// U (G, Hr, 3, H) with Hr = H, or Hr = Ha rows when `rows` is given;
// scales (G, 3) fp32 or NULL; rows (G, Ha) int32 or NULL; xw (G, B, T, 3,
// H); h0 (G, B, H); mask (G, B) int32 or NULL; outputs hs (G, B, T, H) and
// hT (G, B, H) in h0's dtype.  u_type picks U's type (0 fp32, 1 bf16, 2
// int8, which comes with scales); *_bf16 flags pick bfloat16 over fp32 for
// xw and h.  Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int gru_seq_launch(const void* U, const void* scales,
                              const void* rows, const void* xw,
                              const void* h0, const void* mask, void* hs,
                              void* hT, int G, int B, int T, int H, int Hr,
                              int u_type, int xw_bf16, int h_bf16,
                              void* stream) {
  gru::SeqArgs a{U, static_cast<const float*>(scales),
                 static_cast<const int*>(rows), xw, h0,
                 static_cast<const int*>(mask), hs, hT, G, B, T, H, Hr,
                 u_type, xw_bf16, h_bf16,
                 static_cast<cudaStream_t>(stream)};
  switch (a.u_type) {
    case 0: return gru::launch_x<float>(a);
    case 1: return gru::launch_x<gru::bf16>(a);
    case 2: return gru::launch_x<int8_t>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
