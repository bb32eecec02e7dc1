// lstm_cell: ONE LSTM step, h . U as a tiled product with the gate and
// cell epilogue in the same block.
//
// Replaces the TPU kernel lstm_cell_pallas / _kernel
// (src/repro/kernels/lstm_cell/kernel.py:76 / :39).  Same function:
// gates = h . U + xw_t (gate order i, f, g, o), c = f * c_prev + i * g,
// h = o * tanh(c); h comes out in h_prev's dtype, c in fp32.  The Pallas
// grid is (j over H output columns, k over the reduction) with an fp32
// accumulator and a masked reduction tail (kernel.py:48-55); here one
// block owns block_h hidden units across all four gates (so the epilogue
// stays in the block) and loops over the reduction in block_k stripes,
// adding each stripe's partial sum to the fp32 accumulator.  block_h and
// block_k are planning parameters: they change the fp32 summation order
// and nothing else.  The last stripe stops at H, which is the reduction
// tail's mask.
//
// What bounds it on an H100: a step reads U (H x 4H; 0.46 MB in bf16,
// 0.92 MB in fp32 at H = 340) once and does 8 B H^2 operations, well
// under a microsecond of memory traffic.  The per_step schedule launches
// it once per (layer, step) (150 launches for a BYSDNE forward at T = 30),
// so the launch overhead, not the bound, sets its time on the main path.
//
// What the design does about it: nothing yet, deliberately (the per_step
// schedule exists to price that overhead).  The block stages its rows'
// h once in shared memory in fp32, each thread owns one hidden unit's four
// gate columns for up to 4 rows, and U loads are coalesced along the unit
// axis.  c_prev is read as fp32 (the wrapper upcasts other float dtypes,
// which is exact).

#include "rnn_common.cuh"

namespace lstm {

using namespace rnn;

template <typename UT, typename XT, typename HT, int RB>
__global__ void cell_kernel(const UT* __restrict__ U,
                            const XT* __restrict__ xw,
                            const HT* __restrict__ h,
                            const float* __restrict__ c,
                            HT* __restrict__ h_out,
                            float* __restrict__ c_out, int B, int H,
                            int block_h, int block_k) {
  extern __shared__ float h_s[];  // RB x H  the rows' h_prev, fp32
  const int G4 = 4 * H;
  const int b0 = blockIdx.y * RB;
  const int nrows = min(RB, B - b0);
  for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x)
    h_s[idx] = idx / H < nrows ? to_f32(h[(size_t)b0 * H + idx]) : 0.f;
  __syncthreads();

  const int j_end = min(H, (blockIdx.x + 1) * block_h);
  for (int j = blockIdx.x * block_h + threadIdx.x; j < j_end;
       j += blockDim.x) {
    float acc[RB][4];
#pragma unroll
    for (int r = 0; r < RB; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    for (int k0 = 0; k0 < H; k0 += block_k) {
      const int k1 = min(H, k0 + block_k);  // the masked reduction tail
      float part[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        part[r][0] = part[r][1] = part[r][2] = part[r][3] = 0.f;
      for (int k = k0; k < k1; ++k) {
        const UT* u = U + (size_t)k * G4 + j;
        const float u0 = to_f32(u[0]), u1 = to_f32(u[H]);
        const float u2 = to_f32(u[2 * H]), u3 = to_f32(u[3 * H]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float hk = h_s[r * H + k];
          part[r][0] = fmaf(hk, u0, part[r][0]);
          part[r][1] = fmaf(hk, u1, part[r][1]);
          part[r][2] = fmaf(hk, u2, part[r][2]);
          part[r][3] = fmaf(hk, u3, part[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] += part[r][g];
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r >= nrows) continue;
      const size_t row = (size_t)(b0 + r);
      const XT* x = xw + row * G4 + j;
      const float i_g = sigmoid(acc[r][0] + to_f32(x[0]));
      const float f_g = sigmoid(acc[r][1] + to_f32(x[H]));
      const float g_g = tanhf(acc[r][2] + to_f32(x[2 * H]));
      const float o_g = sigmoid(acc[r][3] + to_f32(x[3 * H]));
      const float c_new = f_g * c[row * H + j] + i_g * g_g;
      c_out[row * H + j] = c_new;
      h_out[row * H + j] = from_f32<HT>(o_g * tanhf(c_new));
    }
  }
}

struct CellArgs {
  const void* U;
  const void* xw;
  const void* h;
  const float* c;
  void* h_out;
  float* c_out;
  int B, H, block_h, block_k;
  int u_bf16, xw_bf16, h_bf16;
  cudaStream_t stream;
};

template <typename UT, typename XT, typename HT, int RB>
int launch_rb(const CellArgs& a) {
  auto kernel = cell_kernel<UT, XT, HT, RB>;
  const size_t smem = sizeof(float) * RB * (size_t)a.H;
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = (a.block_h + 31) / 32;
  const int threads = 32 * (warps < 8 ? warps : 8);
  dim3 grid((a.H + a.block_h - 1) / a.block_h, (a.B + RB - 1) / RB);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const UT*>(a.U), static_cast<const XT*>(a.xw),
      static_cast<const HT*>(a.h), a.c, static_cast<HT*>(a.h_out), a.c_out,
      a.B, a.H, a.block_h, a.block_k);
  return static_cast<int>(cudaGetLastError());
}

template <typename UT, typename XT, typename HT>
int launch_typed(const CellArgs& a) {
  switch (rows_per_block(a.B)) {
    case 1: return launch_rb<UT, XT, HT, 1>(a);
    case 2: return launch_rb<UT, XT, HT, 2>(a);
    default: return launch_rb<UT, XT, HT, 4>(a);
  }
}

template <typename UT, typename XT>
int launch_h(const CellArgs& a) {
  return a.h_bf16 ? launch_typed<UT, XT, bf16>(a)
                  : launch_typed<UT, XT, float>(a);
}

template <typename UT>
int launch_x(const CellArgs& a) {
  return a.xw_bf16 ? launch_h<UT, bf16>(a) : launch_h<UT, float>(a);
}

}  // namespace lstm

// Plain C entry point (bound with ctypes).  Layouts, all contiguous:
// U (H, 4, H); xw (B, 4, H); h (B, H); c (B, H) fp32; outputs h_out (B, H)
// in h's dtype and c_out (B, H) fp32.  block_h, block_k >= 1.  *_bf16
// flags pick bfloat16 over fp32 per operand.  Launches on `stream` and
// returns cudaGetLastError() (0 = ok).
extern "C" int lstm_cell_launch(const void* U, const void* xw, const void* h,
                                const void* c, void* h_out, void* c_out,
                                int B, int H, int block_h, int block_k,
                                int u_bf16, int xw_bf16, int h_bf16,
                                void* stream) {
  if (block_h < 1 || block_k < 1) return static_cast<int>(
      cudaErrorInvalidValue);
  lstm::CellArgs a{U, xw, h, static_cast<const float*>(c), h_out,
                   static_cast<float*>(c_out), B, H, block_h, block_k,
                   u_bf16, xw_bf16, h_bf16, static_cast<cudaStream_t>(stream)};
  return a.u_bf16 ? lstm::launch_x<lstm::bf16>(a) : lstm::launch_x<float>(a);
}
