// Helpers shared by the kernels (lstm_seq, lstm_decode, lstm_cell,
// gru_seq, gru_decode, mvm_tile, decode_attention): dtype conversion (fp32,
// bf16, and the int8 recurrent weights of the sequence kernels), vector
// loads, the gate activations, and the launch shape.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rnn {

typedef __nv_bfloat16 bf16;

// Threads per block of the sequence kernels.  Phase 1 of a step
// gives each thread one vector of adjacent gate columns, so up to 4H <= 2048
// (LSTM) or 3H <= 2048 (GRU) every vector has its own thread; phase 2 walks
// the rows x H cells.
constexpr int kThreads = 512;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
// int8 weights are upcast without their scale (exact: |q| <= 127)
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// round to nearest even, as a cast to bfloat16 does in PyTorch and XLA
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four adjacent elements as fp32.  The caller guarantees 4-element
// alignment: every quad starts at a multiple of 4 elements of a row whose
// length is a multiple of 4, and the Python wrapper hands over 16-byte
// aligned base pointers.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  uint2 v = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  return make_float4(v.x, v.y, v.z, v.w);
}

// Eight adjacent bf16 elements as fp32: one 16-byte load (the caller
// guarantees 8-element alignment of p).
__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// VEC adjacent elements as fp32: VEC = 4 is one aligned vector load (see
// load4), VEC = 8 (bf16 only) one aligned 16-byte load (load8), VEC = 1 a
// scalar load that needs no alignment.  The GRU kernels take VEC = 4 only
// when H % 4 == 0, so that every 3H-wide row starts on a multiple of four
// elements.
template <int VEC, typename T>
__device__ __forceinline__ void loadv(const T* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 v = load4(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (VEC == 8) {
    load8(p, out);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = to_f32(p[e]);
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The recurrent product of the sequence kernels, for one thread's VEC
// adjacent columns u[0 .. VEC) of every U row and the block's RB batch
// rows: acc[r][e] += h[r][k] * U[k][e] over the Hr rows of U, in fp32.
// Dense U (SPARSE = false) has Hr = H rows and row k reads h[k];
// row-compacted U (SPARSE = true) has Hr = Ha rows and row k reads
// h[rows_s[k]], the h gather of the reference's block-sparse branch.
// Padding rows are zero U rows with index 0, so they add exactly 0.0.
template <bool SPARSE, int RB, int VEC, typename UT>
__device__ __forceinline__ void recurrent_dot(const UT* __restrict__ u,
                                              size_t ld,
                                              const float* __restrict__ h_s,
                                              const int* __restrict__ rows_s,
                                              int Hr, int H,
                                              float (&acc)[RB][VEC]) {
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
#pragma unroll 4
  for (int k = 0; k < Hr; ++k) {
    float uk[VEC];
    loadv<VEC>(u + (size_t)k * ld, uk);
    const int hk_idx = SPARSE ? rows_s[k] : k;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float hk = h_s[r * H + hk_idx];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(hk, uk[e], acc[r][e]);
    }
  }
}

// The int8 branch's per-gate scale on the fp32 accumulate, after the dot
// and before anything else touches it (__fmul_rn: a rounded product, never
// contracted into the following add, as the reference computes it).
// scales_g is the cell's (gates,) row; column c belongs to gate c / H.
template <int RB, int VEC>
__device__ __forceinline__ void scale_acc(const float* __restrict__ scales_g,
                                          int col, int H,
                                          float (&acc)[RB][VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float s = scales_g[(col + e) / H];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r][e] = __fmul_rn(acc[r][e], s);
  }
}

// Rows of the batch one block owns: 4 when there are at least 3 rows,
// else the row count itself, so a single-row launch does no dead FMAs.
inline int rows_per_block(int B) { return B >= 3 ? 4 : B; }

// Opt the kernel in to more than 48 KB of dynamic shared memory when its
// working set needs it; the H100 gives a block at most 227 KB.
template <typename K>
inline cudaError_t reserve_smem(K kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rnn
