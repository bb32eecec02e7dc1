// Helpers shared by the recurrent kernels (lstm_seq, lstm_decode,
// lstm_cell, gru_seq, gru_decode): dtype conversion, vector column loads,
// the gate activations, and the launch shape.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rnn {

typedef __nv_bfloat16 bf16;

// Threads per block of the sequence and decode kernels.  Phase 1 of a step
// gives each thread one vector of adjacent gate columns, so up to 4H <= 2048
// (LSTM) or 3H <= 2048 (GRU) every vector has its own thread; phase 2 walks
// the rows x H cells.
constexpr int kThreads = 512;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

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

// VEC adjacent elements as fp32: VEC = 4 is one aligned vector load (see
// load4), VEC = 1 a scalar load that needs no alignment.  The GRU kernels
// take VEC = 4 only when H % 4 == 0, so that every 3H-wide row starts on a
// multiple of four elements.
template <int VEC, typename T>
__device__ __forceinline__ void loadv(const T* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 v = load4(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = to_f32(p[e]);
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
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
