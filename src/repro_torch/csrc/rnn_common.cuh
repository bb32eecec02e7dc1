// Helpers shared by the kernels (lstm_seq, lstm_decode, lstm_cell,
// gru_seq, gru_decode, mvm_tile, decode_attention): dtype conversion (fp32,
// bf16, and the int8 recurrent weights of the sequence kernels), vector
// loads, the gate activations and the two cells, and the launch shape.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rnn {

typedef __nv_bfloat16 bf16;

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

// The cell updates of the cluster kernels (decode_cluster.cuh,
// seq_cluster.cuh): one hidden unit from its G input halves xw and its G
// recurrent products hu, both fp32.
struct LstmCell {
  static constexpr int G = 4;
  static constexpr bool kHasC = true;
  // gate order i, f, g, o; returns h (fp32), c through `c`
  __device__ static float update(const float (&xw)[4], const float (&hu)[4],
                                 float, float c_prev, float& c) {
    const float i_g = sigmoid(xw[0] + hu[0]);
    const float f_g = sigmoid(xw[1] + hu[1]);
    const float g_g = tanhf(xw[2] + hu[2]);
    const float o_g = sigmoid(xw[3] + hu[3]);
    c = f_g * c_prev + i_g * g_g;
    return o_g * tanhf(c);
  }
};

struct GruCell {
  static constexpr int G = 3;
  static constexpr bool kHasC = false;
  // gate order z, r, n; the reset gate scales the n gate's recurrent
  // product only; returns h (fp32)
  __device__ static float update(const float (&xw)[3], const float (&hu)[3],
                                 float h_prev, float, float&) {
    const float z = sigmoid(xw[0] + hu[0]);
    const float rg = sigmoid(xw[1] + hu[1]);
    const float n = tanhf(xw[2] + rg * hu[2]);
    return (1.f - z) * n + z * h_prev;
  }
};

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
