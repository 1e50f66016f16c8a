// Shared helpers of the paged-attention kernels: element conversion,
// vector loads, warp reductions, int8 quantization and the finite mask
// value.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace radixmesh {

// exp(finite - kMask) == 0 without the NaN of -inf - -inf (the JAX
// kernels' _MASK).
constexpr float kMask = -0.7f * 3.402823466e+38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like torch's cast
}

template <int BYTES>
struct VecType;
template <>
struct VecType<2> { using type = uint16_t; };
template <>
struct VecType<4> { using type = uint32_t; };
template <>
struct VecType<8> { using type = uint2; };
template <>
struct VecType<16> { using type = uint4; };

// N consecutive elements at p (aligned to N * sizeof(T) bytes) as float,
// in one vector load.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[N]) {
  using V = typename VecType<N * sizeof(T)>::type;
  const V raw = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The int8 KV scheme of ops/quant.py, bit for bit: scale = max(amax,
// 1e-8) / 127 and q = round-half-even(x / scale) clipped to +-127, each an
// IEEE float32 operation (the build uses no fast-math flags, so the
// divisions stay correctly rounded). Returns q as a float.
__device__ __forceinline__ float kv_scale_of(float amax) { return fmaxf(amax, 1e-8f) / 127.0f; }
__device__ __forceinline__ float quantize_to(float x, float scale) {
  return fminf(fmaxf(rintf(x / scale), -127.0f), 127.0f);
}

}  // namespace radixmesh
