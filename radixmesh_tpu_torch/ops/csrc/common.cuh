// Shared helpers of the paged-attention kernels: element conversion,
// vector loads, warp reductions and the finite mask value.
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

}  // namespace radixmesh
