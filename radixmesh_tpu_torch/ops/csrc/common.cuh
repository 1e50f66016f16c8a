// Shared helpers of the paged-attention kernels: element conversion,
// vector loads, warp reductions, int8 quantization and the finite mask
// value.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !pred (nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four int8 values (one 32-bit word) as floats, exactly, without the
// quarter-rate int-to-float conversions: each byte, biased by 128, becomes
// the low byte of the float 2^23 + byte, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + k)) - 8388736.0f;
}

// The same four values as bf16 pairs: an integer with |x| <= 128 has at
// most 8 significant bits, so its bf16 is its float's upper half.
__device__ __forceinline__ uint2 int8x4_to_bf16x4(uint32_t w) {
  float f[4];
  int8x4_to_f32(w, f);
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// One 16-byte chunk of a K/V row in shared memory as 16 / sizeof(T)
// floats.
__device__ __forceinline__ void chunk_to_f32(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void chunk_to_f32(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void chunk_to_f32(const int8_t* p, float (&f)[16]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  int8x4_to_f32(v.x, f);
  int8x4_to_f32(v.y, f + 4);
  int8x4_to_f32(v.z, f + 8);
  int8x4_to_f32(v.w, f + 12);
}

// Pool slot of context token `tok` through a row's page table: shift and
// mask when `page` is a power of two (page_shift = log2(page), from
// page_shift_of), a division otherwise.
__device__ __forceinline__ int page_shift_of(int page) {
  return (page & (page - 1)) == 0 ? __ffs(page) - 1 : -1;
}
__device__ __forceinline__ int slot_of(const int* __restrict__ pt, int tok, int page,
                                       int page_shift) {
  if (page_shift >= 0) return (pt[tok >> page_shift] << page_shift) | (tok & (page - 1));
  return pt[tok / page] * page + tok % page;
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

// Raises one kernel's dynamic shared-memory limit once per device: the
// attribute stays with the function, so later launches skip that call.
// Keep one (function-local static) instance per kernel instance.
class SmemOptIn {
 public:
  template <typename Kernel>
  cudaError_t ensure(Kernel* kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices && done_[dev].load(std::memory_order_acquire)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && dev < kMaxDevices) done_[dev].store(true, std::memory_order_release);
    return err;
  }

 private:
  static constexpr int kMaxDevices = 64;
  std::atomic<bool> done_[kMaxDevices] = {};
};

}  // namespace radixmesh
