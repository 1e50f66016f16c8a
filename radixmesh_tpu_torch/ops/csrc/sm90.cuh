// Hopper (sm_90a) building blocks of the paged-attention kernels: mbarrier
// rings, TMA and bulk copies, named barriers, proxy fences, register
// re-allocation, and the pool's TMA tensor map, encoded on the host through
// the driver entry point that the runtime hands out (so the libraries link
// no -lcuda) and cached per pool.
#pragma once

#include <cuda.h>

#include <cmath>
#include <mutex>

#include "common.cuh"

namespace radixmesh {

// ---------------------------------------------------------------------------
// device side
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` more of asynchronous copies.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival once every cp.async this thread issued before it has landed
// (the barrier's count includes it: .noinc).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed. A
// phase that never completes is a bug: after ~2^26 polls (seconds) the
// kernel traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// TMA: a box of a 2-D tensor map at (column c0, row c1) into shared
// memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Brings a tensor map (a kernel parameter) and a global line in early, so
// that the first TMA or lookup does not wait for them.
__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// A contiguous bulk copy global -> shared of `bytes` (a multiple of 16,
// both ends 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Generic-proxy accesses to shared memory (st.shared, cp.async) ordered
// before later async-proxy ones (wgmma operand reads, TMA writes).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers over `n` threads (barrier 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x on the SFU (ex2.approx, flush to zero): the softmax's exponentials
// where the output is bf16.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of byte `byte` of row `row` in a tile of ROWS rows stored as
// column blocks of [ROWS][BLOCK bytes]. 128-byte blocks are 128-byte
// swizzled (16-byte unit c of a row lands at c ^ (row & 7)): the layout
// TMA writes with CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned
// tile, and the one wgmma's SW128 descriptors read. Narrower blocks are
// plain rows.
template <int ROWS, int BLOCK = 128>
__device__ __forceinline__ int tile_at(int row, int byte) {
  const int blk = byte / BLOCK, in = byte % BLOCK;
  const int unit = BLOCK == 128 ? ((in >> 4) ^ (row & 7)) : (in >> 4);
  return blk * (ROWS * BLOCK) + row * BLOCK + (unit << 4) + (in & 15);
}

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// Cross-CTA merge of a split: the last CTA of a group to finish, counted
// by `counter`, returns true (and puts the counter back to 0 for the next
// launch on this stream). Every thread of the `n`-thread named barrier
// `bar_id` calls it after writing its partials; `flag` is a shared int.
// The barrier orders the CTA's writes before the leader's release fence
// and count (fences are cumulative); the last CTA's leader acquires the
// others' before the barrier that lets its threads read them.
__device__ __forceinline__ bool last_of_split(int* counter, int parts, int* flag, int bar_id,
                                              int n, bool leader) {
  bar_sync(bar_id, n);
  if (leader) {
    fence_acq_rel_gpu();
    const int prev = atomicAdd(counter, 1);
    const bool last = prev == parts - 1;
    if (last) {
      *counter = 0;  // every part has counted: nobody reads it again
      fence_acq_rel_gpu();
    }
    *flag = last;
  }
  bar_sync(bar_id, n);
  return *flag != 0;
}

// ---------------------------------------------------------------------------
// host side: the pool's tensor map
// ---------------------------------------------------------------------------

// Rows of the kernels' TMA boxes over a pool of `page`-token pages: the
// largest power of two that divides the page, at most `tile` (so a box
// never crosses a page or a tile). Pages that are not a multiple of 8
// tokens are gathered row by row; their (unused) map takes boxes of 8.
inline int box_rows_of(int page, int tile) {
  if (page & 7) return 8;
  const int low = page & -page;
  return low < tile ? low : tile;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once through the
// runtime (no -lcuda at link time); nullptr if the driver lacks it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D tensor map over `rows` rows of `cols` elements (`elem` bytes each,
// rows contiguous) with boxes of box_cols x box_rows. The pool is
// allocated once per engine, so the map is encoded once per (pointer,
// shape, box) and then served from this cache.
inline cudaError_t tensor_map_2d(CUtensorMap* out, const void* base, uint64_t rows, int cols,
                                 CUtensorMapDataType dtype, int elem, int box_cols, int box_rows,
                                 CUtensorMapSwizzle swizzle) {
  struct Entry {
    const void* base;
    uint64_t rows;
    int cols, dtype, box_cols, box_rows, swizzle;
    CUtensorMap map;
  };
  constexpr int kEntries = 32;
  static Entry cache[kEntries];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.base == base && e.rows == rows && e.cols == cols && e.dtype == (int)dtype &&
        e.box_cols == box_cols && e.box_rows == box_rows && e.swizzle == (int)swizzle) {
      *out = e.map;
      return cudaSuccess;
    }
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  Entry e{base, rows, cols, (int)dtype, box_cols, box_rows, (int)swizzle, {}};
  const CUresult r = encode(&e.map, dtype, 2, const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const int slot = used < kEntries ? used++ : next++ % kEntries;
  cache[slot] = e;
  *out = e.map;
  return cudaSuccess;
}

}  // namespace radixmesh
