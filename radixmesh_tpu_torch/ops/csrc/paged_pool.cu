// Read-only paged pool attention for Hopper (sm_90a): the C entry point of
// the kFused = false instances of paged_decode.cuh (B3 of the port),
// which documents what the kernels compute, what they replace and what
// bounds them. Built as its own library so that it compiles in parallel
// with the fused decode kernels.

#include "paged_decode.cuh"

// q_dtype: 0 = float32, 1 = bfloat16; pool_dtype: the same, or 2 = int8
// with kv_scale [2, L, Hkv, num_slots] f32 (else nullptr). Attends
// lengths[b] pool tokens of `layer` per row; rows with lengths[b] <= 0
// output zeros. With splits > 1, ws is a float32 workspace of B * Hq *
// splits * (D + 2) elements and counters B * Hkv ints, all 0 (each launch
// leaves them 0). One launch on `stream`; allocates nothing and writes only
// `out`, `ws` and `counters`. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int paged_pool_launch(int q_dtype, int pool_dtype, const void* q,
                                 const void* kv, const void* kv_scale,
                                 const void* page_table, const void* lengths, void* out,
                                 void* ws, void* counters, int B, int Hq, int Hkv, int D, int L,
                                 int num_slots, int page, int max_pages, int layer,
                                 int splits, int span, void* stream) {
  using namespace radixmesh;
  const AttendArgs a{q, nullptr, nullptr, const_cast<void*>(kv),
                     static_cast<float*>(const_cast<void*>(kv_scale)), nullptr,
                     static_cast<const int*>(page_table), static_cast<const int*>(lengths),
                     out, static_cast<float*>(ws), static_cast<int*>(counters), B, Hq, Hkv, D, L,
                     num_slots, page, max_pages, layer, splits, span};
  return attend_dispatch<false>(q_dtype, pool_dtype, a, stream);
}
