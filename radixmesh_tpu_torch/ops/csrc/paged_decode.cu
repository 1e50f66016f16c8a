// Fused paged decode attention for Hopper (sm_90a): the C entry point of
// the kFused = true instances of paged_decode.cuh, which documents what
// the kernels compute, what they replace and what bounds them.

#include "paged_decode.cuh"

// q_dtype: 0 = float32, 1 = bfloat16; pool_dtype: the same, or 2 = int8
// with kv_scale [2, L, Hkv, num_slots] f32 (else nullptr). k_new/v_new
// are in the pool dtype for bf16/f32 pools and in q's dtype for int8
// pools (the merging CTA quantizes them). With splits > 1, ws is a float32
// workspace of B * Hq * splits * (D + 2) elements for the split partials
// and counters B * Hkv ints, all 0 (each launch leaves them 0). One launch
// over (splits, Hkv, B) on `stream`; allocates nothing. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int paged_decode_launch(int q_dtype, int pool_dtype, const void* q,
                                   const void* k_new, const void* v_new, void* kv,
                                   void* kv_scale, const void* slots,
                                   const void* page_table, const void* lengths,
                                   void* out, void* ws, void* counters, int B, int Hq,
                                   int Hkv, int D, int L, int num_slots, int page, int max_pages,
                                   int layer, int splits, int span, void* stream) {
  using namespace radixmesh;
  const AttendArgs a{q, k_new, v_new, kv, static_cast<float*>(kv_scale),
                     static_cast<const int*>(slots), static_cast<const int*>(page_table),
                     static_cast<const int*>(lengths), out, static_cast<float*>(ws),
                     static_cast<int*>(counters), B, Hq, Hkv, D, L, num_slots, page,
                     max_pages, layer, splits, span};
  return attend_dispatch<true>(q_dtype, pool_dtype, a, stream);
}
