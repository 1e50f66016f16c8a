// Fused paged decode attention for Hopper (sm_90a).
//
// Replaces: radixmesh_tpu/ops/paged_attention.py, paged_decode_fused_kernel
// (Pallas bodies _mh_fused_kernel and _fused_kernel; one kernel serves both
// of their grids).
//
// What it computes, per decode row b and kv head h: write the current
// token's K/V row into pool slot slots[b] of `layer`, then attend the G
// query heads of the group (query head h*G+g) over the row's lengths[b]-1
// pool tokens, found through the page table in any page order, plus the
// current token folded in from registers — never read back from the pool.
// Online softmax in fp32; queries are pre-scaled by 1/sqrt(D); the output
// is cast to the query's dtype. Rows with lengths[b] == 0 output zeros and
// write nothing. Only tokens below the bound are ever loaded, so NaN or Inf
// in an unreferenced page, a page-table pad entry or a page tail cannot
// reach the sums.
//
// What bounds it on an H100: HBM bytes. Each context token costs 2*D
// elements of K and V per kv head against 4*G*D flops — about 4 flops per
// byte in bf16 for G = 4, far below the ~295 flops per byte where the
// tensor cores would bind. Bytes: the K/V pages read once plus the one row
// written.
//
// What the design does about it: one CTA per (row, kv head) reads each of
// its pages exactly once for all G query heads of the group (GQA shares
// the K/V stream), K with one 8- or 16-byte vector load per lane (a warp
// per token), V as one coalesced row per token (a thread per head dim),
// and keeps scores, softmax state and the accumulator on chip. It does not
// yet split the context across CTAs: at small batch the grid has only
// B*Hkv CTAs, so most SMs idle and the bytes stream well below the HBM
// rate. Split-K (flash-decoding), cp.async/TMA pipelining and wgmma are
// later work.

#include "common.cuh"

namespace radixmesh {
namespace {

constexpr int kTile = 32;  // context tokens per tile

template <typename T, int D, int G>
__global__ void __launch_bounds__(D) paged_decode_kernel(
    const T* __restrict__ q,          // [B, Hq, D]
    const T* __restrict__ k_new,      // [B, Hkv, D]
    const T* __restrict__ v_new,      // [B, Hkv, D]
    T* __restrict__ kv,               // [2, L, Hkv, num_slots, D]
    const int* __restrict__ slots,    // [B]
    const int* __restrict__ page_table,  // [B, max_pages]
    const int* __restrict__ lengths,  // [B] incl. the current token
    T* __restrict__ out,              // [B, Hq, D]
    int Hq, int Hkv, int L, int num_slots, int page, int max_pages, int layer) {
  constexpr int NW = D / 32;         // warps in the CTA
  constexpr int E = D / 32;          // head dims per lane in the score phase
  constexpr int TPW = kTile / NW;    // tile tokens per warp
  constexpr int RPW = (G + NW - 1) / NW;  // query rows owned per warp
  __shared__ float s_p[G][kTile];    // scores, then probabilities
  __shared__ int s_slot[kTile];
  __shared__ float s_corr[G];
  __shared__ float s_pcur[G];
  __shared__ float s_l[G];

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b];
  T* out_row = out + ((size_t)b * Hq + (size_t)h * G) * D;
  if (length <= 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) out_row[g * D + tid] = from_f<T>(0.f);
    return;
  }
  const size_t head_stride = (size_t)num_slots * D;
  T* k_pool = kv + ((size_t)layer * Hkv + h) * head_stride;
  T* v_pool = kv + ((size_t)(L + layer) * Hkv + h) * head_stride;
  const int* pt = page_table + (size_t)b * max_pages;
  const size_t new_off = ((size_t)b * Hkv + h) * D;
  const float scale = 1.0f / sqrtf((float)D);

  // The group's queries in the score layout (lane holds dims
  // [lane*E, lane*E+E)), pre-scaled; the current token's K likewise and
  // its V as one dim per thread.
  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec<T, E>(q + ((size_t)b * Hq + (size_t)h * G + g) * D + lane * E, qr[g]);
#pragma unroll
    for (int i = 0; i < E; ++i) qr[g][i] *= scale;
  }
  float kc[E];
  load_vec<T, E>(k_new + new_off + lane * E, kc);
  const float v_cur = to_f(v_new[new_off + tid]);

  // Write the current row (each CTA writes only its own head's row). Rows
  // parked on the scratch slot race here harmlessly: scratch is never read
  // unmasked.
  const size_t slot_off = (size_t)slots[b] * D;
  k_pool[slot_off + tid] = k_new[new_off + tid];
  v_pool[slot_off + tid] = v_new[new_off + tid];

  const int hbm_len = min(length - 1, max_pages * page);
  float m_run[RPW], l_run[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    m_run[j] = kMask;
    l_run[j] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  for (int t0 = 0; t0 < hbm_len; t0 += kTile) {
    const int n = min(kTile, hbm_len - t0);
    // Scores: warp w takes tokens w, w+NW, ...; all K loads first.
    float kr[TPW][E];
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int t = warp + j * NW;
      if (t < n) {
        const int tok = t0 + t;
        const int slot = pt[tok / page] * page + tok % page;
        load_vec<T, E>(k_pool + (size_t)slot * D + lane * E, kr[j]);
        if (lane == 0) s_slot[t] = slot;
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) kr[j][i] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int t = warp + j * NW;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) part += qr[g][i] * kr[j][i];
        const float s = warp_sum(part);
        if (lane == 0 && t < n) s_p[g][t] = s;
      }
    }
    __syncthreads();
    // Online softmax: warp w owns query rows w, w+NW, ...; lane = token.
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int g = warp + j * NW;
      if (g < G) {
        const bool ok = lane < n;
        const float s = ok ? s_p[g][lane] : kMask;
        const float m_new = fmaxf(m_run[j], warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float corr = expf(m_run[j] - m_new);
        l_run[j] = l_run[j] * corr + warp_sum(p);
        m_run[j] = m_new;
        s_p[g][lane] = p;
        if (lane == 0) s_corr[g] = corr;
      }
    }
    __syncthreads();
    // P·V: thread = head dim, one coalesced V row per token.
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= s_corr[g];
#pragma unroll 8
    for (int t = 0; t < n; ++t) {
      const float v = to_f(v_pool[(size_t)s_slot[t] * D + tid]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += s_p[g][t] * v;
    }
    __syncthreads();
  }

  // Fold in the current token from registers: one more online-softmax step
  // with a single-position block.
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int g = warp + j * NW;
    if (g < G) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) part += qr[g][i] * kc[i];
      const float s = warp_sum(part);
      const float m_new = fmaxf(m_run[j], s);
      const float p = expf(s - m_new);
      const float corr = expf(m_run[j] - m_new);
      if (lane == 0) {
        s_corr[g] = corr;
        s_pcur[g] = p;
        s_l[g] = l_run[j] * corr + p;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float o = (acc[g] * s_corr[g] + s_pcur[g] * v_cur) / s_l[g];
    out_row[g * D + tid] = from_f<T>(o);
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, void* kv,
                   const int* slots, const int* page_table, const int* lengths,
                   void* out, int B, int Hq, int Hkv, int L, int num_slots, int page,
                   int max_pages, int layer, cudaStream_t stream) {
  paged_decode_kernel<T, D, G><<<dim3(B, Hkv), D, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(kv), slots, page_table,
      lengths, static_cast<T*>(out), Hq, Hkv, L, num_slots, page, max_pages, layer);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int G, const void* q, const void* k_new, const void* v_new,
                     void* kv, const int* slots, const int* page_table,
                     const int* lengths, void* out, int B, int Hq, int Hkv, int L,
                     int num_slots, int page, int max_pages, int layer,
                     cudaStream_t stream) {
#define RADIXMESH_DECODE_G(GG)                                                  \
  case GG:                                                                      \
    return launch<T, D, GG>(q, k_new, v_new, kv, slots, page_table, lengths,    \
                            out, B, Hq, Hkv, L, num_slots, page, max_pages,     \
                            layer, stream);
  switch (G) {
    RADIXMESH_DECODE_G(1)
    RADIXMESH_DECODE_G(2)
    RADIXMESH_DECODE_G(4)
    RADIXMESH_DECODE_G(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef RADIXMESH_DECODE_G
}

template <typename T>
cudaError_t launch_d(int D, int G, const void* q, const void* k_new,
                     const void* v_new, void* kv, const int* slots,
                     const int* page_table, const int* lengths, void* out, int B,
                     int Hq, int Hkv, int L, int num_slots, int page, int max_pages,
                     int layer, cudaStream_t stream) {
  if (D == 64)
    return launch_g<T, 64>(G, q, k_new, v_new, kv, slots, page_table, lengths, out,
                           B, Hq, Hkv, L, num_slots, page, max_pages, layer, stream);
  if (D == 128)
    return launch_g<T, 128>(G, q, k_new, v_new, kv, slots, page_table, lengths, out,
                            B, Hq, Hkv, L, num_slots, page, max_pages, layer, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace radixmesh

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success). Launches on `stream`; allocates nothing.
extern "C" int paged_decode_launch(int dtype, const void* q, const void* k_new,
                                   const void* v_new, void* kv, const void* slots,
                                   const void* page_table, const void* lengths,
                                   void* out, int B, int Hq, int Hkv, int D, int L,
                                   int num_slots, int page, int max_pages, int layer,
                                   void* stream) {
  using namespace radixmesh;
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int* sl = static_cast<const int*>(slots);
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(D, G, q, k_new, v_new, kv, sl, pt, ln, out, B, Hq,
                                Hkv, L, num_slots, page, max_pages, layer, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, G, q, k_new, v_new, kv, sl, pt, ln, out,
                                        B, Hq, Hkv, L, num_slots, page, max_pages,
                                        layer, s);
  return (int)cudaErrorInvalidValue;
}
