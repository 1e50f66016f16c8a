// Paged GQA decode attention for Hopper (sm_90a): the block loop shared by
// the fused decode kernel (paged_decode.cu) and the read-only pool kernel
// (paged_pool.cu).
//
// Replaces, in radixmesh_tpu/ops/paged_attention.py:
// - kFused = true: paged_decode_fused_kernel (Pallas bodies
//   _mh_fused_kernel and _fused_kernel; one kernel serves both grids);
// - kFused = false: paged_attention_pool_kernel (Pallas bodies _mh_kernel
//   and _kernel; one kernel serves both grids).
//
// What it computes, per decode row b and kv head h: attend the G query
// heads of the group (query head h*G+g) over the row's pool tokens of
// `layer`, found through the page table in any page order. Online softmax
// in fp32; queries are pre-scaled by 1/sqrt(D); the output is cast to the
// query's dtype. Rows with lengths[b] <= 0 output zeros (and, fused, write
// nothing). Only tokens below the bound are ever loaded, so NaN or Inf in
// an unreferenced page, a page-table pad entry or a page tail cannot reach
// the sums.
// - Fused: first write the current token's K/V row into pool slot
//   slots[b], then attend lengths[b]-1 pool tokens plus the current token,
//   folded in from registers (never read back from the pool).
// - Pool: attend lengths[b] pool tokens; no write, no fold-in.
//
// int8 pools (TP = int8_t, kv_scale [2, L, Hkv, num_slots] f32): a
// context token's score is (q . k_int) * k_scale and its probability is
// multiplied by v_scale before the P.V product, the JAX kernels' order.
// Fused: the CTA holds the whole current row (D values, one per thread),
// so it quantizes it itself (ops/quant.py's scheme, bit-exact): a block
// max of |x|, the scale, the int8 payload and the scale written to the
// pool, and the float32 dequantized twin q_int * scale folded in, so
// attention sees what any later read of the pool sees.
//
// What bounds it on an H100: HBM bytes. Each context token costs 2*D
// elements of K and V per kv head against 4*G*D flops — about 4 flops per
// byte in bf16 for G = 4 (8 in int8), far below the ~295 flops per byte
// where the tensor cores would bind.
//
// What the design does about it: one CTA per (row, kv head) reads each of
// its pages exactly once for all G query heads of the group (GQA shares
// the K/V stream), K with one vector load per lane (a warp per token), V
// as one coalesced row per token (a thread per head dim), int8 pages at
// half the bytes of bf16, and keeps scores, softmax state and the
// accumulator on chip. It does not yet split the context across CTAs: at
// small batch the grid has only B*Hkv CTAs, so most SMs idle and the bytes
// stream well below the HBM rate. Split-K (flash-decoding), cp.async/TMA
// pipelining and wgmma are later work.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace radixmesh {
namespace {

constexpr int kTile = 32;  // context tokens per tile

// Arguments of one launch; k_new/v_new/slots only for the fused kernel,
// kv_scale only for int8 pools.
struct AttendArgs {
  const void* q;        // [B, Hq, D] TQ
  const void* k_new;    // [B, Hkv, D] TQ (the pool dtype for bf16/f32 pools)
  const void* v_new;    // [B, Hkv, D]
  void* kv;             // [2, L, Hkv, num_slots, D] TP
  float* kv_scale;      // [2, L, Hkv, num_slots] f32
  const int* slots;     // [B]
  const int* page_table;  // [B, max_pages]
  const int* lengths;   // [B]
  void* out;            // [B, Hq, D] TQ
  int B, Hq, Hkv, D, L, num_slots, page, max_pages, layer;
};

template <typename TQ, typename TP, int D, int G, bool kFused>
__global__ void __launch_bounds__(D) paged_attend_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k_new,
    const TQ* __restrict__ v_new, TP* __restrict__ kv, float* __restrict__ kv_scale,
    const int* __restrict__ slots, const int* __restrict__ page_table,
    const int* __restrict__ lengths, TQ* __restrict__ out, int Hq, int Hkv, int L,
    int num_slots, int page, int max_pages, int layer) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  constexpr int NW = D / 32;         // warps in the CTA
  constexpr int E = D / 32;          // head dims per lane in the score phase
  constexpr int TPW = kTile / NW;    // tile tokens per warp
  constexpr int RPW = (G + NW - 1) / NW;  // query rows owned per warp
  __shared__ float s_p[G][kTile];    // scores, then probabilities
  __shared__ int s_slot[kTile];
  __shared__ float s_vsc[kTile];     // v scales of the tile (int8 pools)
  __shared__ float s_corr[G];
  __shared__ float s_pcur[G];
  __shared__ float s_l[G];
  __shared__ float s_amax[2][NW];    // per-warp |k|, |v| maxima (int8, fused)
  __shared__ float s_kcur[D];        // dequantized current K (int8, fused)

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b];
  TQ* out_row = out + ((size_t)b * Hq + (size_t)h * G) * D;
  if (length <= 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) out_row[g * D + tid] = from_f<TQ>(0.f);
    return;
  }
  const size_t head_stride = (size_t)num_slots * D;
  TP* k_pool = kv + ((size_t)layer * Hkv + h) * head_stride;
  TP* v_pool = kv + ((size_t)(L + layer) * Hkv + h) * head_stride;
  float* k_sc = kQuant ? kv_scale + ((size_t)layer * Hkv + h) * num_slots : nullptr;
  float* v_sc = kQuant ? kv_scale + ((size_t)(L + layer) * Hkv + h) * num_slots : nullptr;
  const int* pt = page_table + (size_t)b * max_pages;
  const float scale = 1.0f / sqrtf((float)D);

  // The group's queries in the score layout (lane holds dims
  // [lane*E, lane*E+E)), pre-scaled.
  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec<TQ, E>(q + ((size_t)b * Hq + (size_t)h * G + g) * D + lane * E, qr[g]);
#pragma unroll
    for (int i = 0; i < E; ++i) qr[g][i] *= scale;
  }

  // Fused: write the current row (each CTA writes only its own head's
  // row) and keep it for the fold-in: K in the score layout, V as one dim
  // per thread. Rows parked on the scratch slot race here harmlessly:
  // scratch is never read unmasked. For int8 pools the payload and the
  // scale are two writes, so on the scratch slot they may come from
  // different writers.
  float kc[E];
  float v_cur = 0.f;
  int hbm_len = min(length, max_pages * page);
  if constexpr (kFused) {
    hbm_len = min(length - 1, max_pages * page);
    const size_t new_off = ((size_t)b * Hkv + h) * D;
    const int slot = slots[b];
    const size_t slot_off = (size_t)slot * D;
    if constexpr (kQuant) {
      const float kx = to_f(k_new[new_off + tid]);
      const float vx = to_f(v_new[new_off + tid]);
      const float ka = warp_max(fabsf(kx)), va = warp_max(fabsf(vx));
      if (lane == 0) {
        s_amax[0][warp] = ka;
        s_amax[1][warp] = va;
      }
      __syncthreads();
      float kam = s_amax[0][0], vam = s_amax[1][0];
#pragma unroll
      for (int w = 1; w < NW; ++w) {
        kam = fmaxf(kam, s_amax[0][w]);
        vam = fmaxf(vam, s_amax[1][w]);
      }
      const float ksc = kv_scale_of(kam), vsc = kv_scale_of(vam);
      const float kq = quantize_to(kx, ksc), vq = quantize_to(vx, vsc);
      k_pool[slot_off + tid] = (int8_t)kq;
      v_pool[slot_off + tid] = (int8_t)vq;
      if (tid == 0) {
        k_sc[slot] = ksc;
        v_sc[slot] = vsc;
      }
      s_kcur[tid] = kq * ksc;  // the float32 twin of the stored row
      v_cur = vq * vsc;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < E; ++i) kc[i] = s_kcur[lane * E + i];
    } else {
      load_vec<TQ, E>(k_new + new_off + lane * E, kc);
      v_cur = to_f(v_new[new_off + tid]);
      k_pool[slot_off + tid] = k_new[new_off + tid];
      v_pool[slot_off + tid] = v_new[new_off + tid];
    }
  }

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
    float ksr[TPW];
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int t = warp + j * NW;
      ksr[j] = 1.f;
      if (t < n) {
        const int tok = t0 + t;
        const int slot = pt[tok / page] * page + tok % page;
        load_vec<TP, E>(k_pool + (size_t)slot * D + lane * E, kr[j]);
        if constexpr (kQuant) ksr[j] = k_sc[slot];
        if (lane == 0) {
          s_slot[t] = slot;
          if constexpr (kQuant) s_vsc[t] = v_sc[slot];
        }
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
        float s = warp_sum(part);
        if constexpr (kQuant) s *= ksr[j];
        if (lane == 0 && t < n) s_p[g][t] = s;
      }
    }
    __syncthreads();
    // Online softmax: warp w owns query rows w, w+NW, ...; lane = token.
    // The denominator takes p; the P.V product takes p * v_scale.
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
        if constexpr (kQuant) {
          s_p[g][lane] = ok ? p * s_vsc[lane] : 0.f;
        } else {
          s_p[g][lane] = p;
        }
        if (lane == 0) s_corr[g] = corr;
      }
    }
    __syncthreads();
    // P.V: thread = head dim, one coalesced V row per token.
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

  if constexpr (kFused) {
    // Fold in the current token from registers: one more online-softmax
    // step with a single-position block.
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
      out_row[g * D + tid] = from_f<TQ>(o);
    }
  } else {
    // length > 0 leaves at least one live token, so l > 0.
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int g = warp + j * NW;
      if (g < G && lane == 0) s_l[g] = l_run[j];
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) out_row[g * D + tid] = from_f<TQ>(acc[g] / s_l[g]);
  }
}

template <typename TQ, typename TP, int D, int G, bool kFused>
cudaError_t launch(const AttendArgs& a, cudaStream_t stream) {
  paged_attend_kernel<TQ, TP, D, G, kFused><<<dim3(a.B, a.Hkv), D, 0, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k_new),
      static_cast<const TQ*>(a.v_new), static_cast<TP*>(a.kv), a.kv_scale, a.slots,
      a.page_table, a.lengths, static_cast<TQ*>(a.out), a.Hq, a.Hkv, a.L,
      a.num_slots, a.page, a.max_pages, a.layer);
  return cudaGetLastError();
}

template <typename TQ, typename TP, int D, bool kFused>
cudaError_t launch_g(const AttendArgs& a, cudaStream_t stream) {
  switch (a.Hq / a.Hkv) {
    case 1: return launch<TQ, TP, D, 1, kFused>(a, stream);
    case 2: return launch<TQ, TP, D, 2, kFused>(a, stream);
    case 4: return launch<TQ, TP, D, 4, kFused>(a, stream);
    case 8: return launch<TQ, TP, D, 8, kFused>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TP, bool kFused>
cudaError_t launch_d(const AttendArgs& a, cudaStream_t stream) {
  if (a.D == 64) return launch_g<TQ, TP, 64, kFused>(a, stream);
  if (a.D == 128) return launch_g<TQ, TP, 128, kFused>(a, stream);
  return cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only, with
// kv_scale). Pools of bf16/f32 take queries of their own dtype; int8
// pools take bf16 or f32 queries.
template <bool kFused>
int attend_dispatch(int q_dtype, int pool_dtype, const AttendArgs& a, void* stream) {
  if (a.B == 0) return 0;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((pool_dtype == 2) != (a.kv_scale != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && pool_dtype == 0) return (int)launch_d<float, float, kFused>(a, s);
  if (q_dtype == 1 && pool_dtype == 1)
    return (int)launch_d<__nv_bfloat16, __nv_bfloat16, kFused>(a, s);
  if (q_dtype == 0 && pool_dtype == 2) return (int)launch_d<float, int8_t, kFused>(a, s);
  if (q_dtype == 1 && pool_dtype == 2)
    return (int)launch_d<__nv_bfloat16, int8_t, kFused>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace radixmesh
