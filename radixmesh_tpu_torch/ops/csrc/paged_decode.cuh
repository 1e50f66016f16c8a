// Paged GQA decode attention for Hopper (sm_90a), split over the context
// (flash-decoding): the worker and combine kernels shared by the fused
// decode kernel (paged_decode.cu) and the read-only pool kernel
// (paged_pool.cu).
//
// Replaces, in radixmesh_tpu/ops/paged_attention.py:
// - kFused = true: paged_decode_fused_kernel (Pallas bodies
//   _mh_fused_kernel and _fused_kernel; one kernel pair serves both grids);
// - kFused = false: paged_attention_pool_kernel (Pallas bodies _mh_kernel
//   and _kernel; one kernel pair serves both grids).
//
// What it computes, per decode row b and kv head h: attend the G query
// heads of the group (query head h*G+g) over the row's pool tokens of
// `layer`, found through the page table in any page order. Online softmax
// in fp32; queries are pre-scaled by 1/sqrt(D); the output is cast to the
// query's dtype. Rows with lengths[b] <= 0 output zeros (and, fused, write
// nothing). Only tokens below the bound are ever loaded, so NaN or Inf in
// an unreferenced page, a page-table pad entry or a page tail cannot reach
// the sums.
// - Fused: attend lengths[b]-1 pool tokens plus the current token, folded
//   in from registers (never read back from the pool), and write the
//   current token's K/V row into pool slot slots[b].
// - Pool: attend lengths[b] pool tokens; no write, no fold-in.
//
// int8 pools (TP = int8_t, kv_scale [2, L, Hkv, num_slots] f32): a
// context token's score is (q . k_int) * k_scale and its V row is v_int *
// v_scale (the JAX kernels scale p instead: the same product, rounded in
// another order).
// Fused: the combine CTA holds the whole current row (D values, one per
// thread), so it quantizes it itself (ops/quant.py's scheme, bit-exact): a
// block max of |x|, the scale, the int8 payload and the scale written to
// the pool, and the float32 dequantized twin q_int * scale folded in, so
// attention sees what any later read of the pool sees.
//
// What bounds it on an H100: HBM bytes. Each context token costs 2*D
// elements of K and V per kv head against 4*G*D flops — about 4 flops per
// byte in bf16 for G = 4 (8 in int8), far below the ~295 flops per byte
// where the tensor cores would bind.
//
// What the design does about it: two launches per call.
// - Worker, grid (B, Hkv, S): split s attends the contiguous context range
//   [s*span, (s+1)*span) of its row (span a multiple of the 32-token
//   tile, chosen on the host from the page table's width and B*Hkv, never
//   from lengths), so small batches still put enough CTAs on the 132 SMs
//   to keep HBM busy. K and V tiles of 32 tokens come into a 3-stage
//   shared-memory ring by cp.async (16 bytes a thread, each token's slot
//   looked up through the page table one tile before its copy starts;
//   rows past the split's end zero-filled), so the next two tiles stream
//   while this one is computed. Each page is read once for all G query
//   heads (GQA shares the K/V stream). Scores: a lane per token runs the
//   whole dot product over its padded K row against the group's queries
//   in shared memory (no cross-lane reduction); the softmax stays in the
//   warp's registers; P.V runs a thread per head dim over the V tile. It
//   writes fp32 partials m, l [B, Hq, S] and acc [B, Hq, S, D]; a split
//   past the row's bound writes m = kMask, l = 0, acc = 0. The worker is
//   read-only on the pool.
// - Combine, grid (B, Hkv, G), D threads: merges a query head's S
//   partials with log-sum-exp weights; fused, it then writes the current
//   row (quantized for int8 pools; the group's first head writes) and
//   folds the current token in. Same-stream order puts every worker read
//   before the combine's write.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace radixmesh {
namespace {

constexpr int kTile = 32;   // context tokens per tile
constexpr int kStages = 3;  // K/V tiles in the worker's ring

// Arguments of one call; k_new/v_new/slots only for the fused kernel,
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
  float* ws;            // m, l [B, Hq, S] then acc [B, Hq, S, D], f32
  int B, Hq, Hkv, D, L, num_slots, page, max_pages, layer, splits, span;
};

// Shared memory of the worker: the group's queries [G][D] f32 (pre-scaled),
// a ring of K and V tiles [kStages][K, V][kTile] rows of D elements padded
// by 16 bytes (a warp reading one 16-byte chunk of 32 different rows then
// hits distinct banks), and the tiles' k/v scales [kStages][K, V][kTile].
template <typename TP, int D, int G>
struct SplitSmem {
  static constexpr int kRow = D * (int)sizeof(TP) + 16;
  static constexpr int kTileBytes = kTile * kRow;
  static constexpr int kv = G * D * 4;
  static constexpr int scale = kv + kStages * 2 * kTileBytes;
  static constexpr int bytes = scale + kStages * 2 * kTile * 4;
};

template <typename TQ, typename TP, int D, int G, bool kFused>
__global__ void __launch_bounds__(D) paged_split_kernel(
    const TQ* __restrict__ q, const TP* __restrict__ kv,
    const float* __restrict__ kv_scale, const int* __restrict__ page_table,
    const int* __restrict__ lengths, float* __restrict__ ws, int Hq, int Hkv, int L,
    int num_slots, int page, int max_pages, int layer, int span) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  constexpr int NW = D / 32;                     // warps in the CTA
  constexpr int RPW = (G + NW - 1) / NW;         // query heads per warp (scores)
  constexpr int EPC = 16 / (int)sizeof(TP);      // elements per 16-byte chunk
  constexpr int CPR = D / EPC;                   // chunks per K/V row
  constexpr int CPT = kTile * CPR / D;           // chunks per thread per K or V tile
  using SM = SplitSmem<TP, D, G>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  uint8_t* kv_s = smem + SM::kv;
  float* sc_s = reinterpret_cast<float*>(smem + SM::scale);
  __shared__ float s_p[G][kTile];  // probabilities of the tile
  __shared__ float s_corr[G];

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b];
  const int hbm_len = min(kFused ? length - 1 : length, max_pages * page);
  const int t_begin = s * span;
  const int t_end = min(t_begin + span, hbm_len);
  // Partials of query head h*G+g: index ((b*Hq + h*G + g) * S + s).
  const size_t bhs = (size_t)gridDim.x * Hq * S;
  const size_t part0 = ((size_t)b * Hq + (size_t)h * G) * S + s;
  float* m_out = ws + part0;
  float* l_out = ws + bhs + part0;
  float* acc_out = ws + 2 * bhs + part0 * D;
  if (t_begin >= t_end) {
#pragma unroll
    for (int g = 0; g < G; ++g) acc_out[(size_t)g * S * D + tid] = 0.f;
    if (tid < G) {
      m_out[(size_t)tid * S] = kMask;
      l_out[(size_t)tid * S] = 0.f;
    }
    return;
  }
  const size_t head_stride = (size_t)num_slots * D;
  const TP* k_pool = kv + ((size_t)layer * Hkv + h) * head_stride;
  const TP* v_pool = kv + ((size_t)(L + layer) * Hkv + h) * head_stride;
  const float* k_sc = kQuant ? kv_scale + ((size_t)layer * Hkv + h) * num_slots : nullptr;
  const float* v_sc = kQuant ? kv_scale + ((size_t)(L + layer) * Hkv + h) * num_slots : nullptr;
  const int* pt = page_table + (size_t)b * max_pages;
  const int page_shift = page_shift_of(page);

  const float scale = 1.0f / sqrtf((float)D);
#pragma unroll
  for (int g = 0; g < G; ++g)
    q_s[g * D + tid] = to_f(q[((size_t)b * Hq + (size_t)h * G + g) * D + tid]) * scale;

  // Slots of this thread's chunks of the next tile to copy (-1 past the
  // split's end: zero-filled), and of the token whose k or v scale it
  // copies (threads below 2 * kTile, int8 pools).
  int slot_nx[CPT];
  int sc_slot_nx = -1;
  auto lookup = [&](int t0) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int tok = t0 + (tid + c * D) / CPR;
      slot_nx[c] = tok < t_end ? slot_of(pt, tok, page, page_shift) : -1;
    }
    if (kQuant && tid < 2 * kTile) {
      const int tok = t0 + (tid & (kTile - 1));
      sc_slot_nx = tok < t_end ? slot_of(pt, tok, page, page_shift) : -1;
    }
  };
  auto issue = [&](int stage) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const TP* pool = which ? v_pool : k_pool;
      uint8_t* tile = kv_s + (stage * 2 + which) * SM::kTileBytes;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int idx = tid + c * D, row = idx / CPR, ch = idx % CPR;
        const int sl = slot_nx[c];
        cp_async16(smem_addr(tile + row * SM::kRow + ch * 16),
                   sl >= 0 ? pool + (size_t)sl * D + ch * EPC : pool, sl >= 0);
      }
    }
    if constexpr (kQuant) {
      if (tid < 2 * kTile) {
        const int which = tid / kTile;
        const float* scp = which ? v_sc : k_sc;
        cp_async4(smem_addr(sc_s + stage * 2 * kTile + tid),
                  sc_slot_nx >= 0 ? scp + sc_slot_nx : scp, sc_slot_nx >= 0);
      }
    }
  };

  float m_run[RPW], l_run[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    m_run[j] = kMask;
    l_run[j] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  // Prologue: tiles 0 .. kStages-2 in flight, one commit per tile slot.
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    lookup(t_begin + t * kTile);
    if (t_begin + t * kTile < t_end) issue(t);
    cp_async_commit();
  }
  lookup(t_begin + (kStages - 1) * kTile);
  for (int t0 = t_begin, stage = 0; t0 < t_end;
       t0 += kTile, stage = stage + 1 == kStages ? 0 : stage + 1) {
    const int n = min(kTile, t_end - t0);
    const int ahead = t0 + (kStages - 1) * kTile;  // the tile whose copy starts now
    if (ahead < t_end) issue(stage == 0 ? kStages - 1 : stage - 1);
    cp_async_commit();
    lookup(ahead + kTile);
    cp_async_wait<kStages - 1>();  // this thread's copies of this tile have landed
    __syncthreads();
    const uint8_t* k_tile = kv_s + (stage * 2) * SM::kTileBytes;
    const uint8_t* v_tile = k_tile + SM::kTileBytes;
    const float* ksc = sc_s + stage * 2 * kTile;
    const float* vsc = ksc + kTile;
    // Scores: lane = token, warp w takes query heads w, w+NW, ...; each
    // lane runs the whole dot product over its K row.
    float sc[RPW];
#pragma unroll
    for (int j = 0; j < RPW; ++j) sc[j] = 0.f;
    const TP* krow = reinterpret_cast<const TP*>(k_tile + lane * SM::kRow);
#pragma unroll 4
    for (int ch = 0; ch < CPR; ++ch) {
      float kf[EPC];
      chunk_to_f32(krow + ch * EPC, kf);
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int g = warp + j * NW;
        if (g < G) {
          const float4* q4 = reinterpret_cast<const float4*>(q_s + g * D + ch * EPC);
#pragma unroll
          for (int e = 0; e < EPC / 4; ++e) {
            const float4 qv = q4[e];
            sc[j] += qv.x * kf[4 * e] + qv.y * kf[4 * e + 1] + qv.z * kf[4 * e + 2] +
                     qv.w * kf[4 * e + 3];
          }
        }
      }
    }
    // Online softmax in registers, a warp per query head.
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int g = warp + j * NW;
      if (g < G) {
        const bool ok = lane < n;
        float x = sc[j];
        if constexpr (kQuant) x *= ksc[lane];
        x = ok ? x : kMask;
        const float m_new = fmaxf(m_run[j], warp_max(x));
        const float p = ok ? expf(x - m_new) : 0.f;
        const float corr = expf(m_run[j] - m_new);
        l_run[j] = l_run[j] * corr + warp_sum(p);
        m_run[j] = m_new;
        s_p[g][lane] = p;
        if (lane == 0) s_corr[g] = corr;
      }
    }
    __syncthreads();
    // P.V: thread = head dim; masked tokens have p = 0 and zero-filled V
    // (and scale) rows.
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= s_corr[g];
#pragma unroll 8
    for (int t = 0; t < kTile; ++t) {
      float v = to_f(reinterpret_cast<const TP*>(v_tile + t * SM::kRow)[tid]);
      if constexpr (kQuant) v *= vsc[t];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += s_p[g][t] * v;
    }
    __syncthreads();  // the stage and s_p are free again
  }
  cp_async_wait<0>();
#pragma unroll
  for (int g = 0; g < G; ++g) acc_out[(size_t)g * S * D + tid] = acc[g];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int g = warp + j * NW;
    if (g < G && lane == 0) {
      m_out[(size_t)g * S] = m_run[j];
      l_out[(size_t)g * S] = l_run[j];
    }
  }
}

// Sum (or max) of one value per thread over the CTA's NW warps; every
// thread gets the result. `red` holds NW floats.
template <int NW, bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is free again
  return r;
}

// One CTA per (row, kv head, query head of the group), a thread per head
// dim.
template <typename TQ, typename TP, int D, int G, bool kFused>
__global__ void __launch_bounds__(D) paged_combine_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k_new,
    const TQ* __restrict__ v_new, TP* __restrict__ kv, float* __restrict__ kv_scale,
    const int* __restrict__ slots, const int* __restrict__ lengths,
    const float* __restrict__ ws, TQ* __restrict__ out, int Hq, int Hkv, int L,
    int num_slots, int S) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  constexpr int NW = D / 32;
  extern __shared__ float s_w[];  // [S]: the partials' m, then their weights
  __shared__ float s_red[NW];

  const int b = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x;
  const int hq = h * G + g;
  const int length = lengths[b];
  TQ* out_row = out + ((size_t)b * Hq + hq) * D;
  if (length <= 0) {
    out_row[tid] = from_f<TQ>(0.f);
    return;
  }
  // Log-sum-exp merge of the S partials of query head hq: the weights in
  // shared memory, then a thread per head dim sums its acc column with
  // many loads in flight.
  const size_t bhs = (size_t)gridDim.x * Hq * S;
  const size_t p0 = ((size_t)b * Hq + hq) * S;
  float mx = kMask;
  for (int s = tid; s < S; s += D) {
    const float m = ws[p0 + s];
    s_w[s] = m;
    mx = fmaxf(mx, m);
  }
  mx = block_reduce<NW, true>(mx, s_red);
  float l = 0.f;
  for (int s = tid; s < S; s += D) {
    const float w = expf(s_w[s] - mx);
    s_w[s] = w;
    l += w * ws[bhs + p0 + s];
  }
  l = block_reduce<NW, false>(l, s_red);  // its barrier publishes s_w
  const float* acc_in = ws + 2 * bhs + p0 * D + tid;
  float o = 0.f;
#pragma unroll 8
  for (int s = 0; s < S; ++s) o += s_w[s] * acc_in[(size_t)s * D];
  if constexpr (!kFused) {
    // length > 0 leaves at least one live token, so l > 0.
    out_row[tid] = from_f<TQ>(o / l);
  } else {
    // The current row: the group's first query head writes it (each kv
    // head's CTA writes only its own head's row); every CTA of the group
    // keeps it for its fold-in. Rows parked on the scratch slot race here
    // harmlessly: scratch is never read unmasked. For int8 pools the
    // payload and the scale are two writes, so on the scratch slot they
    // may come from different writers. kv and kv_scale arrive offset to
    // `layer`.
    const size_t head_stride = (size_t)num_slots * D;
    TP* kp = kv + (size_t)h * head_stride;
    TP* vp = kv + ((size_t)L * Hkv + h) * head_stride;
    const size_t new_off = ((size_t)b * Hkv + h) * D + tid;
    const int slot = slots[b];
    const size_t slot_off = (size_t)slot * D + tid;
    float k_cur, v_cur;
    if constexpr (kQuant) {
      const float kx = to_f(k_new[new_off]), vx = to_f(v_new[new_off]);
      const float ksc = kv_scale_of(block_reduce<NW, true>(fabsf(kx), s_red));
      const float vsc = kv_scale_of(block_reduce<NW, true>(fabsf(vx), s_red));
      const float kq = quantize_to(kx, ksc), vq = quantize_to(vx, vsc);
      if (g == 0) {
        kp[slot_off] = (int8_t)kq;
        vp[slot_off] = (int8_t)vq;
        if (tid == 0) {
          kv_scale[(size_t)h * num_slots + slot] = ksc;
          kv_scale[((size_t)L * Hkv + h) * num_slots + slot] = vsc;
        }
      }
      k_cur = kq * ksc;  // the float32 twin of the stored row
      v_cur = vq * vsc;
    } else {
      k_cur = to_f(k_new[new_off]);
      v_cur = to_f(v_new[new_off]);
      if (g == 0) {
        kp[slot_off] = k_new[new_off];
        vp[slot_off] = v_new[new_off];
      }
    }
    // Fold in the current token: one more online-softmax step with a
    // single-position block.
    const float scale = 1.0f / sqrtf((float)D);
    const float sc = block_reduce<NW, false>(
        to_f(q[((size_t)b * Hq + hq) * D + tid]) * scale * k_cur, s_red);
    const float m_new = fmaxf(mx, sc);
    const float corr = expf(mx - m_new);
    const float p = expf(sc - m_new);
    out_row[tid] = from_f<TQ>((o * corr + p * v_cur) / (l * corr + p));
  }
}

template <typename TQ, typename TP, int D, int G, bool kFused>
cudaError_t launch(const AttendArgs& a, cudaStream_t stream) {
  // The combine gets the pool (and scales) offset to `layer`; K and V of
  // that layer are then L * Hkv heads apart.
  const size_t layer_off = (size_t)a.layer * a.Hkv * a.num_slots;
  TP* kv = static_cast<TP*>(a.kv);
  constexpr int bytes = SplitSmem<TP, D, G>::bytes;
  if (bytes > 48 * 1024) {
    static SmemOptIn opt_in;
    const cudaError_t err = opt_in.ensure(paged_split_kernel<TQ, TP, D, G, kFused>, bytes);
    if (err != cudaSuccess) return err;
  }
  paged_split_kernel<TQ, TP, D, G, kFused><<<dim3(a.B, a.Hkv, a.splits), D, bytes, stream>>>(
      static_cast<const TQ*>(a.q), kv, a.kv_scale, a.page_table, a.lengths, a.ws, a.Hq,
      a.Hkv, a.L, a.num_slots, a.page, a.max_pages, a.layer, a.span);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<TQ, TP, D, G, kFused>
      <<<dim3(a.B, a.Hkv, G), D, sizeof(float) * a.splits, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k_new),
      static_cast<const TQ*>(a.v_new), kFused ? kv + layer_off * a.D : nullptr,
      kFused && a.kv_scale ? a.kv_scale + layer_off : nullptr, a.slots, a.lengths, a.ws,
      static_cast<TQ*>(a.out), a.Hq, a.Hkv, a.L, a.num_slots, a.splits);
  return cudaGetLastError();
}

template <typename TQ, typename TP, int D, bool kFused>
cudaError_t launch_g(const AttendArgs& a, cudaStream_t stream) {
  switch (a.Hq / a.Hkv) {
    case 1: return launch<TQ, TP, D, 1, kFused>(a, stream);
    case 2: return launch<TQ, TP, D, 2, kFused>(a, stream);
    case 3: return launch<TQ, TP, D, 3, kFused>(a, stream);
    case 4: return launch<TQ, TP, D, 4, kFused>(a, stream);
    case 5: return launch<TQ, TP, D, 5, kFused>(a, stream);
    case 6: return launch<TQ, TP, D, 6, kFused>(a, stream);
    case 7: return launch<TQ, TP, D, 7, kFused>(a, stream);
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
// pools take bf16 or f32 queries. splits * span must cover the page
// table's max_pages * page tokens, span a multiple of kTile.
template <bool kFused>
int attend_dispatch(int q_dtype, int pool_dtype, const AttendArgs& a, void* stream) {
  if (a.B == 0) return 0;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((pool_dtype == 2) != (a.kv_scale != nullptr)) return (int)cudaErrorInvalidValue;
  // The combine keeps `splits` weights in (at most 48 KB of) shared memory.
  if (a.splits <= 0 || a.splits > 12288 || a.span <= 0 ||
      a.span % kTile != 0 || (long long)a.splits * a.span < (long long)a.max_pages * a.page)
    return (int)cudaErrorInvalidValue;
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
