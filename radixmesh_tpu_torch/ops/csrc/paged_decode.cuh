// Paged GQA decode attention for Hopper (sm_90a), split over the context
// (flash-decoding) in one launch: the kernel shared by the fused decode
// kernel (paged_decode.cu) and the read-only pool kernel (paged_pool.cu).
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
// in fp32 (base 2: scores carry log2(e)/sqrt(D)); the output is cast to
// the query's dtype. Rows with lengths[b] <= 0 output zeros (and, fused,
// write nothing). Only pages that hold tokens below the bound are loaded,
// masked tokens take exact zeros in P and V, so NaN or Inf in an
// unreferenced page, a page-table pad entry or a page tail cannot reach
// the sums.
// - Fused: attend lengths[b]-1 pool tokens plus the current token, folded
//   in from registers (never read back from the pool), and write the
//   current token's K/V row into pool slot slots[b].
// - Pool: attend lengths[b] pool tokens; no write, no fold-in.
//
// int8 pools (TP = int8_t, kv_scale [2, L, Hkv, num_slots] f32): a
// context token's score is (q . k_int) * k_scale and P is multiplied by
// v_scale before P.V while the denominator takes P unscaled (the JAX
// kernels' order). Fused: the merging CTA holds the whole current row (a
// thread per head dim), so it quantizes it itself (ops/quant.py's scheme,
// bit-exact): a block max of |x|, the scale, the int8 payload and the
// scale written to the pool, and the float32 dequantized twin q_int *
// scale folded in, so attention sees what any later read of the pool sees.
//
// What bounds it on an H100: HBM bytes. Each context token costs 2*D
// elements of K and V per kv head against 4*G*D flops — about 4 flops per
// byte in bf16 for G = 4 (8 in int8), far below the ~295 flops per byte
// where the tensor cores would bind.
//
// What the design does about it:
// - One launch per call, grid (S, Hkv, B). Split s attends the contiguous
//   context range [s*span, (s+1)*span) of its row (span a multiple of the
//   64-token tile, chosen on the host from the page table's width, B*Hkv
//   and the SM count, never from lengths, and long enough that a split
//   runs several tiles). Splits past a row's bound leave at once; the
//   others write fp32 partials (m, l, O per query head) when the row has
//   more than one, and the last to finish, counted by an atomic counter
//   that it puts back to 0, merges them by log-sum-exp in split order
//   (deterministic), then (fused) writes the current row and folds it in.
//   A row with one split does all of it in its one CTA.
// - One producer warp keeps whole pages in flight: TMA boxes of one page
//   (or of its largest power-of-two part up to 64 rows) by 128 bytes of
//   head dims (a 2-D tensor map over the pool seen as [2*L*Hkv*num_slots,
//   D] rows, 128-byte swizzled, so the fragment loads below hit distinct
//   banks) into a ring of 64-token tiles with a full and an empty mbarrier
//   per stage (3 stages; 2 for float32 pools); int8 scales by bulk copies
//   of a box's 4-byte scales on the same barrier. Pages that are not a
//   multiple of 8 tokens (a box of fewer rows would break the swizzled
//   tile's 1024-byte alignment, and its scales the bulk copy's 16 bytes)
//   are gathered row by row instead: each producer lane copies whole rows
//   by cp.async into the same swizzled layout and arrives on the full
//   barrier when they land.
//   The four consumer warps take one 16-token quarter of each tile each,
//   with their own softmax state, and never wait on a CTA-wide barrier in
//   the main loop; they merge through shared memory once, at the end. Each
//   page is read once for all G query heads (GQA shares the K/V stream).
//   TMA loads whole pages, so a warp whose quarter ends inside one zeroes
//   its V rows past the bound before P.V (0 x NaN in a page tail would
//   poison it); masked tokens' probabilities are exact zeros.
// - bf16 queries (bf16 and int8 pools): the G heads are padded to the 16
//   rows of mma.sync m16n8k16 (bf16 in, fp32 accumulators): S = Q.K^T with
//   K fragments by ldmatrix (bf16) or widened from int8 pairs, P.V with P
//   from the S accumulators as two bf16 terms (its rounding and the
//   remainder: float32 accuracy) and V fragments by ldmatrix.trans (bf16)
//   or int8 bytes. Float32 queries (float32 and int8 pools) stay on float32
//   CUDA-core arithmetic: the float32 whole-path check at atol 1e-4 needs
//   it.
//
// Race-freedom of the fused write: the merging CTA of (b, h) writes K/V
// head h at slots[b] of `layer`, the row's own fresh slot, and no CTA of
// the launch reads it: row b's splits read positions < lengths[b] - 1, and
// other rows read their own context. Rows parked on the scratch slot may
// race there; scratch is never read unmasked.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace radixmesh {
namespace {

constexpr int kTile = 64;       // context tokens per tile
constexpr int kQuarter = 16;    // tokens per consumer warp and tile
constexpr int kConsumerThreads = 128;  // four consumer warps; warp 4 is the producer
constexpr int kThreads = kConsumerThreads + 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBarConsumers = 1;  // named barrier of the consumer warps

// Arguments of one call; k_new/v_new/slots only for the fused kernel,
// kv_scale only for int8 pools, ws and counters only when splits > 1.
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
  float* ws;            // m, l [G] then O [G][D] per (b, h, split), f32
  int* counters;        // [B * Hkv], all 0 between launches
  int B, Hq, Hkv, D, L, num_slots, page, max_pages, layer, splits, span;
};

// Shared memory, from a 1024-byte-aligned base: the ring of K and V tiles
// [kStages][K, V] of 64 tokens, each stored as column blocks of [64 rows]
// [128 bytes] (128-byte swizzled; 64-byte blocks unswizzled for int8 at D
// 64); barriers, the block reductions' slots and the merge flag (256
// bytes); float32 queries' pre-scaled Q [G][D]; the tiles' k/v scales
// [kStages][K, V][kTile]. The warps' merge (m, l [4][8], O [4][8][D], f32)
// reuses the ring once the main loop is over.
template <typename TQ, typename TP, int D, int G>
struct DecodeSmem {
  static constexpr bool kF32 = std::is_same<TQ, float>::value;
  static constexpr int kStages = sizeof(TP) == 4 ? 2 : 3;
  static constexpr int kRowBytes = D * (int)sizeof(TP);
  static constexpr int kBlock = kRowBytes < 128 ? kRowBytes : 128;  // bytes of a column block's row
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int bars = kStages * 2 * kTileBytes;
  static constexpr int q = bars + 256;
  static constexpr int scale = q + (kF32 ? G * D * 4 : 0);
  static constexpr int bytes = scale + kStages * 2 * kTile * 4 + 1024;  // + alignment slack
  static constexpr int merge_bytes = 4 * 8 * (D + 2) * 4;
  static_assert(merge_bytes <= kStages * 2 * kTileBytes, "the merge must fit in the ring");
};

// mma.sync m16n8k16, bf16 in, fp32 accumulators: d += A . B.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two int8 values (lo, hi) as a bf16 pair, exactly.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(int8_t lo, int8_t hi) {
  return pack_bf16((float)lo, (float)hi);
}

// Sums (or maxima) of N values per consumer thread over the four consumer
// warps, in one pass; every consumer thread gets the results. `red` holds
// 4 * 8 floats (N <= 8).
template <bool kMax, int N>
__device__ __forceinline__ void consumer_reduce(float (&v)[N], float* red) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = kMax ? warp_max(v[i]) : warp_sum(v[i]);
    if ((threadIdx.x & 31) == 0) red[(threadIdx.x >> 5) * 8 + i] = v[i];
  }
  bar_sync(kBarConsumers, kConsumerThreads);
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = kMax ? fmaxf(fmaxf(red[i], red[8 + i]), fmaxf(red[16 + i], red[24 + i]))
                : red[i] + red[8 + i] + red[16 + i] + red[24 + i];
  bar_sync(kBarConsumers, kConsumerThreads);  // red is free again
}

template <typename TQ, typename TP, int D, int G, bool kFused>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const __grid_constant__ CUtensorMap pool_map,  // the pool as [2*L*Hkv*num_slots, D] rows
    const TQ* __restrict__ q, const TQ* __restrict__ k_new, const TQ* __restrict__ v_new,
    TP* __restrict__ kv, float* __restrict__ kv_scale, const int* __restrict__ slots,
    const int* __restrict__ page_table, const int* __restrict__ lengths, TQ* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ counters, int Hq, int Hkv, int L, int num_slots,
    int page, int max_pages, int layer, int span) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  constexpr bool kMma = std::is_same<TQ, __nv_bfloat16>::value;
  using SM = DecodeSmem<TQ, TP, D, G>;
  constexpr int kStages = SM::kStages;
  constexpr int kBlock = SM::kBlock;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::bars);
  uint64_t* empty = full + kStages;
  int* flag = reinterpret_cast<int*>(empty + kStages);
  float* red = reinterpret_cast<float*>(smem + SM::bars + 64);  // [4 warps][8]
  float* q_s = reinterpret_cast<float*>(smem + SM::q);
  float* sc_s = reinterpret_cast<float*>(smem + SM::scale);  // [stage][K, V][kTile]
  auto k_tile = [&](int stage) { return ring + (stage * 2) * SM::kTileBytes; };
  auto v_tile = [&](int stage) { return ring + (stage * 2 + 1) * SM::kTileBytes; };

  const int s = blockIdx.x, S = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The producer's first page-table lookup goes out beside lengths[b]: it
  // needs the split's start alone (box k of the first tile, lane k).
  const int* pt = page_table + (size_t)b * max_pages;
  const int page_shift = page_shift_of(page);
  // Pages of a multiple of 8 tokens come by TMA boxes of box_rows (a power
  // of two that divides both the page and the tile); others row by row.
  const bool tma = (page & 7) == 0;
  const int box_rows = min(page & -page, kTile);
  int slot_nx = 0;
  if (warp == 4 && tma) {
    if (lane == 0) prefetch_tensor_map(&pool_map);
    if (s * span + lane * box_rows < max_pages * page)
      slot_nx = slot_of(pt, s * span + lane * box_rows, page, page_shift);
  }
  const int length = lengths[b];
  const int hbm_len = min(max(kFused ? length - 1 : length, 0), max_pages * page);
  // Splits of this row that hold tokens (at least one: it writes the
  // output); the rest leave at once.
  const int parts = max(1, (hbm_len + span - 1) / span);
  if (s >= parts) return;
  const int t_begin = s * span;
  const int t_end = min(t_begin + span, hbm_len);
  const int n_tiles = max(0, (t_end - t_begin + kTile - 1) / kTile);
  const size_t head_stride = (size_t)num_slots * D;
  const size_t k_head = (size_t)layer * Hkv + h, v_head = (size_t)(L + layer) * Hkv + h;
  const float scl = kLog2e / sqrtf((float)D);

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], tma ? 1 : 32);  // the byte count, or every lane's row copies
      mbar_init(&empty[i], 4);  // every consumer warp
    }
    fence_mbar_init();
  }
  if constexpr (SM::kF32) {
    for (int i = tid; i < G * D; i += kThreads)
      q_s[i] = to_f(q[((size_t)b * Hq + (size_t)h * G) * D + i]) * scl;
  }
  // Producer lane k loads box k of each tile: one page (or 64 rows of a
  // longer one) of every column block, K and V; its page-table lookup runs
  // a tile ahead (the first one went out with lengths[b]).
  auto lookup = [&](int j) {
    const int t0 = t_begin + j * kTile;
    if (j < n_tiles && lane * box_rows < t_end - t0) slot_nx = slot_of(pt, t0 + lane * box_rows, page, page_shift);
  };
  __syncthreads();  // no CTA-wide barrier after this

  if (warp == 4) {
    // ---------------------------------------------------------------- producer
    const float* k_sc = kQuant ? kv_scale + k_head * num_slots : nullptr;
    const float* v_sc = kQuant ? kv_scale + v_head * num_slots : nullptr;
    const int row_k = (int)k_head * num_slots, row_v = (int)v_head * num_slots;  // map rows
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % kStages, t0 = t_begin + j * kTile, n = min(kTile, t_end - t0);
      if (!tma) {
        // Rows up to the bound (the consumers mask the rest), K and V (and
        // int8 scales) by cp.async: lane l looks up rows l and l + 32, and
        // a row's 16-byte units go to consecutive lanes (coalesced), each
        // taking its row's slot by shuffle.
        constexpr int U = SM::kRowBytes / 16;  // 4 to 32 units per row
        mbar_wait(&empty[stage], ((j / kStages) & 1) ^ 1);
        const int sa = lane < n ? slot_of(pt, t0 + lane, page, page_shift) : 0;
        const int sb = lane + 32 < n ? slot_of(pt, t0 + lane + 32, page, page_shift) : 0;
        for (int base = 0; base < n * U; base += 32) {
          const int idx = base + lane, r = idx / U, u = idx % U;  // r < 64: n * U rounds up to 32
          const int xa = __shfl_sync(0xffffffffu, sa, r & 31), xb = __shfl_sync(0xffffffffu, sb, r & 31);
          const size_t off = (size_t)(r < 32 ? xa : xb) * D;
          const bool ok = idx < n * U;
          cp_async16(smem_addr(k_tile(stage) + tile_at<kTile, kBlock>(r, 16 * u)),
                     reinterpret_cast<const uint8_t*>(kv + (size_t)row_k * D + off) + 16 * u, ok);
          cp_async16(smem_addr(v_tile(stage) + tile_at<kTile, kBlock>(r, 16 * u)),
                     reinterpret_cast<const uint8_t*>(kv + (size_t)row_v * D + off) + 16 * u, ok);
        }
        if constexpr (kQuant) {
          cp_async4(smem_addr(sc_s + (stage * 2) * kTile + lane), k_sc + sa, lane < n);
          cp_async4(smem_addr(sc_s + (stage * 2 + 1) * kTile + lane), v_sc + sa, lane < n);
          cp_async4(smem_addr(sc_s + (stage * 2) * kTile + lane + 32), k_sc + sb, lane + 32 < n);
          cp_async4(smem_addr(sc_s + (stage * 2 + 1) * kTile + lane + 32), v_sc + sb, lane + 32 < n);
        }
        mbar_arrive_cp_async(&full[stage]);
        continue;
      }
      const int boxes = (n + box_rows - 1) / box_rows;
      const int slot = slot_nx;
      lookup(j + 1);
      mbar_wait(&empty[stage], ((j / kStages) & 1) ^ 1);
      if (lane == 0)
        mbar_arrive_tx(&full[stage], 2 * boxes * box_rows * (SM::kRowBytes + (kQuant ? 4 : 0)));
      __syncwarp();
      if (lane < boxes) {
#pragma unroll
        for (int cb = 0; cb < SM::kRowBytes / kBlock; ++cb) {
          const int off = cb * kTile * kBlock + lane * box_rows * kBlock;
          tma_load_2d(k_tile(stage) + off, &pool_map, cb * kBlock / (int)sizeof(TP), row_k + slot, &full[stage]);
          tma_load_2d(v_tile(stage) + off, &pool_map, cb * kBlock / (int)sizeof(TP), row_v + slot, &full[stage]);
        }
        if constexpr (kQuant) {
          bulk_load(sc_s + (stage * 2) * kTile + lane * box_rows, k_sc + slot, box_rows * 4, &full[stage]);
          bulk_load(sc_s + (stage * 2 + 1) * kTile + lane * box_rows, v_sc + slot, box_rows * 4, &full[stage]);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  // Each warp's running state for its quarter of every tile: the mma path
  // holds row g = lane / 4 (a query head when g < G), its m and l shared
  // by the quad, and O columns 8*nd + 2*(lane % 4) + {0, 1}; the CUDA-core
  // path holds every head's m and l and O columns lane + 32*i.
  constexpr int NR = kMma ? 1 : G;       // rows of m / l per thread
  constexpr int NO = kMma ? D / 4 : G * (D / 32);  // O values per thread
  float m_run[NR], l_run[NR], o[NO];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m_run[r] = kMask;
    l_run[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  const int g = lane >> 2, q4 = lane & 3;
  uint32_t qa[kMma ? D / 16 : 1][2];  // Q fragments: a0 and a2 of row g (a1 = a3 = 0)
  if constexpr (kMma) {
    const TQ* qrow = q + ((size_t)b * Hq + (size_t)h * G + g) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = g < G ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 2 * q4) : 0u;
      qa[kk][1] = g < G ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 2 * q4 + 8) : 0u;
    }
  }
  // The fused finish's inputs, a thread per head dim d, loaded now so that
  // their latency hides behind the main loop.
  const int d = tid;
  const bool has_d = d < D;
  const size_t new_off = ((size_t)b * Hkv + h) * D + d;
  float kx = 0.f, vx = 0.f, qd[kFused ? G : 1];
  if (kFused && has_d && length > 0) {
    kx = to_f(k_new[new_off]);
    vx = to_f(v_new[new_off]);
#pragma unroll
    for (int gg = 0; gg < G; ++gg) qd[gg] = to_f(q[((size_t)b * Hq + (size_t)h * G + gg) * D + d]);
  }
  const int slot = kFused && length > 0 ? slots[b] : 0;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    const int tok0 = t_begin + j * kTile + warp * kQuarter;  // this warp's first token
    mbar_wait(&full[stage], (j / kStages) & 1);
    const uint8_t* kt = k_tile(stage);
    uint8_t* vt = v_tile(stage);
    const int r0 = warp * kQuarter;  // this warp's first row of the tile
    const float* ks = sc_s + (stage * 2) * kTile + r0;
    const float* vs = ks + kTile;
    const int nv = min(kQuarter, t_end - tok0);  // live tokens of the quarter
    if (nv > 0 && nv < kQuarter) {
      // Whole pages landed: V rows past the bound are zeroed first.
      constexpr int kChunks = SM::kRowBytes / 16;
      for (int idx = lane; idx < (kQuarter - nv) * kChunks; idx += 32)
        *reinterpret_cast<uint4*>(vt + tile_at<kTile, kBlock>(r0 + nv + idx / kChunks, (idx % kChunks) * 16)) =
            make_uint4(0u, 0u, 0u, 0u);
      fence_async_smem();  // before the next TMA into this stage
      __syncwarp();
    }
    if (nv > 0) {
      if constexpr (kMma) {
        // S = Q . K^T: two 8-token n-tiles, D / 16 k-steps.
        float sacc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t kb[4];
          if constexpr (kQuant) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const int8_t* kr = reinterpret_cast<const int8_t*>(kt + tile_at<kTile, kBlock>(r0 + nt * 8 + g, 16 * kk)) + 2 * q4;
              kb[2 * nt] = int8x2_to_bf16x2(kr[0], kr[1]);
              kb[2 * nt + 1] = int8x2_to_bf16x2(kr[8], kr[9]);
            }
          } else {
            const int mi = lane >> 3;
            ldmatrix_x4(kb, smem_addr(kt + tile_at<kTile, kBlock>(r0 + (mi >> 1) * 8 + (lane & 7), (16 * kk + (mi & 1) * 8) * 2)));
          }
          mma_bf16(sacc[0], qa[kk][0], 0u, qa[kk][1], 0u, kb[0], kb[1]);
          mma_bf16(sacc[1], qa[kk][0], 0u, qa[kk][1], 0u, kb[2], kb[3]);
        }
        // Online softmax of row g over the quarter's 16 tokens (the quad's
        // lanes hold 4 each).
        float x[2][2];
        float mx = m_run[0];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = nt * 8 + 2 * q4 + e;
            const float f = kQuant ? scl * ks[t] : scl;
            x[nt][e] = t < nv ? sacc[nt][e] * f : kMask;
            mx = fmaxf(mx, x[nt][e]);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float corr = fast_exp2(m_run[0] - mx);
        m_run[0] = mx;
        float p[2][2], psum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = nt * 8 + 2 * q4 + e;
            const bool ok = t < nv;
            p[nt][e] = fast_exp2(ok ? x[nt][e] - mx : -INFINITY);  // exact 0 when masked, no branch
            psum += p[nt][e];
            if (kQuant) p[nt][e] = ok ? p[nt][e] * vs[t] : 0.f;  // a tail's scale may be NaN
          }
        }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        l_run[0] = l_run[0] * corr + psum;
        // P as two bf16 terms, its rounding and what that rounding lost, so
        // that P.V keeps float32 accuracy (P in bf16 alone moved outputs by
        // up to 2^-9 of |v|: a bf16 step on outputs past 4).
        const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]), pa2 = pack_bf16(p[1][0], p[1][1]);
        const uint32_t pl0 = pack_bf16(p[0][0] - __uint_as_float(pa0 << 16), p[0][1] - __uint_as_float(pa0 & 0xffff0000u));
        const uint32_t pl2 = pack_bf16(p[1][0] - __uint_as_float(pa2 << 16), p[1][1] - __uint_as_float(pa2 & 0xffff0000u));
        // O = O * corr + P . V over D / 8 n-tiles of head dims.
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t vb[4];
          if constexpr (kQuant) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int dim = (2 * nd + i) * 8 + g;
              auto v8 = [&](int t) { return *reinterpret_cast<const int8_t*>(vt + tile_at<kTile, kBlock>(r0 + t, dim)); };
              vb[2 * i] = int8x2_to_bf16x2(v8(2 * q4), v8(2 * q4 + 1));
              vb[2 * i + 1] = int8x2_to_bf16x2(v8(2 * q4 + 8), v8(2 * q4 + 9));
            }
          } else {
            const int mi = lane >> 3;
            ldmatrix_x4_trans(vb, smem_addr(vt + tile_at<kTile, kBlock>(r0 + (mi & 1) * 8 + (lane & 7), (2 * nd + (mi >> 1)) * 16)));
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float acc[4] = {o[2 * (2 * nd + i)] * corr, o[2 * (2 * nd + i) + 1] * corr, 0.f, 0.f};
            mma_bf16(acc, pa0, 0u, pa2, 0u, vb[2 * i], vb[2 * i + 1]);
            mma_bf16(acc, pl0, 0u, pl2, 0u, vb[2 * i], vb[2 * i + 1]);
            o[2 * (2 * nd + i)] = acc[0];
            o[2 * (2 * nd + i) + 1] = acc[1];
          }
        }
      } else {
        // CUDA cores, float32: lane = (token t, half of the head dims).
        constexpr int EPC = 16 / (int)sizeof(TP);  // elements per 16-byte chunk
        const int t = lane & 15, half = lane >> 4;
        float acc[G];
#pragma unroll
        for (int gg = 0; gg < G; ++gg) acc[gg] = 0.f;
#pragma unroll 2
        for (int ch = 0; ch < D / 2 / EPC; ++ch) {
          float kf[EPC];
          chunk_to_f32(reinterpret_cast<const TP*>(kt + tile_at<kTile, kBlock>(r0 + t, (half * (D / 2) + ch * EPC) * (int)sizeof(TP))), kf);
#pragma unroll
          for (int gg = 0; gg < G; ++gg) {
            const float4* q4p = reinterpret_cast<const float4*>(q_s + gg * D + half * (D / 2) + ch * EPC);
#pragma unroll
            for (int e = 0; e < EPC / 4; ++e) {
              const float4 qv = q4p[e];
              acc[gg] += qv.x * kf[4 * e] + qv.y * kf[4 * e + 1] + qv.z * kf[4 * e + 2] +
                         qv.w * kf[4 * e + 3];
            }
          }
        }
        const bool ok = t < nv;
        float p[G];
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          float xs = acc[gg] + __shfl_xor_sync(0xffffffffu, acc[gg], 16);
          if constexpr (kQuant) xs *= ks[t];
          xs = ok ? xs : kMask;
          float mx = xs;
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m_run[gg], mx);
          const float corr = exp2f(m_run[gg] - m_new);
          p[gg] = exp2f(ok ? xs - m_new : -INFINITY);
          float ps = p[gg];
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
          l_run[gg] = l_run[gg] * corr + ps;
          m_run[gg] = m_new;
          if constexpr (kQuant) p[gg] = ok ? p[gg] * vs[t] : 0.f;  // a tail's scale may be NaN
#pragma unroll
          for (int i = 0; i < D / 32; ++i) o[gg * (D / 32) + i] *= corr;
        }
        // P.V: lane = head dims lane + 32 i; token tt's p from lane tt.
#pragma unroll 4
        for (int tt = 0; tt < kQuarter; ++tt) {
          float v[D / 32];
#pragma unroll
          for (int i = 0; i < D / 32; ++i)
            v[i] = to_f(*reinterpret_cast<const TP*>(vt + tile_at<kTile, kBlock>(r0 + tt, (lane + 32 * i) * (int)sizeof(TP))));
#pragma unroll
          for (int gg = 0; gg < G; ++gg) {
            const float pg = __shfl_sync(0xffffffffu, p[gg], tt);
#pragma unroll
            for (int i = 0; i < D / 32; ++i) o[gg * (D / 32) + i] += pg * v[i];
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

  // The four warps' states, merged through shared memory (the ring is
  // quiet: every tile's copies have landed and been read).
  bar_sync(kBarConsumers, kConsumerThreads);
  float* wm = reinterpret_cast<float*>(ring);  // [4][8]
  float* wl = wm + 32;                          // [4][8]
  float* wo = wl + 32;                          // [4][8][D]
  if constexpr (kMma) {
    if (g < G) {
      if (q4 == 0) {
        wm[warp * 8 + g] = m_run[0];
        wl[warp * 8 + g] = l_run[0];
      }
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<float2*>(wo + (warp * 8 + g) * D + 8 * nd + 2 * q4) =
            make_float2(o[2 * nd], o[2 * nd + 1]);
    }
  } else {
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      if (lane == 0) {
        wm[warp * 8 + gg] = m_run[gg];
        wl[warp * 8 + gg] = l_run[gg];
      }
#pragma unroll
      for (int i = 0; i < D / 32; ++i) wo[(warp * 8 + gg) * D + lane + 32 * i] = o[gg * (D / 32) + i];
    }
  }
  bar_sync(kBarConsumers, kConsumerThreads);
  // From here a thread per head dim d (threads past D idle in the sums).
  float M[G], Lsum[G], O[G];
#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    float mx = kMask;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (wl[w * 8 + gg] > 0.f) mx = fmaxf(mx, wm[w * 8 + gg]);
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float lw = wl[w * 8 + gg];
      const float wt = lw > 0.f ? exp2f(wm[w * 8 + gg] - mx) : 0.f;
      lsum += wt * lw;
      if (has_d && wt > 0.f) acc += wt * wo[(w * 8 + gg) * D + d];
    }
    M[gg] = mx;
    Lsum[gg] = lsum;
    O[gg] = acc;
  }

  if (parts > 1) {
    // This split's partial (the ring is read; write it out), then the last
    // split of the row merges them all in split order.
    const size_t part_elems = (size_t)G * (D + 2);
    float* part0 = ws + ((size_t)b * Hkv + h) * S * part_elems;
    float* mine = part0 + (size_t)s * part_elems;
    if (tid < G) {
      mine[tid] = M[tid];
      mine[G + tid] = Lsum[tid];
    }
    if (has_d) {
#pragma unroll
      for (int gg = 0; gg < G; ++gg) mine[2 * G + gg * D + d] = O[gg];
    }
    if (!last_of_split(counters + (size_t)b * Hkv + h, parts, flag, kBarConsumers,
                       kConsumerThreads, tid == 0))
      return;
    // Every part holds tokens (l > 0), so every load is unconditional and
    // none waits on another: first each part's m, then the sums.
#pragma unroll
    for (int gg = 0; gg < G; ++gg) M[gg] = kMask;
#pragma unroll 4
    for (int sp = 0; sp < parts; ++sp) {
      const float* pp = part0 + (size_t)sp * part_elems;
#pragma unroll
      for (int gg = 0; gg < G; ++gg) M[gg] = fmaxf(M[gg], __ldcg(pp + gg));
    }
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      Lsum[gg] = 0.f;
      O[gg] = 0.f;
    }
#pragma unroll 4
    for (int sp = 0; sp < parts; ++sp) {
      const float* pp = part0 + (size_t)sp * part_elems;
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        const float wt = exp2f(__ldcg(pp + gg) - M[gg]);
        Lsum[gg] += wt * __ldcg(pp + G + gg);
        if (has_d) O[gg] += wt * __ldcg(pp + 2 * G + gg * D + d);
      }
    }
  }

  TQ* out_row = out + ((size_t)b * Hq + (size_t)h * G) * D;
  if (length <= 0) {
    if (has_d) {
#pragma unroll
      for (int gg = 0; gg < G; ++gg) out_row[gg * D + d] = from_f<TQ>(0.f);
    }
    return;
  }
  if constexpr (!kFused) {
    // length > 0 leaves at least one live token, so Lsum > 0.
    if (has_d) {
#pragma unroll
      for (int gg = 0; gg < G; ++gg) out_row[gg * D + d] = from_f<TQ>(O[gg] / Lsum[gg]);
    }
  } else {
    // The current row: written to the row's own slot of head h (int8:
    // quantized here), and folded in as one more online-softmax step.
    TP* kp = kv + k_head * head_stride;
    TP* vp = kv + v_head * head_stride;
    const size_t slot_off = (size_t)slot * D + d;
    float k_cur = 0.f, v_cur = 0.f;
    if constexpr (kQuant) {
      float amax[2] = {fabsf(kx), fabsf(vx)};
      consumer_reduce<true>(amax, red);
      const float ksc = kv_scale_of(amax[0]), vsc = kv_scale_of(amax[1]);
      const float kq = quantize_to(kx, ksc), vq = quantize_to(vx, vsc);
      if (has_d) {
        kp[slot_off] = (int8_t)kq;
        vp[slot_off] = (int8_t)vq;
      }
      if (tid == 0) {
        kv_scale[k_head * num_slots + slot] = ksc;
        kv_scale[v_head * num_slots + slot] = vsc;
      }
      k_cur = kq * ksc;  // the float32 twin of the stored row
      v_cur = vq * vsc;
    } else if (has_d) {
      k_cur = kx;
      v_cur = vx;
      kp[slot_off] = from_f<TP>(kx);  // the pool's own dtype: exact
      vp[slot_off] = from_f<TP>(vx);
    }
    float dot[G];
#pragma unroll
    for (int gg = 0; gg < G; ++gg) dot[gg] = has_d ? qd[gg] * k_cur : 0.f;
    consumer_reduce<false>(dot, red);
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      const float sc = dot[gg] * scl;
      const float m_new = fmaxf(M[gg], sc);
      const float corr = exp2f(M[gg] - m_new);
      const float p = exp2f(sc - m_new);
      if (has_d) out_row[gg * D + d] = from_f<TQ>((O[gg] * corr + p * v_cur) / (Lsum[gg] * corr + p));
    }
  }
}

template <typename TQ, typename TP, int D, int G, bool kFused>
cudaError_t launch(const AttendArgs& a, const CUtensorMap& map, cudaStream_t stream) {
  constexpr int bytes = DecodeSmem<TQ, TP, D, G>::bytes;
  if (bytes > 48 * 1024) {
    static SmemOptIn opt_in;
    const cudaError_t err = opt_in.ensure(paged_decode_kernel<TQ, TP, D, G, kFused>, bytes);
    if (err != cudaSuccess) return err;
  }
  paged_decode_kernel<TQ, TP, D, G, kFused><<<dim3(a.splits, a.Hkv, a.B), kThreads, bytes, stream>>>(
      map, static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k_new),
      static_cast<const TQ*>(a.v_new), static_cast<TP*>(a.kv), a.kv_scale, a.slots,
      a.page_table, a.lengths, static_cast<TQ*>(a.out), a.ws, a.counters, a.Hq, a.Hkv, a.L,
      a.num_slots, a.page, a.max_pages, a.layer, a.span);
  return cudaGetLastError();
}

template <typename TQ, typename TP, int D, bool kFused>
cudaError_t launch_g(const AttendArgs& a, const CUtensorMap& map, cudaStream_t stream) {
  switch (a.Hq / a.Hkv) {
    case 1: return launch<TQ, TP, D, 1, kFused>(a, map, stream);
    case 2: return launch<TQ, TP, D, 2, kFused>(a, map, stream);
    case 3: return launch<TQ, TP, D, 3, kFused>(a, map, stream);
    case 4: return launch<TQ, TP, D, 4, kFused>(a, map, stream);
    case 5: return launch<TQ, TP, D, 5, kFused>(a, map, stream);
    case 6: return launch<TQ, TP, D, 6, kFused>(a, map, stream);
    case 7: return launch<TQ, TP, D, 7, kFused>(a, map, stream);
    case 8: return launch<TQ, TP, D, 8, kFused>(a, map, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TP, bool kFused>
cudaError_t launch_d(const AttendArgs& a, cudaStream_t stream) {
  if (a.D != 64 && a.D != 128) return cudaErrorInvalidValue;
  // The pool [2, L, Hkv, num_slots, D] as rows of D: boxes of the kernel's
  // box_rows (8, unused, for pages gathered row by row) by a 128-byte
  // column block, 128-byte swizzled (64-byte rows, int8 at D 64, whole and
  // unswizzled).
  const int elem = (int)sizeof(TP), block = a.D * elem < 128 ? a.D * elem : 128;
  CUtensorMap map;
  const cudaError_t err = tensor_map_2d(
      &map, a.kv, (uint64_t)2 * a.L * a.Hkv * a.num_slots, a.D,
      elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      elem, block / elem, box_rows_of(a.page, kTile),
      block == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  if (a.D == 64) return launch_g<TQ, TP, 64, kFused>(a, map, stream);
  return launch_g<TQ, TP, 128, kFused>(a, map, stream);
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only, with
// kv_scale). Pools of bf16/f32 take queries of their own dtype; int8
// pools take bf16 or f32 queries. splits * span must cover the page
// table's max_pages * page tokens, span a multiple of kTile; ws and
// counters are needed when splits > 1. page: any size >= 1.
template <bool kFused>
int attend_dispatch(int q_dtype, int pool_dtype, const AttendArgs& a, void* stream) {
  if (a.B == 0) return 0;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.B > 65535 || a.Hkv > 65535 || a.page <= 0 ||
      (long long)2 * a.L * a.Hkv * a.num_slots >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if ((pool_dtype == 2) != (a.kv_scale != nullptr)) return (int)cudaErrorInvalidValue;
  if (a.splits <= 0 || a.span <= 0 || a.span % kTile != 0 ||
      (long long)a.splits * a.span < (long long)a.max_pages * a.page ||
      (a.splits > 1 && (a.ws == nullptr || a.counters == nullptr)))
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
