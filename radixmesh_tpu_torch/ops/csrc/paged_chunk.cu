// Paged chunk-prefill attention for Hopper (sm_90a), on the CUDA cores in
// fp32: the body for float32 queries (float32 pools, and int8 pools with
// float32 queries). Nothing serves those; they exist for the float32
// whole-path check (card vs CPU at atol 1e-3, kernel vs plain at 1e-4),
// which bf16 operands on the tensor cores (or TF32) would not meet. bf16
// queries, the serving path, take the tensor-core body in
// paged_chunk_tc.cu.
//
// Replaces: radixmesh_tpu/ops/paged_attention.py,
// paged_chunk_attention_kernel (Pallas body _chunk_kernel).
//
// What it computes, per row b, kv head h and block of Cblk queries: the
// queries sit at canonical positions prior + arange(C). They attend to the
// row's prior_lengths[b] pool tokens, found through the page table in any
// page order, then to the chunk's own dense K/V, causal within the chunk
// (key c_k <= query c_q) and bounded by kv_lengths[b] (prior + c_k <
// kv_lengths). Online softmax in fp32 (in base 2: queries pre-scaled by
// log2(e)/sqrt(D), exp2f), output [B, C, Hq, D] in float32, zeros where
// the softmax denominator is 0. Every query row computes, live or past
// kv_lengths (the JAX contract).
//
// What bounds it on an H100: operations, at the 67 TFLOP/s float32 FFMA
// rate of the CUDA cores. It does 4*Hq*D*sum_b C*(prior + C/2) flops
// against 2*Hkv*D*sum_b prior elements of pool K/V read. An SM issues four
// warp-FFMAs per clock but serves about one 128-byte shared-memory
// wavefront, so the design is about keeping shared-memory traffic under
// the FFMA rate:
// - One CTA of 256 threads per (query block, kv head, row), query block
//   fastest in the grid, so the blocks that share one (row, kv head) prior
//   run together and read it from L2 after its first pass. Up to 128 query
//   rows r = (c - c0)*G + g per CTA (Cblk*G <= 128), all G heads of the
//   group sharing each K/V tile. Rows >= R are padding, zero and masked;
//   where R <= 64 (C = 16 at G 4, a speculative verify's C = 5) the
//   threads skip their padding half, and a warp whose rows are all padding
//   skips the arithmetic of every tile.
// - Register tiles. Thread (ty, tx) = (tid / 16, tid % 16) owns rows
//   4ty..4ty+3 and 64+4ty..64+4ty+3, keys tx + 16j (j < 4) of each 64-key
//   tile and output columns 4(tx + 16k)..+3 (k < D/64): an 8x4 block of
//   scores and an 8 x D/16 block of the accumulator. Q.K^T reads, per 4
//   head dims, 8 Q and 4 K float4 (LDS.128) for 128 FFMAs; P.V reads, per
//   key, 2 P and D/64 V float4 for 8*D/16 FFMAs. Shared rows are padded
//   by 16 bytes, which makes every fragment load and store of a quarter
//   warp conflict-free; a warp's Q and P loads are broadcasts.
// - Warp-parallel online softmax: a row's 64 scores of a tile sit on the
//   16 threads of one half warp. The 8 row maxima of a thread's rows are
//   reduced over those 16 threads with 15 __shfl_xor_sync (row_max16);
//   the running max sits in registers of all 16, and each keeps its own
//   partial row sum (all scale by the same correction), added over the
//   16 once, after the last tile. P goes to shared memory as P^T [key]
//   [row] (in the K tile's buffer when D = 128: S no longer needs K).
// - Pipelined K/V: 64-token K and V tiles move by cp.async (16 bytes a
//   thread) into a 2-stage ring; tile i+1 is in flight while tile i
//   computes. The page-table entries of a tile's tokens come into shared
//   memory by cp.async too, with the copies of the tile before it, so no
//   thread waits on a page-table load. Rows past each bound are
//   zero-filled (source size 0), never read.
// - int8 pools: a prior tile's int8 bytes and its k/v scales are copied
//   by cp.async into a staging buffer, then widened to fp32 (exactly,
//   int8x4_to_f32) and multiplied by the token's scale into the ring, the
//   plain version's arithmetic (dequantize, then dot). The chunk's own K/V
//   arrive already dequantized, in float32 (what the pool will hold).
// - Masking: masked scores take the finite kMask, masked probabilities
//   are exactly 0 and masked K/V rows exact zeros in shared memory, so NaN
//   or Inf in an unreferenced page, a page tail or a padded chunk position
//   never reaches the accumulator.

#include <type_traits>

#include "common.cuh"

namespace radixmesh {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;  // query rows (Cblk * G) per CTA, at most
constexpr int kKeys = 64;   // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPad = 4;     // floats of padding per shared row (16 bytes)
constexpr int kPStride = kRows + kPad;  // floats per row of P^T (one key, every query row)

// Shared memory, in floats from the base: Q [kRows][D + kPad] (pre-scaled);
// the K/V ring [2 stages][K, V][kKeys][D + kPad]; P^T [kKeys][kPStride],
// its own buffer only where the K tile is too small for it; int8 pools:
// the staged tile's k/v scales [K, V][kKeys]; the page-table entries of
// two prior tiles' tokens [2][kKeys] (int); int8 pools: the staged tile's
// bytes [K, V][kKeys][D].
template <int D, bool kQuant>
struct Layout {
  static constexpr int kStride = D + kPad;
  static constexpr int kTile = kKeys * kStride;
  static constexpr bool kPInK = kStride >= kPStride;
  static constexpr int q = 0;
  static constexpr int kv = kRows * kStride;
  static constexpr int p = kv + 4 * kTile;
  static constexpr int sc = p + (kPInK ? 0 : kKeys * kPStride);
  static constexpr int pg = sc + (kQuant ? 2 * kKeys : 0);
  static constexpr int raw = pg + 2 * kKeys;
  static constexpr size_t bytes = sizeof(float) * raw + (kQuant ? 2 * kKeys * D : 0);
  static_assert(bytes <= 232448, "over the 227 KB a CTA may use");
};

// The maxima v[a] of 8 rows, one value per thread of a 16-thread group
// (lane bits 0-3 = tx), reduced over the group and returned in every
// thread: a reduce-scatter (8 rows -> 4 -> 2 -> 1 per thread over lane
// masks 8, 4, 2, then 1) and an all-gather back to 8, 15 shuffles where a
// butterfly per row takes 32.
__device__ __forceinline__ void row_max16(float (&v)[8], int tx) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool h8 = tx & 8, h4 = tx & 4, h2 = tx & 2;
  float u[4], w[2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    u[k] = fmaxf(h8 ? v[4 + k] : v[k], __shfl_xor_sync(kAll, h8 ? v[k] : v[4 + k], 8));
#pragma unroll
  for (int k = 0; k < 2; ++k)
    w[k] = fmaxf(h4 ? u[2 + k] : u[k], __shfl_xor_sync(kAll, h4 ? u[k] : u[2 + k], 4));
  float x = fmaxf(h2 ? w[1] : w[0], __shfl_xor_sync(kAll, h2 ? w[0] : w[1], 2));
  x = fmaxf(x, __shfl_xor_sync(kAll, x, 1));  // row 4*h8 + 2*h4 + h2, whole group
  const float y = __shfl_xor_sync(kAll, x, 2);
  w[0] = h2 ? y : x;
  w[1] = h2 ? x : y;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float z = __shfl_xor_sync(kAll, w[k], 4);
    u[k] = h4 ? z : w[k];
    u[2 + k] = h4 ? w[k] : z;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float z = __shfl_xor_sync(kAll, u[k], 8);
    v[k] = h8 ? z : u[k];
    v[4 + k] = h8 ? u[k] : z;
  }
}

// TQ: queries and output; TP: the pool (int8_t with kv_scale); TC: the
// chunk's dense K/V (the pool dtype for f32 pools, float for int8).
template <typename TQ, typename TP, typename TC, int D, int G>
__global__ void __launch_bounds__(kThreads, 1) paged_chunk_kernel(
    const TQ* __restrict__ q,             // [B, C, Hq, D]
    const TC* __restrict__ k_cur,         // [B, C, Hkv, D]
    const TC* __restrict__ v_cur,         // [B, C, Hkv, D]
    const TP* __restrict__ kv,            // [2, L, Hkv, num_slots, D]
    const float* __restrict__ kv_scale,   // [2, L, Hkv, num_slots] (int8 pools)
    const int* __restrict__ page_table,   // [B, max_pages]
    const int* __restrict__ prior_lengths,  // [B]
    const int* __restrict__ kv_lengths,   // [B]
    TQ* __restrict__ out,                 // [B, C, Hq, D]
    int C, int Hq, int Hkv, int L, int num_slots, int page, int max_pages,
    int layer, int cblk) {
  static_assert(std::is_same<TQ, float>::value && std::is_same<TC, float>::value,
                "the CUDA-core body takes float32 queries and chunk K/V");
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  using SM = Layout<D, kQuant>;
  constexpr int S_ = SM::kStride;
  constexpr int NK = D / 64;  // output float4 columns per thread
  // 16-byte copy units per K/V row, and rows per thread per tile: prior
  // tiles from the pool (int8 bytes or floats), dense tiles (floats).
  constexpr int PU = kQuant ? D / 16 : D / 4;
  constexpr int PT = kKeys * PU / kThreads;
  constexpr int DU = D / 4;
  constexpr int DT = kKeys * DU / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + SM::q;
  float* sc_s = smem + SM::sc;
  int* pg_s = reinterpret_cast<int*>(smem + SM::pg);
  int8_t* raw_s = reinterpret_cast<int8_t*>(smem + SM::raw);
  auto tile = [&](int stage, int which) { return smem + SM::kv + (stage * 2 + which) * SM::kTile; };

  const int cb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int R = cblk * G;
  const bool warp_live = 8 * (tid >> 5) < R;  // warp w's rows 8w.. (and 64 + 8w..): one is live
  const int c0 = cb * cblk;
  const int prior = min(max(prior_lengths[b], 0), max_pages * page);
  const int n_dense = min(max(kv_lengths[b] - prior, 0), C);
  const int k_end = min(c0 + cblk, n_dense);  // dense keys any row of this block sees
  const int n_prior_tiles = (prior + kKeys - 1) / kKeys;
  const int n_tiles = n_prior_tiles + (k_end + kKeys - 1) / kKeys;
  const int page_shift = page_shift_of(page);

  const size_t head_stride = (size_t)num_slots * D;
  const TP* k_pool = kv + ((size_t)layer * Hkv + h) * head_stride;
  const TP* v_pool = kv + ((size_t)(L + layer) * Hkv + h) * head_stride;
  const float* k_sc = kQuant ? kv_scale + ((size_t)layer * Hkv + h) * num_slots : nullptr;
  const float* v_sc = kQuant ? kv_scale + ((size_t)(L + layer) * Hkv + h) * num_slots : nullptr;
  const int* pt = page_table + (size_t)b * max_pages;
  const size_t cur_stride = (size_t)Hkv * D;
  const TC* k_row0 = k_cur + ((size_t)b * C * Hkv + h) * D;
  const TC* v_row0 = v_cur + ((size_t)b * C * Hkv + h) * D;

  // Page-table entries of prior tile i's tokens, copied by threads below
  // kKeys into pg_s[i & 1] one tile before tile i's copies are issued
  // (rows past the prior are not copied, and never read).
  auto lookup = [&](int i) {
    const int tok = i * kKeys + tid;
    if (i < n_prior_tiles && tid < kKeys && tok < prior)
      cp_async4(smem_addr(pg_s + (i & 1) * kKeys + tid),
                pt + (page_shift >= 0 ? tok >> page_shift : tok / page), true);
  };
  // Pool slot of row `row` of prior tile i, from its page-table entry.
  auto slot = [&](int i, int row) {
    const int tok = i * kKeys + row, pg = pg_s[(i & 1) * kKeys + row];
    return page_shift >= 0 ? (pg << page_shift) | (tok & (page - 1)) : pg * page + tok % page;
  };
  // Start the copies of tile i into ring stage `stage` (int8 prior tiles:
  // into the staging buffer).
  auto issue = [&](int i, int stage) {
    if (i < n_prior_tiles) {
      const int n = min(kKeys, prior - i * kKeys);
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        const int idx = tid + p * kThreads, row = idx / PU, u = idx % PU;
        const bool ok = row < n;
        const size_t off = ok ? (size_t)slot(i, row) * D + u * (16 / (int)sizeof(TP)) : 0;
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          const TP* src = (which ? v_pool : k_pool) + off;
          if constexpr (kQuant) {
            cp_async16(smem_addr(raw_s + (which * kKeys + row) * D + u * 16), src, ok);
          } else {
            cp_async16(smem_addr(tile(stage, which) + row * S_ + u * 4), src, ok);
          }
        }
      }
      if constexpr (kQuant) {
        if (tid < 2 * kKeys) {
          const int row = tid & (kKeys - 1);
          const bool ok = row < n;
          const float* scp = tid < kKeys ? k_sc : v_sc;
          cp_async4(smem_addr(sc_s + tid), scp + (ok ? slot(i, row) : 0), ok);
        }
      }
    } else {
      const int k0 = (i - n_prior_tiles) * kKeys, n = min(kKeys, k_end - k0);
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const TC* base = which ? v_row0 : k_row0;
#pragma unroll
        for (int p = 0; p < DT; ++p) {
          const int idx = tid + p * kThreads, row = idx / DU, u = idx % DU;
          const bool ok = row < n;
          const TC* src = ok ? base + (size_t)(k0 + row) * cur_stride + u * 4 : base;
          cp_async16(smem_addr(tile(stage, which) + row * S_ + u * 4), src, ok);
        }
      }
    }
  };
  // int8 pages: the staged bytes times each token's scale, into the ring.
  auto widen = [&](int stage) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
#pragma unroll
      for (int p = 0; p < kKeys * D / 16 / kThreads; ++p) {
        const int idx = tid + p * kThreads, row = idx / (D / 16), u = idx % (D / 16);
        const uint4 w = *reinterpret_cast<const uint4*>(raw_s + (which * kKeys + row) * D + u * 16);
        const float s = sc_s[which * kKeys + row];
        float f[16];
        int8x4_to_f32(w.x, f);
        int8x4_to_f32(w.y, f + 4);
        int8x4_to_f32(w.z, f + 8);
        int8x4_to_f32(w.w, f + 12);
        float* dst = tile(stage, which) + row * S_ + u * 16;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          *reinterpret_cast<float4*>(dst + 4 * m) =
              make_float4(f[4 * m] * s, f[4 * m + 1] * s, f[4 * m + 2] * s, f[4 * m + 3] * s);
      }
    }
  };

  lookup(0);
  lookup(1);
  cp_async_commit();

  // Query rows r = (c - c0) * G + g, pre-scaled by log2(e)/sqrt(D) (the
  // softmax runs in base 2); rows >= R stay zero.
  const float scale = kLog2e / sqrtf((float)D);
#pragma unroll 4
  for (int e = tid; e < kRows * D / 4; e += kThreads) {
    const int r = e / (D / 4), u = e % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < R) {
      v = *reinterpret_cast<const float4*>(
          q + (((size_t)b * C + c0 + r / G) * Hq + (size_t)h * G + r % G) * D + u * 4);
      v.x *= scale;
      v.y *= scale;
      v.z *= scale;
      v.w *= scale;
    }
    *reinterpret_cast<float4*>(Qs + r * S_ + u * 4) = v;
  }
  cp_async_wait<0>();
  __syncthreads();  // tiles 0 and 1's page-table entries have landed
  if (n_tiles > 0) issue(0, 0);
  cp_async_commit();

  // This thread's rows: row(i) = 4ty + i (i < 4), 64 + 4ty + i - 4 (i >= 4).
  auto row_of = [&](int i) { return (i < 4 ? 0 : 64 - 4) + 4 * ty + i; };
  float m[8], l[8], o[8][NK][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][k][e] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    const bool is_prior = i < n_prior_tiles;
    cp_async_wait<0>();
    __syncthreads();  // tile i has landed; every reader of tile i-1 is done
    if constexpr (kQuant) {
      if (is_prior) {
        widen(st);
        __syncthreads();
      }
    }
    if (i + 1 < n_tiles) issue(i + 1, st ^ 1);
    lookup(i + 2);  // into pg_s[i & 1]: issue(i) has read it
    cp_async_commit();

    const float* Kt = tile(st, 0);
    const float* Vt = tile(st, 1);
    float* Pt = SM::kPInK ? tile(st, 0) : smem + SM::p;
    // Keys of this tile and, per row, how many of them it sees: all n of
    // a prior tile; a dense tile's keys k0 + t <= its chunk offset.
    const int k0 = is_prior ? 0 : (i - n_prior_tiles) * kKeys;
    const int n = is_prior ? min(kKeys, prior - i * kKeys) : min(kKeys, k_end - k0);
    float s[8][4], corr[8];

    // S = Q . K^T for this thread's first NR rows x 4 keys, then the online
    // softmax. Masked scores take kMask; each row's max over its 16
    // threads comes from row_max16; the row sum stays a per-thread partial
    // (every thread of a row scales by the same corr), summed over the 16
    // threads once, after the last tile.
    auto scores = [&](auto nr) {
      constexpr int NR = decltype(nr)::value;
#pragma unroll
      for (int a = 0; a < NR; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
      const float* qp = Qs + 4 * ty * S_;
      const float* kp = Kt + tx * S_;
#pragma unroll 4  // fully unrolled, the two row counts' loops crowd the instruction cache
      for (int u = 0; u < D / 4; ++u) {
        float4 kf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) kf[j] = *reinterpret_cast<const float4*>(kp + 16 * j * S_ + 4 * u);
#pragma unroll
        for (int a = 0; a < NR; ++a) {
          const float4 qf = *reinterpret_cast<const float4*>(
              qp + ((a < 4 ? 0 : 64 - 4) + a) * S_ + 4 * u);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[a][j] = fmaf(qf.x, kf[j].x, s[a][j]);
            s[a][j] = fmaf(qf.y, kf[j].y, s[a][j]);
            s[a][j] = fmaf(qf.z, kf[j].z, s[a][j]);
            s[a][j] = fmaf(qf.w, kf[j].w, s[a][j]);
          }
        }
      }
      int lim[8];  // per row, the tile's keys t < lim[a] it sees
      float mx[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int r = row_of(a);
        lim[a] = r >= R ? 0 : is_prior ? n : min(n, c0 + r / G - k0 + 1);
        mx[a] = kMask;
        if (a < NR) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (tx + 16 * j >= lim[a]) s[a][j] = kMask;
            mx[a] = fmaxf(mx[a], s[a][j]);
          }
        }
      }
      row_max16(mx, tx);
#pragma unroll
      for (int a = 0; a < NR; ++a) {
        const float m_new = fmaxf(m[a], mx[a]);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[a][j] = tx + 16 * j < lim[a] ? exp2f(s[a][j] - m_new) : 0.f;
          sum += s[a][j];
        }
        corr[a] = exp2f(m[a] - m_new);
        l[a] = l[a] * corr[a] + sum;
        m[a] = m_new;
      }
    };
    // P^T [key][row] of the first NR rows to shared memory.
    auto store_p = [&](auto nr) {
      constexpr int NR = decltype(nr)::value;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* dst = Pt + (tx + 16 * j) * kPStride + 4 * ty;
        *reinterpret_cast<float4*>(dst) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        if (NR == 8)
          *reinterpret_cast<float4*>(dst + 64) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
      }
    };
    // O = O * corr + P . V for the first NR rows, over the tile's first n
    // keys (8 at a time; the rest of each 8 have P = 0 and V = 0).
    auto accumulate = [&](auto nr) {
      constexpr int NR = decltype(nr)::value;
#pragma unroll
      for (int a = 0; a < NR; ++a)
#pragma unroll
        for (int k = 0; k < NK; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[a][k][e] *= corr[a];
      const float* pp = Pt + 4 * ty;
      const float* vp = Vt + 4 * tx;
      for (int t0 = 0; t0 < n; t0 += 8) {
#pragma unroll
        for (int t = t0; t < t0 + 8; ++t) {
          const float4 p0 = *reinterpret_cast<const float4*>(pp + t * kPStride);
          const float4 p1 = NR == 8 ? *reinterpret_cast<const float4*>(pp + t * kPStride + 64) : p0;
          const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
          for (int k = 0; k < NK; ++k) {
            const float4 vf = *reinterpret_cast<const float4*>(vp + t * S_ + 64 * k);
#pragma unroll
            for (int a = 0; a < NR; ++a) {
              o[a][k][0] = fmaf(pr[a], vf.x, o[a][k][0]);
              o[a][k][1] = fmaf(pr[a], vf.y, o[a][k][1]);
              o[a][k][2] = fmaf(pr[a], vf.z, o[a][k][2]);
              o[a][k][3] = fmaf(pr[a], vf.w, o[a][k][3]);
            }
          }
        }
      }
    };
    // Rows >= R are padding: with R <= 64 every thread's rows 64 + ...
    // are, and a warp whose rows all are (8 * warp >= R) skips the tile's
    // arithmetic, keeping only its copies and barriers.
    using All = std::integral_constant<int, 8>;
    using Half = std::integral_constant<int, 4>;
    if (warp_live) R > 64 ? scores(All{}) : scores(Half{});
    if constexpr (SM::kPInK) __syncthreads();  // every thread is done reading this K tile
    if (warp_live) R > 64 ? store_p(All{}) : store_p(Half{});
    __syncthreads();
    if (warp_live) R > 64 ? accumulate(All{}) : accumulate(Half{});
  }
  cp_async_wait<0>();
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l[a] += __shfl_xor_sync(0xffffffffu, l[a], off);

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int r = row_of(a);
    if (r < R) {
      const int c = c0 + r / G, g = r % G;
      TQ* dst = out + (((size_t)b * C + c) * Hq + (size_t)h * G + g) * D + 4 * tx;
      const float la = l[a];
#pragma unroll
      for (int k = 0; k < NK; ++k)
        *reinterpret_cast<float4*>(dst + 64 * k) =
            la > 0.f ? make_float4(o[a][k][0] / la, o[a][k][1] / la, o[a][k][2] / la, o[a][k][3] / la)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Arguments of one launch; kv_scale only for int8 pools.
struct ChunkArgs {
  const void* q;
  const void* k_cur;
  const void* v_cur;
  const void* kv;
  const float* kv_scale;
  const int* pt;
  const int* prior;
  const int* kvlen;
  void* out;
  int B, C, Hq, Hkv, D, L, num_slots, page, max_pages, layer, cblk;
};

template <typename TQ, typename TP, typename TC, int D, int G>
cudaError_t launch(const ChunkArgs& a, cudaStream_t stream) {
  constexpr size_t bytes = Layout<D, std::is_same<TP, int8_t>::value>::bytes;
  static SmemOptIn opt_in;
  cudaError_t err = opt_in.ensure(paged_chunk_kernel<TQ, TP, TC, D, G>, (int)bytes);
  if (err != cudaSuccess) return err;
  paged_chunk_kernel<TQ, TP, TC, D, G>
      <<<dim3(a.C / a.cblk, a.Hkv, a.B), kThreads, bytes, stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k_cur),
          static_cast<const TC*>(a.v_cur), static_cast<const TP*>(a.kv), a.kv_scale,
          a.pt, a.prior, a.kvlen, static_cast<TQ*>(a.out), a.C, a.Hq, a.Hkv, a.L,
          a.num_slots, a.page, a.max_pages, a.layer, a.cblk);
  return cudaGetLastError();
}

template <typename TQ, typename TP, typename TC, int D>
cudaError_t launch_g(const ChunkArgs& a, cudaStream_t stream) {
  switch (a.Hq / a.Hkv) {
    case 1: return launch<TQ, TP, TC, D, 1>(a, stream);
    case 2: return launch<TQ, TP, TC, D, 2>(a, stream);
    case 3: return launch<TQ, TP, TC, D, 3>(a, stream);
    case 4: return launch<TQ, TP, TC, D, 4>(a, stream);
    case 5: return launch<TQ, TP, TC, D, 5>(a, stream);
    case 6: return launch<TQ, TP, TC, D, 6>(a, stream);
    case 7: return launch<TQ, TP, TC, D, 7>(a, stream);
    case 8: return launch<TQ, TP, TC, D, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TP, typename TC>
cudaError_t launch_d(const ChunkArgs& a, cudaStream_t stream) {
  if (a.D == 64) return launch_g<TQ, TP, TC, 64>(a, stream);
  if (a.D == 128) return launch_g<TQ, TP, TC, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace radixmesh

// Bytes of dynamic shared memory a launch of the body takes at head dim D
// (64 or 128) for pool_dtype 0 (float32) or 2 (int8); 0 for other values.
extern "C" int paged_chunk_smem_bytes(int D, int pool_dtype) {
  using radixmesh::Layout;
  if (pool_dtype != 0 && pool_dtype != 2) return 0;
  const bool quant = pool_dtype == 2;
  if (D == 64) return (int)(quant ? Layout<64, true>::bytes : Layout<64, false>::bytes);
  if (D == 128) return (int)(quant ? Layout<128, true>::bytes : Layout<128, false>::bytes);
  return 0;
}

// q_dtype: must be 0 (float32; bfloat16 queries take
// paged_chunk_tc_launch); pool_dtype: 0 = float32 (k_cur/v_cur float32),
// or 2 = int8 with kv_scale [2, L, Hkv, num_slots] f32 (else nullptr) and
// k_cur/v_cur in float32. cblk = queries per CTA
// (divides C, cblk * (Hq / Hkv) <= 128). Returns the cudaError_t of the
// launch (0 on success). Launches on `stream`; allocates nothing.
extern "C" int paged_chunk_launch(int q_dtype, int pool_dtype, const void* q,
                                  const void* k_cur, const void* v_cur, const void* kv,
                                  const void* kv_scale, const void* page_table,
                                  const void* prior_lengths, const void* kv_lengths,
                                  void* out, int B, int C, int Hq, int Hkv, int D, int L,
                                  int num_slots, int page, int max_pages, int layer,
                                  int cblk, void* stream) {
  using namespace radixmesh;
  if (B == 0 || C == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || cblk <= 0 || C % cblk != 0 ||
      cblk * (Hq / Hkv) > kRows)
    return (int)cudaErrorInvalidValue;
  if ((pool_dtype == 2) != (kv_scale != nullptr)) return (int)cudaErrorInvalidValue;
  const ChunkArgs a{q, k_cur, v_cur, kv, static_cast<const float*>(kv_scale),
                    static_cast<const int*>(page_table),
                    static_cast<const int*>(prior_lengths),
                    static_cast<const int*>(kv_lengths), out, B, C, Hq, Hkv, D, L,
                    num_slots, page, max_pages, layer, cblk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && pool_dtype == 0) return (int)launch_d<float, float, float>(a, s);
  if (q_dtype == 0 && pool_dtype == 2) return (int)launch_d<float, int8_t, float>(a, s);
  return (int)cudaErrorInvalidValue;
}
