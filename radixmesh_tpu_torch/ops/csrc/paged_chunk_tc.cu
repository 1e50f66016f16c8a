// Paged chunk-prefill attention on Hopper's tensor cores (sm_90a: wgmma,
// TMA, mbarriers): the body for bfloat16 queries (bf16 pools, and int8
// pools with bf16 queries), which is what serving runs. Float32 queries
// take the CUDA-core body in paged_chunk.cu, kept for the float32
// whole-path check at atol 1e-3/1e-4, which bf16 operands (or TF32) would
// not meet.
//
// Replaces: radixmesh_tpu/ops/paged_attention.py,
// paged_chunk_attention_kernel (Pallas body _chunk_kernel).
//
// What it computes, per row b, kv head h and block of cblk queries: the
// queries sit at canonical positions prior + arange(C). They attend to the
// row's prior_lengths[b] pool tokens, found through the page table in any
// page order, then to the chunk's own dense K/V, causal within the chunk
// (key c_k <= query c_q) and bounded by kv_lengths[b] (prior + c_k <
// kv_lengths). Online softmax in fp32, output [B, C, Hq, D] in bf16,
// zeros where the softmax denominator is 0.
//
// What bounds it on an H100: operations at C = 512 (4*Hq*D*C*(prior +
// C/2) flops against 2*Hkv*D*prior pool elements: ~256 flops per K/V
// element, near the ~295 flops per byte where the bf16 tensor cores bind),
// bytes at C <= 16 (a speculative verify or a mixed wave's floor reads the
// whole prior for 5 or 16 queries per row).
//
// What the design does about each:
// - Warp specialisation (384 threads). Warpgroup 0 is the producer: it
//   gives most of its registers back (setmaxnreg); its first thread looks
//   up the page table and issues the pool's K/V tiles of 64 keys by TMA —
//   one box per page (or per its largest power-of-two part up to 64 rows)
//   and 64 columns of a 2-D tensor map over the pool seen as
//   [2*L*Hkv*num_slots, D] rows, 128-byte swizzled, so a tile lands in the
//   layout wgmma reads. A ring of 4 stages (3 for int8 pools) with a full
//   and an empty mbarrier each replaces every CTA-wide barrier of the main
//   loop. Pages that are not a multiple of 8 tokens (a box of fewer rows
//   would break the swizzled tile's 1024-byte alignment) are gathered row
//   by row by the producer warpgroup instead (by cp.async, as the chunk's
//   dense rows are; int8 rows into the staging ring below, in a kernel
//   instance of their own). Warpgroups 1 and 2 consume: 64 query rows
//   each, 128 rows = cblk*G (rows r = (c - c0)*G + g; rows past R have
//   zero Q and are never written). Both read every K/V tile, so the pool
//   streams once per 128 query rows of a kv head.
// - S = Q.K^T with wgmma m64n64k16 (bf16 in, fp32 accumulators). Q stays in
//   shared memory, unscaled; the 1/sqrt(D) scale (and for int8 pools the
//   per-token k_scale) multiplies the fp32 scores. O += P.V with wgmma
//   m64nDk16, P from registers as bf16; for int8 pools P is multiplied by
//   v_scale first (the JAX kernel's order) while the denominator takes P
//   unscaled. V's [keys, D] rows are MN-major for the B operand: the
//   descriptor's transpose bit reads them as they land.
// - Each consumer overlaps its own work (FlashAttention-3's intra-warpgroup
//   pipelining): it issues S(j) and P.V(j-1) together, waits for S(j) alone
//   (wgmma.wait_group 1), runs the softmax of tile j while P.V(j-1) runs,
//   then rescales O. P is double-buffered in registers, so no wgmma input
//   is written inside a stage (which would serialize the stage). The two
//   consumers also take turns issuing (named barriers), so one's softmax
//   overlaps the other's products. The softmax is straight-line code: a
//   masked key's exponent is -inf, so no exponential sits behind a branch.
// - Small C: all C queries of a (row, kv head) share one CTA while C*G <=
//   128 (the host's query block, a ragged last block allowed), and the
//   host splits each (row, kv head, query block)'s tiles — prior, then
//   dense — over CTAs, from shapes alone. The CTAs of a split write fp32
//   partials (m, l, O); the last to finish, counted by an atomic counter
//   that it puts back to 0, merges them by log-sum-exp in split order
//   (deterministic) and writes the output: one launch.
// - Masking only where it is needed: a tile that every row sees whole and
//   that carries no int8 scale skips the masks, at any R. TMA loads whole
//   pages, so the producer zeroes the V rows past the bound of the tile
//   that ends inside a page (0 x NaN in a page tail would poison P.V);
//   masked scores take the finite kMask and masked probabilities exactly
//   0.
// - int8 pages come by TMA as int8 rows (and their scales by bulk copies of
//   64 B per page) into a 5-deep staging ring, 4 tiles ahead, and the
//   producer warpgroup widens them to bf16 in the swizzled layout (exact:
//   |x| <= 127), rows past the bound zeroed; the consumers never wait on
//   that copy. The chunk's dense K/V (at most C/64 tiles) are staged by the
//   producer warpgroup: by cp.async on a barrier of their own (bf16), or
//   rounded from float32 (int8 pools: a relative error up to 2^-9 per
//   element, on top of the int8 rounding the pool holds).
//
// PERF.md records the card times, the cost of a 64-key tile at C = 512
// against its wgmma time, and what did not move it.

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace radixmesh {
namespace {

constexpr int kProducers = 128;  // warpgroup 0
constexpr int kConsumers = 256;  // warpgroups 1 and 2
constexpr int kThreads = kProducers + kConsumers;
constexpr int kRows = 128;  // query rows (cblk * G) per CTA, at most
constexpr int kKeys = 64;   // keys per tile
// Ring depths: bf16 tiles (4; 3 for int8 pools, whose producer keeps 4 raw
// tiles in flight in a 5-deep staging ring instead: 4 stages and 3 raw
// were slower).
template <bool kQuant>
struct Depth {
  static constexpr int stages = kQuant ? 3 : 4;
  static constexpr int raw = kQuant ? 5 : 1;
};
constexpr int kMaxStages = 4, kMaxRaw = 5;
constexpr int kAtom = 64 * 128;  // bytes of one 64-row x 128-byte swizzled column block
constexpr float kLog2e = 1.4426950408889634f;
// Named barriers: 1 and 2 the consumers' turns, 3 the producer warpgroup,
// 4 the consumers' epilogue.
constexpr int kBarProducer = 3, kBarConsumers = 4;
// Registers per thread after the producer gives its own back: 128 * 56 +
// 256 * 224 = 384 * 168, the launch's allocation.
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

// Shared memory, from a 1024-byte-aligned base: the barriers, Q [2
// warpgroups][64 rows][D] bf16, the ring of K and V tiles [kStages][K,
// V][64 keys][D] bf16, their k/v scales [kStages][K, V][64] f32, and for
// int8 pools the staging ring of raw rows [kRaw][K, V][64][D] int8 and
// their scales [kRaw][K, V][64] f32.
template <int D, bool kQuant>
struct Smem {
  static constexpr int kStages = Depth<kQuant>::stages, kRaw = Depth<kQuant>::raw;
  static constexpr int kTile = kKeys * D * 2;
  static constexpr int q = 1024;
  static constexpr int kv = q + kRows * D * 2;
  static constexpr int scale = kv + kStages * 2 * kTile;
  static constexpr int raw = scale + kStages * 2 * kKeys * 4;
  static constexpr int raw_scale = raw + (kQuant ? kRaw * 2 * kKeys * D : 0);
  static constexpr int bytes = raw_scale + (kQuant ? kRaw * 2 * kKeys * 4 : 0) + 1024;
};

// SW128 shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Keep registers that an in-flight wgmma reads (its A operand) live and
// untouched until the wait that follows.
template <int N>
__device__ __forceinline__ void keep_regs(const uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" ::"r"(r[i]) : "memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                  uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// O[64 x D] += P[64 x 16] . V[16 x D], P's fragment (a0..a3) passed as the
// very registers that hold it: a copy made after the first wgmma of a
// stage would serialize the stage's wgmmas.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  if constexpr (D == 64) {
    wgmma_m64n64k16_rs(o, a0, a1, a2, a3, db);
  } else {
    wgmma_m64n128k16_rs(o, a0, a1, a2, a3, db);
  }
}

// TP: the pool (bf16, or int8 with kv_scale); TC: the chunk's dense K/V
// (bf16 for bf16 pools, float for int8 pools); kGather: int8 pools whose
// pages are not a multiple of 8 tokens (an instance of its own: the row
// gather in the TMA instance cost its producer spills). Grid (splits,
// query blocks, B * Hkv).
template <typename TP, typename TC, int D, int G, bool kGather>
__global__ void __launch_bounds__(kThreads, 1) paged_chunk_tc_kernel(
    const __grid_constant__ CUtensorMap pool_map,  // the pool as [2*L*Hkv*num_slots, D] rows
    const TP* __restrict__ kv,            // the same rows (pages gathered row by row)
    const __nv_bfloat16* __restrict__ q,  // [B, C, Hq, D]
    const TC* __restrict__ k_cur,         // [B, C, Hkv, D]
    const TC* __restrict__ v_cur,         // [B, C, Hkv, D]
    const float* __restrict__ kv_scale,   // [2, L, Hkv, num_slots] (int8 pools)
    const int* __restrict__ page_table,   // [B, max_pages]
    const int* __restrict__ prior_lengths,  // [B]
    const int* __restrict__ kv_lengths,   // [B]
    __nv_bfloat16* __restrict__ out,      // [B, C, Hq, D]
    float* __restrict__ ws,               // split partials (splits > 1)
    int* __restrict__ counters,           // [B * Hkv * query blocks], all 0 between launches
    int C, int Hq, int Hkv, int L, int num_slots, int page, int max_pages, int layer, int cblk,
    int tiles_per_split) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  constexpr bool kDenseF32 = std::is_same<TC, float>::value;
  using SM = Smem<D, kQuant>;
  constexpr int kStages = SM::kStages, kRaw = SM::kRaw;
  constexpr int U = D / 8;   // 16-byte bf16 units per row
  constexpr int CB = D / 64;  // 128-byte column blocks per bf16 row
  // bf16 pools stage the chunk's dense K/V with cp.async, tracked by a
  // barrier of their own (every producer thread's copies).
  constexpr bool kAsyncDense = !kDenseF32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* full_dense = empty + kMaxStages;
  uint64_t* land = full_dense + kMaxStages;
  int* flag = reinterpret_cast<int*>(land + kMaxRaw);

  const int s = blockIdx.x, splits = gridDim.x, qb = blockIdx.y, n_qblk = gridDim.y;
  const int bh = blockIdx.z, b = bh / Hkv, h = bh % Hkv;
  const int tid = threadIdx.x;
  const int c0 = qb * cblk;
  const int nq = min(cblk, C - c0);
  const int R = nq * G;
  uint8_t* q_s = smem + SM::q;
  // What needs no lengths goes out first, beside them: Q rows r = (c - c0)
  // * G + g (bf16, unscaled, zero past R), the tensor map and the split's
  // first page-table line.
  if (tid >= kProducers) {
    const int ct = tid - kProducers;
#pragma unroll
    for (int i = 0; i < kRows * U / kConsumers; ++i) {
      const int idx = ct + i * kConsumers, r = idx / U, u = idx % U;
      const bool ok = r < R;
      const __nv_bfloat16* src =
          ok ? q + (((size_t)b * C + c0 + r / G) * Hq + (size_t)h * G + r % G) * D + u * 8 : q;
      cp_async16(smem_addr(q_s) + (r >> 6) * (64 * D * 2) + tile_at<64>(r & 63, u * 16), src, ok);
    }
    cp_async_commit();
  } else if (tid == 0) {
    prefetch_tensor_map(&pool_map);
    const int first = s * tiles_per_split * kKeys / page;
    if (first < max_pages) prefetch_l1(page_table + (size_t)b * max_pages + first);
  }
  const int prior = min(max(prior_lengths[b], 0), max_pages * page);
  const int n_dense = min(max(kv_lengths[b] - prior, 0), C);
  const int k_end = min(c0 + nq, n_dense);  // dense keys any query of the block sees
  const int n_prior_tiles = (prior + kKeys - 1) / kKeys;
  const int total = n_prior_tiles + (k_end + kKeys - 1) / kKeys;
  // Splits of this (row, kv head, query block) that hold tiles; the rest
  // leave at once (every CTA of the group derives the same count).
  const int parts = max(1, (total + tiles_per_split - 1) / tiles_per_split);
  if (s >= parts) {
    cp_async_wait<0>();  // no copy may land after the CTA is gone
    return;
  }
  const int t_lo = s * tiles_per_split;
  const int n_tiles = max(0, min(total, t_lo + tiles_per_split) - t_lo);
  const int n_prior_here = max(0, min(n_tiles, n_prior_tiles - t_lo));  // prior tiles come first
  // Pages of a multiple of 8 tokens come by TMA; others row by row (bf16
  // pools: by cp.async on full_dense, as the dense rows come; int8 pools:
  // into the staging ring, in the kGather instance).
  const bool tma = kQuant ? !kGather : (page & 7) == 0;
  const int n_full = kAsyncDense && !tma ? 0 : n_prior_here;  // tiles on `full`, first
  // Tile j's phase on its full barrier: the tiles on `full` (every tile
  // when the dense ones come by the same barrier) count by round of the
  // ring; the others count on full_dense from the first one in their stage.
  auto full_phase = [&](int j) -> uint32_t {
    if (!kAsyncDense || j < n_full) return (j / kStages) & 1;
    const int first = n_full + ((j % kStages) - n_full % kStages + kStages) % kStages;
    return ((j - first) / kStages) & 1;
  };
  const int n_wg = R > 64 ? 2 : 1;  // consumer warpgroups with live rows

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);               // the issuer: a byte count, or the staged tile
      mbar_init(&empty[i], 4 * n_wg);       // every consumer warp
      mbar_init(&full_dense[i], kProducers);  // every producer thread's cp.async
    }
#pragma unroll
    for (int i = 0; i < kMaxRaw; ++i) mbar_init(&land[i], kQuant && !tma ? kProducers : 1);
    fence_mbar_init();
  }
  float* sc_s = reinterpret_cast<float*>(smem + SM::scale);  // [stage][K, V][kKeys]
  auto kv_tile = [&](int stage, int which) {
    return smem + SM::kv + (stage * 2 + which) * SM::kTile;
  };
  __syncthreads();  // barriers initialised; no CTA-wide barrier after this

  if (tid < kProducers) {
    // ---------------------------------------------------------------- producer
    setmaxnreg_dec<kProducerRegs>();
    const bool issuer = tid == 0;
    const int* pt = page_table + (size_t)b * max_pages;
    const int page_shift = page_shift_of(page);
    const int box_rows = min(page & -page, kKeys);  // divides the page and the tile
    // Row `tok` of the prior of map row `head` (K or V of this kv head).
    auto pool_row = [&](int head, int tok) {
      return kv + ((size_t)head + slot_of(pt, tok, page, page_shift)) * D;
    };
    const int row_k = (layer * Hkv + h) * num_slots;  // map rows of this head's K and V
    const int row_v = ((L + layer) * Hkv + h) * num_slots;
    const float* k_sc = kQuant ? kv_scale + row_k : nullptr;
    const float* v_sc = kQuant ? kv_scale + row_v : nullptr;
    auto raw_tile = [&](int buf, int which) {
      return smem + SM::raw + (buf * 2 + which) * kKeys * D;
    };
    auto raw_sc = [&](int buf, int which) {
      return reinterpret_cast<float*>(smem + SM::raw_scale) + (buf * 2 + which) * kKeys;
    };
    // Prior tile i by TMA: the boxes of its pages up to the bound (and for
    // int8 pools their scales), completing on `bar`, into bf16 tiles of the
    // ring or int8 staging rows.
    auto issue_prior = [&](int i, uint8_t* dk, uint8_t* dv, float* dsk, float* dsv, uint64_t* bar) {
      const int base = i * kKeys, n = min(kKeys, prior - base);
      const int boxes = (n + box_rows - 1) / box_rows;
      const uint32_t box_bytes = box_rows * D * (kQuant ? 1 : 2) + (kQuant ? box_rows * 4 : 0);
      mbar_arrive_tx(bar, 2 * boxes * box_bytes);
      for (int k = 0; k < boxes; ++k) {
        const int slot = slot_of(pt, base + k * box_rows, page, page_shift);
        if constexpr (kQuant) {
          tma_load_2d(dk + k * box_rows * D, &pool_map, 0, row_k + slot, bar);
          tma_load_2d(dv + k * box_rows * D, &pool_map, 0, row_v + slot, bar);
          bulk_load(dsk + k * box_rows, k_sc + slot, box_rows * 4, bar);
          bulk_load(dsv + k * box_rows, v_sc + slot, box_rows * 4, bar);
        } else {
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) {
            tma_load_2d(dk + cb * kAtom + k * box_rows * 128, &pool_map, cb * 64, row_k + slot, bar);
            tma_load_2d(dv + cb * kAtom + k * box_rows * 128, &pool_map, cb * 64, row_v + slot, bar);
          }
        }
      }
    };
    // Raw int8 tile j into staging buffer j % kRaw, completing on its land
    // barrier: by the issuer's TMA, or row by row by cp.async from every
    // producer thread (pages that are not a multiple of 8 tokens).
    auto issue_raw = [&](int j) {
      const int buf = j % kRaw, i = t_lo + j;
      if (tma) {
        if (issuer) issue_prior(i, raw_tile(buf, 0), raw_tile(buf, 1), raw_sc(buf, 0), raw_sc(buf, 1), &land[buf]);
        return;
      }
      const int n = min(kKeys, prior - i * kKeys);
      constexpr int RU = D / 16;  // 16-byte units of an int8 row
#pragma unroll 1
      for (int p = 0; p < kKeys * RU / kProducers; ++p) {
        const int idx = tid + p * kProducers, row = idx / RU, u = idx % RU;
        if (row < n) {
          const size_t off = (size_t)slot_of(pt, i * kKeys + row, page, page_shift) * D + u * 16;
          cp_async16(smem_addr(raw_tile(buf, 0) + row * D + u * 16), kv + (size_t)row_k * D + off, true);
          cp_async16(smem_addr(raw_tile(buf, 1) + row * D + u * 16), kv + (size_t)row_v * D + off, true);
        }
      }
      const int which = tid / kKeys, row = tid % kKeys;  // 128 threads: 2 x 64 scales
      if (row < n)
        cp_async4(smem_addr(raw_sc(buf, which) + row),
                  kv_scale + (which ? row_v : row_k) + slot_of(pt, i * kKeys + row, page, page_shift), true);
      mbar_arrive_cp_async(&land[buf]);
    };
    // A tile the producer threads wrote themselves: every thread's writes,
    // then the issuer's one arrival.
    auto publish = [&](int stage) {
      fence_async_smem();
      bar_sync(kBarProducer, kProducers);  // also frees the staging buffer
      if (issuer) mbar_arrive(&full[stage]);
    };
    if constexpr (kQuant) {
      for (int j = 0; j < min(kRaw - 1, n_prior_here); ++j) issue_raw(j);
    }
    uint32_t land_uses = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int i = t_lo + j, stage = j % kStages;
      if constexpr (kQuant) {
        if (j + kRaw - 1 < n_prior_here) issue_raw(j + kRaw - 1);
      }
      // Only the issuer's warp follows the empty barriers, phase by phase (a
      // parity wait cannot tell a phase two behind from a completed one);
      // the whole warp waits, so it reaches every bar.sync (.aligned)
      // together.
      if (tid < 32) mbar_wait(&empty[stage], ((j / kStages) & 1) ^ 1);
      if (!kQuant && tma && i < n_prior_tiles && prior - i * kKeys >= kKeys) {
        // Whole pages: TMA straight into the ring.
        if (issuer) issue_prior(i, kv_tile(stage, 0), kv_tile(stage, 1), nullptr, nullptr, &full[stage]);
        continue;
      }
      bar_sync(kBarProducer, kProducers);  // the stage is free: the issuer saw it
      if (i < n_prior_tiles) {
        const int n = min(kKeys, prior - i * kKeys);
        if constexpr (!kQuant) {
          if (!tma) {
            // Row by row: every producer thread's copies, zero past the bound.
#pragma unroll
            for (int which = 0; which < 2; ++which) {
              uint8_t* dst = kv_tile(stage, which);
#pragma unroll 4
              for (int p = 0; p < kKeys * U / kProducers; ++p) {
                const int idx = tid + p * kProducers, row = idx / U, u = idx % U;
                const bool ok = row < n;
                const TP* src = ok ? pool_row(which ? row_v : row_k, i * kKeys + row) + u * 8 : kv;
                cp_async16(smem_addr(dst) + tile_at<64>(row, u * 16), src, ok);
              }
            }
            mbar_arrive_cp_async(&full_dense[stage]);
            continue;
          }
          // The tile that ends inside a page: its pages land, then the V
          // rows at or past the bound are zeroed.
          if (issuer) issue_prior(i, kv_tile(stage, 0), kv_tile(stage, 1), nullptr, nullptr, &land[0]);
          mbar_wait(&land[0], land_uses & 1);
          ++land_uses;
          uint8_t* vt = kv_tile(stage, 1);
          for (int idx = tid; idx < (kKeys - n) * U; idx += kProducers)
            *reinterpret_cast<uint4*>(vt + tile_at<64>(n + idx / U, (idx % U) * 16)) = make_uint4(0u, 0u, 0u, 0u);
        } else {
          // int8 rows: widened to bf16 in the swizzled layout, rows past the
          // bound zero (payload and scale).
          const int buf = j % kRaw;
          mbar_wait(&land[buf], (j / kRaw) & 1);
#pragma unroll
          for (int which = 0; which < 2; ++which) {
            const uint8_t* src = raw_tile(buf, which);
            uint8_t* dst = kv_tile(stage, which);
#pragma unroll
            for (int p = 0; p < kKeys * D / 16 / kProducers; ++p) {
              const int idx = tid + p * kProducers, row = idx / (D / 16), ru = idx % (D / 16);
              uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
              if (row < n) {
                const uint4 raw = *reinterpret_cast<const uint4*>(src + row * D + ru * 16);
                const uint2 a = int8x4_to_bf16x4(raw.x), b2 = int8x4_to_bf16x4(raw.y);
                const uint2 c = int8x4_to_bf16x4(raw.z), d = int8x4_to_bf16x4(raw.w);
                lo = make_uint4(a.x, a.y, b2.x, b2.y);
                hi = make_uint4(c.x, c.y, d.x, d.y);
              }
              *reinterpret_cast<uint4*>(dst + tile_at<64>(row, 32 * ru)) = lo;
              *reinterpret_cast<uint4*>(dst + tile_at<64>(row, 32 * ru + 16)) = hi;
            }
          }
          {
            const int which = tid / kKeys, row = tid % kKeys;  // 128 threads: 2 x 64 scales
            sc_s[(stage * 2 + which) * kKeys + row] = row < n ? raw_sc(buf, which)[row] : 0.f;
          }
        }
        publish(stage);
      } else {
        // The chunk's dense K/V rows, zero past the bound.
        const int k0 = (i - n_prior_tiles) * kKeys, n = min(kKeys, k_end - k0);
        const size_t cur_stride = (size_t)Hkv * D;  // between chunk positions
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          const TC* base = (which ? v_cur : k_cur) + ((size_t)b * C * Hkv + h) * D;
          uint8_t* dst = kv_tile(stage, which);
#pragma unroll 4
          for (int p = 0; p < kKeys * U / kProducers; ++p) {
            const int idx = tid + p * kProducers, row = idx / U, u = idx % U;
            const bool ok = row < n;
            const TC* src = ok ? base + (size_t)(k0 + row) * cur_stride + u * 8 : base;
            if constexpr (kDenseF32) {
              uint4 v = make_uint4(0u, 0u, 0u, 0u);
              if (ok) {
                const float4 x = *reinterpret_cast<const float4*>(src);
                const float4 y = *reinterpret_cast<const float4*>(src + 4);
                v = make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w), pack_bf16(y.x, y.y),
                               pack_bf16(y.z, y.w));
              }
              *reinterpret_cast<uint4*>(dst + tile_at<64>(row, u * 16)) = v;
            } else {
              cp_async16(smem_addr(dst) + tile_at<64>(row, u * 16), src, ok);
            }
          }
        }
        if constexpr (kAsyncDense) {
          mbar_arrive_cp_async(&full_dense[stage]);  // once this thread's copies have landed
        } else {
          publish(stage);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  setmaxnreg_inc<kConsumerRegs>();
  // Q lands while the producer's first tiles do: every consumer thread's
  // rows, then the consumers' barrier, before wgmma reads any of them.
  cp_async_wait<0>();
  fence_async_smem();
  bar_sync(kBarConsumers, kConsumers);
  const int ct = tid - kProducers, wg = ct >> 7, lane = tid & 31;
  if (wg >= n_wg) return;  // no live rows
  // This thread's two accumulator rows (CTA rows; fragment rows l/4 and
  // l/4 + 8 of its warp's 16) and the first of its two columns in each
  // 8-column slice.
  const int rA = wg * 64 + ((ct & 127) >> 5) * 16 + (lane >> 2), rB = rA + 8;
  const int colq = 2 * (lane & 3);
  const float scl = kLog2e / sqrtf((float)D);  // softmax in base 2
  const uint32_t q_base = smem_addr(q_s) + wg * (64 * D * 2);
  // Both warpgroups live: they take turns issuing their products (named
  // barriers 1 and 2). Warpgroup 1 opens warpgroup 0's first turn.
  const bool pingpong = n_wg == 2;
  if (pingpong && wg == 1) bar_arrive(1, kConsumers);
  auto turn = [&]() {
    if (pingpong) bar_sync(1 + wg, kConsumers);
  };
  auto pass = [&]() {
    if (pingpong) bar_arrive(2 - wg, kConsumers);
  };
  float mA = kMask, mB = kMask, lA = 0.f, lB = 0.f;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // S of the tile in flight, and P double-buffered: P.V(j-1) reads one
  // buffer while the softmax of tile j writes the other (no copies: every
  // wgmma input is written before the stage that reads it starts).
  float sfr[32];
  uint32_t pb[2][16];

  // Tile j: in the ring once its full barrier completes (the producer's
  // own writes also need the proxy fence before wgmma reads them).
  auto acquire = [&](int j) {
    mbar_wait(kAsyncDense && j >= n_full ? &full_dense[j % kStages] : &full[j % kStages], full_phase(j));
    if (kQuant || !tma || t_lo + j >= n_prior_tiles - 1) fence_async_smem();
  };
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % kStages]);
  };
  const uint64_t q_desc = sw128_desc(q_base, 16, 1024);
  auto issue_s = [&](int j) {
    const uint64_t k_desc = sw128_desc(smem_addr(kv_tile(j % kStages, 0)), 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = ((kk >> 2) * kAtom + (kk & 3) * 32) >> 4;  // 16-byte units
      wgmma_m64n64k16_ss(sfr, q_desc + koff, k_desc + koff, kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int j, const uint32_t (&p)[16]) {
    const uint64_t v_desc = sw128_desc(smem_addr(kv_tile(j % kStages, 1)), kAtom, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_pv<D>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], v_desc + kk * (2048 >> 4));
    wgmma_commit();
  };
  // The online softmax of tile j's scores (sfr, read only) into P (`p`);
  // sets the factors that rescale O and updates m and l.
  float corrA = 1.f, corrB = 1.f;
  auto softmax = [&](int j, uint32_t (&p)[16]) {
    const int i = t_lo + j;
    int base, n;
    bool causal;
    if (i < n_prior_tiles) {
      base = i * kKeys;
      n = min(kKeys, prior - base);
      causal = false;
    } else {
      base = (i - n_prior_tiles) * kKeys;
      n = min(kKeys, k_end - base);
      causal = true;
    }
    // Keys 0..last of the tile are visible to a row; -1 for none.
    const int lastA = rA < R ? (causal ? min(n - 1, c0 + rA / G - base) : n - 1) : -1;
    const int lastB = rB < R ? (causal ? min(n - 1, c0 + rB / G - base) : n - 1) : -1;
    const bool scaled = kQuant && !causal;
    const float* ks = sc_s + (j % kStages) * 2 * kKeys;
    const float* vs = ks + kKeys;
    // A tile that every row sees whole, with no int8 scale (most prior
    // tiles), skips the masks at any R (rows past R are never written) and
    // folds the scale into one FFMA per score. Each path is straight-line
    // code: a masked key's exponent is -inf (ex2 gives an exact 0), so no
    // exponential sits behind a branch.
    const bool open_tile = !scaled && !causal && n == kKeys;
    float sumA = 0.f, sumB = 0.f;
    auto rescale = [&](float mxA, float mxB) {
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));
      corrA = fast_exp2(mA - mxA);
      corrB = fast_exp2(mB - mxB);
      mA = mxA;
      mB = mxB;
    };
    // P as the A operand of P.V: k-step kk takes slices 2kk (a0, a1) and
    // 2kk+1 (a2, a3), row A then row B.
    auto put = [&](int t, float a0, float a1, float b0, float b1) {
      p[4 * (t >> 1) + 2 * (t & 1)] = pack_bf16(a0, a1);
      p[4 * (t >> 1) + 2 * (t & 1) + 1] = pack_bf16(b0, b1);
    };
    if (open_tile) {
      float ra = kMask, rb = kMask;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        ra = fmaxf(ra, fmaxf(sfr[4 * t], sfr[4 * t + 1]));
        rb = fmaxf(rb, fmaxf(sfr[4 * t + 2], sfr[4 * t + 3]));
      }
      rescale(fmaxf(mA, ra * scl), fmaxf(mB, rb * scl));  // scl > 0
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float a0 = fast_exp2(fmaf(sfr[4 * t], scl, -mA));
        const float a1 = fast_exp2(fmaf(sfr[4 * t + 1], scl, -mA));
        const float b0 = fast_exp2(fmaf(sfr[4 * t + 2], scl, -mB));
        const float b1 = fast_exp2(fmaf(sfr[4 * t + 3], scl, -mB));
        sumA += a0 + a1;
        sumB += b0 + b1;
        put(t, a0, a1, b0, b1);
      }
    } else {
      float mxA = mA, mxB = mB;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * t + colq + e;
          const float f = scaled ? scl * ks[col] : scl;
          mxA = fmaxf(mxA, col <= lastA ? sfr[4 * t + e] * f : kMask);
          mxB = fmaxf(mxB, col <= lastB ? sfr[4 * t + 2 + e] * f : kMask);
        }
      }
      rescale(mxA, mxB);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float a[2], bb[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * t + colq + e;
          const float f = scaled ? scl * ks[col] : scl;
          const float ea = fast_exp2(col <= lastA ? sfr[4 * t + e] * f - mA : -INFINITY);
          const float eb = fast_exp2(col <= lastB ? sfr[4 * t + 2 + e] * f - mB : -INFINITY);
          sumA += ea;
          sumB += eb;
          // int8: P times v_scale (rows past the bound hold scale 0).
          a[e] = scaled ? ea * vs[col] : ea;
          bb[e] = scaled ? eb * vs[col] : eb;
        }
        put(t, a[0], a[1], bb[0], bb[1]);
      }
    }
    lA = lA * corrA + sumA;
    lB = lB * corrB + sumB;
  };
  // Tile j: S(j) and P.V(j-1) in flight together; the softmax of tile j
  // runs while P.V(j-1) does; then O is rescaled.
  auto step = [&](int j, const uint32_t (&p_in)[16], uint32_t (&p_out)[16]) {
    acquire(j);
    turn();
    issue_s(j);
    issue_pv(j - 1, p_in);
    pass();
    wgmma_wait<1>();  // S(j) has landed
    fence_regs(sfr);
    softmax(j, p_out);
    wgmma_wait<0>();
    fence_regs(o);
    keep_regs(p_in);
    release(j - 1);
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      o[4 * t] *= corrA;
      o[4 * t + 1] *= corrA;
      o[4 * t + 2] *= corrB;
      o[4 * t + 3] *= corrB;
    }
  };
  auto last_pv = [&](const uint32_t (&p_in)[16]) {
    turn();
    issue_pv(n_tiles - 1, p_in);
    pass();
    wgmma_wait<0>();
    fence_regs(o);
    keep_regs(p_in);
    release(n_tiles - 1);
  };

  if (n_tiles > 0) {
    acquire(0);
    turn();
    issue_s(0);
    pass();
    wgmma_wait<0>();
    fence_regs(sfr);
    softmax(0, pb[0]);  // O is still 0: nothing to rescale
    int j = 1;
    for (; j + 1 < n_tiles; j += 2) {
      step(j, pb[0], pb[1]);
      step(j + 1, pb[1], pb[0]);
    }
    if (j < n_tiles) {
      step(j, pb[0], pb[1]);
      last_pv(pb[1]);
    } else {
      last_pv(pb[0]);
    }
  }
  if (pingpong && wg == 0) bar_sync(1, kConsumers);  // warpgroup 1's last turn signal

  lA += __shfl_xor_sync(0xffffffffu, lA, 1);
  lA += __shfl_xor_sync(0xffffffffu, lA, 2);
  lB += __shfl_xor_sync(0xffffffffu, lB, 1);
  lB += __shfl_xor_sync(0xffffffffu, lB, 2);
  if (parts > 1) {
    // Partials of this split, rows < R: m, l [rows] then O [rows][D], f32.
    const int rows = cblk * G;
    const size_t part_elems = (size_t)rows * (D + 2);
    float* part0 = ws + (size_t)(bh * n_qblk + qb) * splits * part_elems;
    float* mine = part0 + (size_t)s * part_elems;
    if ((lane & 3) == 0) {
      if (rA < R) {
        mine[rA] = mA;
        mine[rows + rA] = lA;
      }
      if (rB < R) {
        mine[rB] = mB;
        mine[rows + rB] = lB;
      }
    }
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      if (rA < R)
        *reinterpret_cast<float2*>(mine + 2 * rows + (size_t)rA * D + 8 * t + colq) =
            make_float2(o[4 * t], o[4 * t + 1]);
      if (rB < R)
        *reinterpret_cast<float2*>(mine + 2 * rows + (size_t)rB * D + 8 * t + colq) =
            make_float2(o[4 * t + 2], o[4 * t + 3]);
    }
    if (!last_of_split(counters + (size_t)bh * n_qblk + qb, parts, flag, kBarConsumers,
                       128 * n_wg, ct == 0))
      return;
    // The last split merges every split's partials, in split order. A
    // split where a row saw no key holds m = kMask, l = 0, O = 0, so every
    // load is unconditional and none waits on another.
    const int ra = min(rA, R - 1), rb = min(rB, R - 1);  // rows past R: any live row's
    mA = mB = kMask;
#pragma unroll 4
    for (int sp = 0; sp < parts; ++sp) {
      const float* pp = part0 + (size_t)sp * part_elems;
      mA = fmaxf(mA, __ldcg(pp + ra));
      mB = fmaxf(mB, __ldcg(pp + rb));
    }
    lA = lB = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll 2
    for (int sp = 0; sp < parts; ++sp) {
      const float* pp = part0 + (size_t)sp * part_elems;
      const float wa = exp2f(__ldcg(pp + ra) - mA), wb = exp2f(__ldcg(pp + rb) - mB);
      lA += wa * __ldcg(pp + rows + ra);
      lB += wb * __ldcg(pp + rows + rb);
      const float* oa = pp + 2 * rows + (size_t)ra * D + colq;
      const float* ob = pp + 2 * rows + (size_t)rb * D + colq;
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        const float2 xa = __ldcg(reinterpret_cast<const float2*>(oa + 8 * t));
        const float2 xb = __ldcg(reinterpret_cast<const float2*>(ob + 8 * t));
        o[4 * t] += wa * xa.x;
        o[4 * t + 1] += wa * xa.y;
        o[4 * t + 2] += wb * xb.x;
        o[4 * t + 3] += wb * xb.y;
      }
    }
  }

  const float invA = lA > 0.f ? 1.f / lA : 0.f, invB = lB > 0.f ? 1.f / lB : 0.f;
  __nv_bfloat16* outA =
      out + (((size_t)b * C + c0 + rA / G) * Hq + (size_t)h * G + rA % G) * D + colq;
  __nv_bfloat16* outB =
      out + (((size_t)b * C + c0 + rB / G) * Hq + (size_t)h * G + rB % G) * D + colq;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    if (rA < R)
      *reinterpret_cast<uint32_t*>(outA + 8 * t) = pack_bf16(o[4 * t] * invA, o[4 * t + 1] * invA);
    if (rB < R)
      *reinterpret_cast<uint32_t*>(outB + 8 * t) = pack_bf16(o[4 * t + 2] * invB, o[4 * t + 3] * invB);
  }
}

// Arguments of one launch; kv_scale only for int8 pools, ws and counters
// only when splits > 1.
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
  float* ws;
  int* counters;
  int B, C, Hq, Hkv, D, L, num_slots, page, max_pages, layer, cblk, splits, tiles_per_split;
};

template <typename TP, typename TC, int D, int G, bool kGather>
cudaError_t launch(const ChunkArgs& a, const CUtensorMap& map, cudaStream_t stream) {
  constexpr int bytes = Smem<D, std::is_same<TP, int8_t>::value>::bytes;
  static SmemOptIn opt_in;
  cudaError_t err = opt_in.ensure(paged_chunk_tc_kernel<TP, TC, D, G, kGather>, bytes);
  if (err != cudaSuccess) return err;
  const int n_qblk = (a.C + a.cblk - 1) / a.cblk;
  paged_chunk_tc_kernel<TP, TC, D, G, kGather>
      <<<dim3(a.splits, n_qblk, a.B * a.Hkv), kThreads, bytes, stream>>>(
          map, static_cast<const TP*>(a.kv), static_cast<const __nv_bfloat16*>(a.q), static_cast<const TC*>(a.k_cur),
          static_cast<const TC*>(a.v_cur), a.kv_scale, a.pt, a.prior, a.kvlen,
          static_cast<__nv_bfloat16*>(a.out), a.ws, a.counters, a.C, a.Hq, a.Hkv, a.L,
          a.num_slots, a.page, a.max_pages, a.layer, a.cblk, a.tiles_per_split);
  return cudaGetLastError();
}

template <typename TP, typename TC, int D, bool kGather>
cudaError_t launch_g(const ChunkArgs& a, const CUtensorMap& map, cudaStream_t stream) {
  switch (a.Hq / a.Hkv) {
    case 1: return launch<TP, TC, D, 1, kGather>(a, map, stream);
    case 2: return launch<TP, TC, D, 2, kGather>(a, map, stream);
    case 3: return launch<TP, TC, D, 3, kGather>(a, map, stream);
    case 4: return launch<TP, TC, D, 4, kGather>(a, map, stream);
    case 5: return launch<TP, TC, D, 5, kGather>(a, map, stream);
    case 6: return launch<TP, TC, D, 6, kGather>(a, map, stream);
    case 7: return launch<TP, TC, D, 7, kGather>(a, map, stream);
    case 8: return launch<TP, TC, D, 8, kGather>(a, map, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TP, typename TC>
cudaError_t launch_d(const ChunkArgs& a, cudaStream_t stream) {
  if (a.D != 64 && a.D != 128) return cudaErrorInvalidValue;
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  // The pool [2, L, Hkv, num_slots, D] as rows of D: boxes of the kernel's
  // box_rows (8, unused, for pages gathered row by row) by 64 bf16
  // columns, 128-byte swizzled; int8 rows whole and unswizzled (the
  // producer widens them).
  CUtensorMap map;
  const cudaError_t err = tensor_map_2d(
      &map, a.kv, (uint64_t)2 * a.L * a.Hkv * a.num_slots, a.D,
      kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, kQuant ? 1 : 2,
      kQuant ? a.D : 64, box_rows_of(a.page, kKeys),
      kQuant ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  if constexpr (kQuant) {
    if (a.page & 7) {
      if (a.D == 64) return launch_g<TP, TC, 64, true>(a, map, stream);
      return launch_g<TP, TC, 128, true>(a, map, stream);
    }
  }
  if (a.D == 64) return launch_g<TP, TC, 64, false>(a, map, stream);
  return launch_g<TP, TC, 128, false>(a, map, stream);
}

}  // namespace
}  // namespace radixmesh

// q_dtype: must be 1 (bfloat16; float32 queries take paged_chunk_launch);
// pool_dtype: 1 = bfloat16 (k_cur/v_cur bf16), or 2 = int8 with kv_scale
// [2, L, Hkv, num_slots] f32 (else nullptr) and k_cur/v_cur in float32.
// cblk = queries per CTA (cblk * (Hq / Hkv) <= 128; the last block may be
// ragged); each (row, kv head, query block)'s tiles — prior, then dense —
// split over `splits` CTAs of `tiles_per_split` 64-key tiles, covering
// ceil(max_pages * page / 64) + ceil(C / 64) tiles. With splits > 1, ws
// holds B * Hkv * ceil(C / cblk) * splits * cblk * G * (D + 2) floats and
// counters B * Hkv * ceil(C / cblk) ints, all 0 (each launch leaves them
// 0). page: any size >= 1. Returns the cudaError_t of the launch (0
// on success). Launches on `stream`; allocates nothing.
extern "C" int paged_chunk_tc_launch(int q_dtype, int pool_dtype, const void* q,
                                     const void* k_cur, const void* v_cur, const void* kv,
                                     const void* kv_scale, const void* page_table,
                                     const void* prior_lengths, const void* kv_lengths,
                                     void* out, void* ws, void* counters, int B, int C, int Hq,
                                     int Hkv, int D, int L, int num_slots, int page,
                                     int max_pages, int layer, int cblk, int splits,
                                     int tiles_per_split, void* stream) {
  using namespace radixmesh;
  if (B == 0 || C == 0) return 0;
  if (q_dtype != 1 || Hkv <= 0 || Hq % Hkv != 0 || cblk <= 0 || cblk * (Hq / Hkv) > kRows)
    return (int)cudaErrorInvalidValue;
  if ((pool_dtype == 2) != (kv_scale != nullptr)) return (int)cudaErrorInvalidValue;
  if (page <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)max_pages * page + kKeys - 1) / kKeys + (C + kKeys - 1) / kKeys;
  if (splits <= 0 || tiles_per_split <= 0 || (long long)splits * tiles_per_split < tiles ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) || (long long)B * Hkv > 65535 ||
      (C + cblk - 1) / cblk > 65535 || (long long)2 * L * Hkv * num_slots >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const ChunkArgs a{q, k_cur, v_cur, kv, static_cast<const float*>(kv_scale),
                    static_cast<const int*>(page_table), static_cast<const int*>(prior_lengths),
                    static_cast<const int*>(kv_lengths), out, static_cast<float*>(ws),
                    static_cast<int*>(counters), B, C, Hq, Hkv, D, L, num_slots, page,
                    max_pages, layer, cblk, splits, tiles_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 1) return (int)launch_d<__nv_bfloat16, __nv_bfloat16>(a, s);
  if (pool_dtype == 2) return (int)launch_d<int8_t, float>(a, s);
  return (int)cudaErrorInvalidValue;
}
