// Paged chunk-prefill attention on Hopper's tensor cores (sm_90a, wgmma):
// the body for bfloat16 queries (bf16 pools, and int8 pools with bf16
// queries), which is what serving runs. Float32 queries take the CUDA-core
// body in paged_chunk.cu, kept for the float32 whole-path check at atol
// 1e-3/1e-4, which bf16 operands (or TF32) would not meet.
//
// Replaces: radixmesh_tpu/ops/paged_attention.py,
// paged_chunk_attention_kernel (Pallas body _chunk_kernel).
//
// What it computes, per row b, kv head h and block of Cblk queries: the
// queries sit at canonical positions prior + arange(C). They attend to the
// row's prior_lengths[b] pool tokens, found through the page table in any
// page order, then to the chunk's own dense K/V, causal within the chunk
// (key c_k <= query c_q) and bounded by kv_lengths[b] (prior + c_k <
// kv_lengths). Online softmax in fp32, output [B, C, Hq, D] in bf16,
// zeros where the softmax denominator is 0.
//
// What bounds it on an H100: operations. It does 4*Hq*D*sum_b C*(prior +
// C/2) flops against 2*Hkv*D*sum_b prior elements of pool K/V read — at
// C = 512 some 256 flops per K/V element, above the ~295 flops per byte
// line of the bf16 tensor cores only at long priors, so the kernel has to
// run its products on the tensor cores and keep the pool streaming.
//
// What the design does about it:
// - One CTA per (row, kv head, block of Cblk queries) with two consumer
//   warpgroups of 64 query rows each: 128 rows = Cblk*G (rows r =
//   (c - c0)*G + g; fewer live rows pad). Both warpgroups share every K/V
//   tile, so the pool streams once per 128 query rows of a kv head.
// - S = Q.K^T with wgmma m64n64k16 (bf16 in, fp32 accumulators). Q stays
//   in shared memory, unscaled, for the CTA's life; the 1/sqrt(D) scale
//   (and for int8 pools the per-token k_scale) multiplies the fp32 scores.
//   Rounding a pre-scaled Q to bf16 would add an error the JAX kernel does
//   not have.
// - O += P.V with wgmma m64nDk16, P from registers (the A operand) as bf16
//   from the S accumulator's fragment; for int8 pools P is multiplied by
//   v_scale first (the JAX kernel's order), while the denominator takes P
//   unscaled. V is staged as [keys, D] rows, which is MN-major for the B
//   operand: the descriptor's transpose bit reads it with no shuffle.
// - K/V tiles of 64 tokens come into a 3-stage ring of 128-byte-swizzled
//   shared-memory tiles with cp.async (16 bytes a thread), each token's
//   address looked up through the page table one tile before its copy is
//   issued; the copies of tiles i+1 and i+2 overlap the products of tile
//   i. int8 pages are staged as int8 and widened to bf16 in shared memory
//   (exact: |x| <= 127); their scales arrive by cp.async too. The int8
//   path's float32 chunk K/V are rounded to bf16 when they are staged (a
//   relative error up to 2^-9 per element, on top of the int8 rounding the
//   pool holds).
// - Masking: K and V rows at or past each bound are zero-filled in shared
//   memory (cp.async with source size 0), never loaded; masked scores take
//   the finite kMask and masked probabilities exactly 0, so NaN in an
//   unreferenced page or a padded chunk position never reaches P.V.
// - Softmax statistics live per row in registers: each row's 64 scores of
//   a tile sit on the four threads of a quad, reduced with two shuffles.
//   Tiles that every row sees whole, with no int8 scale (most prior
//   tiles), skip the masks and fold the scale into one FFMA per score.
//   The two warpgroups take turns issuing their S products (named
//   barriers), so one's softmax overlaps the other's wgmma.
// TMA loads and a producer warp are later work.

#include <type_traits>

#include "common.cuh"

namespace radixmesh {
namespace {

constexpr int kThreads = 256;  // two consumer warpgroups
constexpr int kRows = 128;     // query rows (Cblk * G) per CTA, at most
constexpr int kKeys = 64;      // keys per tile
constexpr int kStages = 3;     // K/V ring depth: tiles i+1 and i+2 in flight during tile i
constexpr int kAtom = 64 * 128;  // bytes of one 64-row x 128-byte swizzled column block
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte-aligned base: Q [2 warpgroups][64 rows]
// [D] bf16, the ring of K and V tiles [kStages][K, V][64 keys][D] bf16,
// int8 staging [kStages][K, V][64][D] (int8 pools), and the tiles' k/v
// scales [kStages][K, V][64] f32.
template <int D, bool kQuant>
struct Smem {
  static constexpr int kTileBytes = kKeys * D * 2;
  static constexpr int q = 0;
  static constexpr int kv = kRows * D * 2;
  static constexpr int raw = kv + kStages * 2 * kTileBytes;
  static constexpr int scale = raw + (kQuant ? kStages * 2 * kKeys * D : 0);
  static constexpr int bytes = scale + kStages * 2 * kKeys * 4 + 1024;  // + alignment slack
};

// Byte offset of 16-byte unit u of row `row` in a 64-row tile stored as
// D/64 column blocks of [64 rows][128 bytes], 128-byte swizzled: the
// layout wgmma's SW128 descriptors read (K-major for Q and K, MN-major
// for V).
__device__ __forceinline__ uint32_t sw128(int row, int u) {
  return (u >> 3) * kAtom + row * 128 + (((u & 7) ^ (row & 7)) << 4);
}

// SW128 shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// Generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to wgmma's operand reads (async proxy).
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the SFU (ex2.approx, flush to zero): the softmax's exponentials.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) {
    wgmma_m64n64k16_rs(o, a, db);
  } else {
    wgmma_m64n128k16_rs(o, a, db);
  }
}

// TP: the pool (bf16, or int8 with kv_scale); TC: the chunk's dense K/V
// (bf16 for bf16 pools, float for int8 pools).
template <typename TP, typename TC, int D, int G>
__global__ void __launch_bounds__(kThreads, 1) paged_chunk_tc_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, C, Hq, D]
    const TC* __restrict__ k_cur,         // [B, C, Hkv, D]
    const TC* __restrict__ v_cur,         // [B, C, Hkv, D]
    const TP* __restrict__ kv,            // [2, L, Hkv, num_slots, D]
    const float* __restrict__ kv_scale,   // [2, L, Hkv, num_slots] (int8 pools)
    const int* __restrict__ page_table,   // [B, max_pages]
    const int* __restrict__ prior_lengths,  // [B]
    const int* __restrict__ kv_lengths,   // [B]
    __nv_bfloat16* __restrict__ out,      // [B, C, Hq, D]
    int C, int Hq, int Hkv, int L, int num_slots, int page, int max_pages, int layer,
    int cblk) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  constexpr bool kDenseF32 = std::is_same<TC, float>::value;
  using SM = Smem<D, kQuant>;
  constexpr int U = D / 8;                      // 16-byte bf16 units per row
  constexpr int PU = D * (int)sizeof(TP) / 16;  // 16-byte pool units per row
  constexpr int PT = kKeys * PU / kThreads;     // pool units per thread, K or V
  constexpr int BT = kKeys * U / kThreads;      // bf16 units per thread, K or V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int b = blockIdx.x, h = blockIdx.y, cb = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int R = cblk * G;
  const int c0 = cb * cblk;
  const int prior = min(max(prior_lengths[b], 0), max_pages * page);
  const int n_dense = min(max(kv_lengths[b] - prior, 0), C);
  const int k_end = min(c0 + cblk, n_dense);  // dense keys any query of the block sees
  const int n_prior_tiles = (prior + kKeys - 1) / kKeys;
  const int n_tiles = n_prior_tiles + (k_end + kKeys - 1) / kKeys;

  const size_t head_stride = (size_t)num_slots * D;
  const TP* k_pool = kv + ((size_t)layer * Hkv + h) * head_stride;
  const TP* v_pool = kv + ((size_t)(L + layer) * Hkv + h) * head_stride;
  const float* k_sc = kQuant ? kv_scale + ((size_t)layer * Hkv + h) * num_slots : nullptr;
  const float* v_sc = kQuant ? kv_scale + ((size_t)(L + layer) * Hkv + h) * num_slots : nullptr;
  const int* pt = page_table + (size_t)b * max_pages;
  const int page_shift = page_shift_of(page);
  const size_t cur_stride = (size_t)Hkv * D;  // between chunk positions
  const TC* k_row0 = k_cur + ((size_t)b * C * Hkv + h) * D;
  const TC* v_row0 = v_cur + ((size_t)b * C * Hkv + h) * D;

  uint8_t* q_s = smem + SM::q;
  float* sc_s = reinterpret_cast<float*>(smem + SM::scale);  // [stage][K, V][kKeys]
  auto kv_tile = [&](int stage, int which) {
    return smem + SM::kv + (stage * 2 + which) * SM::kTileBytes;
  };
  auto raw_tile = [&](int stage, int which) {
    return smem + SM::raw + (stage * 2 + which) * kKeys * D;
  };

  // Q rows r = (c - c0) * G + g, bf16 and unscaled, zero-filled past R.
#pragma unroll
  for (int i = 0; i < kRows * U / kThreads; ++i) {
    const int idx = tid + i * kThreads, r = idx / U, u = idx % U;
    const bool ok = r < R;
    const __nv_bfloat16* src =
        ok ? q + (((size_t)b * C + c0 + r / G) * Hq + (size_t)h * G + r % G) * D + u * 8 : q;
    cp_async16(smem_addr(q_s) + (r >> 6) * (64 * D * 2) + sw128(r & 63, u), src, ok);
  }

  // Pool slots of this thread's units of the next prior tile to issue (-1:
  // past the bound, zero-filled), and the slot whose k or v scale this
  // thread copies (threads below 2 * kKeys, int8 pools).
  int slot_nx[PT];
  int sc_slot_nx = -1;
  auto lookup = [&](int i) {
    if (i >= n_prior_tiles) return;  // dense tiles need no lookup
    const int t0 = i * kKeys, n = min(kKeys, prior - t0);
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      const int row = (tid + p * kThreads) / PU, tok = t0 + row;
      slot_nx[p] = row < n ? slot_of(pt, tok, page, page_shift) : -1;
    }
    if (kQuant && tid < 2 * kKeys) {
      const int row = tid & (kKeys - 1), tok = t0 + row;
      sc_slot_nx = row < n ? slot_of(pt, tok, page, page_shift) : -1;
    }
  };
  auto issue = [&](int i, int stage) {
    if (i < n_prior_tiles) {
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const TP* pool = which ? v_pool : k_pool;
#pragma unroll
        for (int p = 0; p < PT; ++p) {
          const int idx = tid + p * kThreads, row = idx / PU, u = idx % PU;
          const int sl = slot_nx[p];
          const TP* src = sl >= 0 ? pool + (size_t)sl * D + u * (16 / (int)sizeof(TP)) : pool;
          if constexpr (kQuant) {
            cp_async16(smem_addr(raw_tile(stage, which)) + row * D + u * 16, src, sl >= 0);
          } else {
            cp_async16(smem_addr(kv_tile(stage, which)) + sw128(row, u), src, sl >= 0);
          }
        }
      }
      if constexpr (kQuant) {
        if (tid < 2 * kKeys) {
          const int which = tid / kKeys, row = tid & (kKeys - 1);
          const float* scp = which ? v_sc : k_sc;
          cp_async4(smem_addr(sc_s + (stage * 2 + which) * kKeys + row),
                    sc_slot_nx >= 0 ? scp + sc_slot_nx : scp, sc_slot_nx >= 0);
        }
      }
    } else {
      const int k0 = (i - n_prior_tiles) * kKeys, n = min(kKeys, k_end - k0);
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const TC* base = which ? v_row0 : k_row0;
#pragma unroll
        for (int p = 0; p < BT; ++p) {
          const int idx = tid + p * kThreads, row = idx / U, u = idx % U;
          const bool ok = row < n;
          const TC* src = ok ? base + (size_t)(k0 + row) * cur_stride + u * 8 : base;
          if constexpr (kDenseF32) {
            // float32 chunk K/V (int8 pools) rounded to bf16 as staged.
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (ok) {
              const float4 x = *reinterpret_cast<const float4*>(src);
              const float4 y = *reinterpret_cast<const float4*>(src + 4);
              v = make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w), pack_bf16(y.x, y.y),
                             pack_bf16(y.z, y.w));
            }
            *reinterpret_cast<uint4*>(kv_tile(stage, which) + sw128(row, u)) = v;
          } else {
            cp_async16(smem_addr(kv_tile(stage, which)) + sw128(row, u), src, ok);
          }
        }
      }
    }
  };
  // int8 pages: widen the staged tile to bf16 in the swizzled layout.
  auto widen = [&](int stage) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
#pragma unroll
      for (int p = 0; p < kKeys * D / 16 / kThreads; ++p) {
        const int idx = tid + p * kThreads, row = idx / (D / 16), ru = idx % (D / 16);
        const uint4 raw = *reinterpret_cast<const uint4*>(raw_tile(stage, which) + row * D + ru * 16);
        const uint2 a = int8x4_to_bf16x4(raw.x), b2 = int8x4_to_bf16x4(raw.y);
        const uint2 c = int8x4_to_bf16x4(raw.z), d = int8x4_to_bf16x4(raw.w);
        const uint4 lo = make_uint4(a.x, a.y, b2.x, b2.y), hi = make_uint4(c.x, c.y, d.x, d.y);
        uint8_t* dst = kv_tile(stage, which);
        *reinterpret_cast<uint4*>(dst + sw128(row, 2 * ru)) = lo;
        *reinterpret_cast<uint4*>(dst + sw128(row, 2 * ru + 1)) = hi;
      }
    }
  };

  // Prologue: tiles 0 .. kStages-2 in flight (group 0 also holds Q); one
  // commit per tile slot, empty or not, so wait_group counts tiles.
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    lookup(t);
    if (t < n_tiles) issue(t, t);
    cp_async_commit();
  }
  lookup(kStages - 1);
  cp_async_wait<kStages - 2>();  // this thread's copies of tile 0 (and Q) have landed
  __syncthreads();

  // This thread's two accumulator rows (CTA rows; fragment rows l/4 and
  // l/4 + 8 of its warp's 16) and the first of its two columns in each
  // 8-column slice.
  const bool active = wg * 64 < R;  // a warpgroup with live rows
  // Both warpgroups live: they take turns issuing their S products (named
  // barriers 1 and 2), so one's softmax runs while the other's wgmma does.
  // Warpgroup 1 opens warpgroup 0's first turn.
  const bool pingpong = R > 64;
  if (pingpong && wg == 1) bar_arrive(1, kThreads);
  const int rA = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2), rB = rA + 8;
  const int colq = 2 * (lane & 3);
  const float scl = kLog2e / sqrtf((float)D);  // softmax in base 2
  const uint32_t q_base = smem_addr(q_s) + wg * (64 * D * 2);
  float mA = kMask, mB = kMask, lA = 0.f, lB = 0.f;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  for (int i = 0, stage = 0; i < n_tiles; ++i, stage = stage + 1 == kStages ? 0 : stage + 1) {
    const bool is_prior = i < n_prior_tiles;
    const int ahead = i + kStages - 1;  // the tile whose copy starts now
    if (ahead < n_tiles) issue(ahead, stage == 0 ? kStages - 1 : stage - 1);
    cp_async_commit();
    lookup(ahead + 1);
    // Tile i is in shared memory (the barrier that ended the last tile
    // followed every thread's wait for it); int8 pages are widened now.
    if constexpr (kQuant) {
      if (is_prior) widen(stage);
    }
    fence_async_smem();
    __syncthreads();
    if (active) {
      const uint32_t k_base = smem_addr(kv_tile(stage, 0));
      const uint32_t v_base = smem_addr(kv_tile(stage, 1));
      // S = Q . K^T over the head dim, 16 at a time.
      float s[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      if (pingpong) bar_sync(1 + wg, kThreads);  // this warpgroup's turn
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk >> 2) * kAtom + (kk & 3) * 32;
        wgmma_m64n64k16_ss(s, sw128_desc(q_base + koff, 16, 1024),
                           sw128_desc(k_base + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      if (pingpong) bar_arrive(2 - wg, kThreads);  // the other's turn
      wgmma_wait0();
      fence_regs(s);

      // Keys 0..last of the tile are visible to a row; -1 for none.
      int base, n;
      bool causal;
      if (is_prior) {
        base = i * kKeys;
        n = min(kKeys, prior - base);
        causal = false;
      } else {
        base = (i - n_prior_tiles) * kKeys;
        n = min(kKeys, k_end - base);
        causal = true;
      }
      const int lastA = rA < R ? (causal ? min(n - 1, c0 + rA / G - base) : n - 1) : -1;
      const int lastB = rB < R ? (causal ? min(n - 1, c0 + rB / G - base) : n - 1) : -1;
      const bool scaled = kQuant && is_prior;
      const float* ks = sc_s + (stage * 2) * kKeys;
      const float* vs = ks + kKeys;

      // A tile whose keys every row sees, with no int8 scale (most prior
      // tiles): no masks, and the scale folds into one FFMA per score.
      // Only a full CTA (R == 128 rows) takes it: at GQA groups that do
      // not divide 128 (3, 5, 6, 7) every tile runs the masked path.
      const bool open_tile = !scaled && !causal && n == kKeys && R == kRows;
      float mxA = mA, mxB = mB;
      if (open_tile) {
        float ra = kMask, rb = kMask;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          ra = fmaxf(ra, fmaxf(s[4 * j], s[4 * j + 1]));
          rb = fmaxf(rb, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        mxA = fmaxf(mxA, ra * scl);  // scl > 0
        mxB = fmaxf(mxB, rb * scl);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + colq + e;
            const float f = scaled ? scl * ks[col] : scl;
            const float xa = col <= lastA ? s[4 * j + e] * f : kMask;
            const float xb = col <= lastB ? s[4 * j + 2 + e] * f : kMask;
            s[4 * j + e] = xa;
            s[4 * j + 2 + e] = xb;
            mxA = fmaxf(mxA, xa);
            mxB = fmaxf(mxB, xb);
          }
        }
      }
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));
      const float corrA = fast_exp2(mA - mxA), corrB = fast_exp2(mB - mxB);
      mA = mxA;
      mB = mxB;
      // P as the A operand of P.V: k-step kk takes slices 2kk (a0, a1)
      // and 2kk+1 (a2, a3), row A then row B.
      uint32_t pf[16];
      float sumA = 0.f, sumB = 0.f;
      auto put = [&](int j, const float (&pa)[2], const float (&pb)[2]) {
        pf[4 * (j >> 1) + 2 * (j & 1)] = pack_bf16(pa[0], pa[1]);
        pf[4 * (j >> 1) + 2 * (j & 1) + 1] = pack_bf16(pb[0], pb[1]);
      };
      if (open_tile) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float pa[2], pb[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            pa[e] = fast_exp2(fmaf(s[4 * j + e], scl, -mA));
            pb[e] = fast_exp2(fmaf(s[4 * j + 2 + e], scl, -mB));
            sumA += pa[e];
            sumB += pb[e];
          }
          put(j, pa, pb);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float pa[2], pb[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + colq + e;
            pa[e] = col <= lastA ? fast_exp2(s[4 * j + e] - mA) : 0.f;
            pb[e] = col <= lastB ? fast_exp2(s[4 * j + 2 + e] - mB) : 0.f;
            sumA += pa[e];
            sumB += pb[e];
            if (scaled) {
              pa[e] *= vs[col];
              pb[e] *= vs[col];
            }
          }
          put(j, pa, pb);
        }
      }
      lA = lA * corrA + sumA;
      lB = lB * corrB + sumB;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corrA;
        o[4 * j + 1] *= corrA;
        o[4 * j + 2] *= corrB;
        o[4 * j + 3] *= corrB;
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
        wgmma_pv<D>(o, a, sw128_desc(v_base + kk * 2048, kAtom, 1024));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
    }
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i+1 have landed
    __syncthreads();  // this stage is free for tile i + kStages; tile i+1 is visible
  }
  cp_async_wait<0>();
  if (pingpong && wg == 0) bar_sync(1, kThreads);  // warpgroup 1's last turn signal

  if (active) {
    lA += __shfl_xor_sync(0xffffffffu, lA, 1);
    lA += __shfl_xor_sync(0xffffffffu, lA, 2);
    lB += __shfl_xor_sync(0xffffffffu, lB, 1);
    lB += __shfl_xor_sync(0xffffffffu, lB, 2);
    const float invA = lA > 0.f ? 1.f / lA : 0.f, invB = lB > 0.f ? 1.f / lB : 0.f;
    __nv_bfloat16* outA =
        out + (((size_t)b * C + c0 + rA / G) * Hq + (size_t)h * G + rA % G) * D + colq;
    __nv_bfloat16* outB =
        out + (((size_t)b * C + c0 + rB / G) * Hq + (size_t)h * G + rB % G) * D + colq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (rA < R)
        *reinterpret_cast<uint32_t*>(outA + 8 * j) = pack_bf16(o[4 * j] * invA, o[4 * j + 1] * invA);
      if (rB < R)
        *reinterpret_cast<uint32_t*>(outB + 8 * j) =
            pack_bf16(o[4 * j + 2] * invB, o[4 * j + 3] * invB);
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

template <typename TP, typename TC, int D, int G>
cudaError_t launch(const ChunkArgs& a, cudaStream_t stream) {
  constexpr int bytes = Smem<D, std::is_same<TP, int8_t>::value>::bytes;
  static SmemOptIn opt_in;
  cudaError_t err = opt_in.ensure(paged_chunk_tc_kernel<TP, TC, D, G>, bytes);
  if (err != cudaSuccess) return err;
  paged_chunk_tc_kernel<TP, TC, D, G><<<dim3(a.B, a.Hkv, a.C / a.cblk), kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const TC*>(a.k_cur),
      static_cast<const TC*>(a.v_cur), static_cast<const TP*>(a.kv), a.kv_scale, a.pt, a.prior,
      a.kvlen, static_cast<__nv_bfloat16*>(a.out), a.C, a.Hq, a.Hkv, a.L, a.num_slots, a.page,
      a.max_pages, a.layer, a.cblk);
  return cudaGetLastError();
}

template <typename TP, typename TC, int D>
cudaError_t launch_g(const ChunkArgs& a, cudaStream_t stream) {
  switch (a.Hq / a.Hkv) {
    case 1: return launch<TP, TC, D, 1>(a, stream);
    case 2: return launch<TP, TC, D, 2>(a, stream);
    case 3: return launch<TP, TC, D, 3>(a, stream);
    case 4: return launch<TP, TC, D, 4>(a, stream);
    case 5: return launch<TP, TC, D, 5>(a, stream);
    case 6: return launch<TP, TC, D, 6>(a, stream);
    case 7: return launch<TP, TC, D, 7>(a, stream);
    case 8: return launch<TP, TC, D, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TP, typename TC>
cudaError_t launch_d(const ChunkArgs& a, cudaStream_t stream) {
  if (a.D == 64) return launch_g<TP, TC, 64>(a, stream);
  if (a.D == 128) return launch_g<TP, TC, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace radixmesh

// q_dtype: must be 1 (bfloat16; float32 queries take paged_chunk_launch);
// pool_dtype: 1 = bfloat16 (k_cur/v_cur bf16), or 2 = int8 with kv_scale
// [2, L, Hkv, num_slots] f32 (else nullptr) and k_cur/v_cur in float32.
// cblk = queries per CTA (divides C, cblk * (Hq / Hkv) <= 128). Returns
// the cudaError_t of the launch (0 on success). Launches on `stream`;
// allocates nothing.
extern "C" int paged_chunk_tc_launch(int q_dtype, int pool_dtype, const void* q,
                                     const void* k_cur, const void* v_cur, const void* kv,
                                     const void* kv_scale, const void* page_table,
                                     const void* prior_lengths, const void* kv_lengths,
                                     void* out, int B, int C, int Hq, int Hkv, int D, int L,
                                     int num_slots, int page, int max_pages, int layer,
                                     int cblk, void* stream) {
  using namespace radixmesh;
  if (B == 0 || C == 0) return 0;
  if (q_dtype != 1 || Hkv <= 0 || Hq % Hkv != 0 || cblk <= 0 || C % cblk != 0 ||
      cblk * (Hq / Hkv) > kRows)
    return (int)cudaErrorInvalidValue;
  if ((pool_dtype == 2) != (kv_scale != nullptr)) return (int)cudaErrorInvalidValue;
  const ChunkArgs a{q, k_cur, v_cur, kv, static_cast<const float*>(kv_scale),
                    static_cast<const int*>(page_table),
                    static_cast<const int*>(prior_lengths),
                    static_cast<const int*>(kv_lengths), out, B, C, Hq, Hkv, D, L,
                    num_slots, page, max_pages, layer, cblk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 1) return (int)launch_d<__nv_bfloat16, __nv_bfloat16>(a, s);
  if (pool_dtype == 2) return (int)launch_d<int8_t, float>(a, s);
  return (int)cudaErrorInvalidValue;
}
