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
// kv_lengths). Online softmax in fp32, queries pre-scaled by 1/sqrt(D),
// output [B, C, Hq, D] in float32, zeros where the softmax denominator is
// 0. Masked keys are zero-filled in shared memory and their probabilities
// set to exactly 0, so NaN or Inf in an unreferenced page or a padded
// chunk position never reaches the accumulator.
//
// int8 pools (kv_scale [2, L, Hkv, num_slots] f32): prior K/V tiles load
// as int8 and are multiplied by their per-token scale while they are
// staged to shared memory; the chunk's own K/V arrive already dequantized,
// in float32 (what the pool will hold, not the full-precision rows).
//
// What bounds it on an H100: operations, at the 67 TFLOP/s float32 rate
// of the CUDA cores. It does 4*Hq*D*sum_b C*(prior + C/2) flops against
// 2*Hkv*D*sum_b prior elements of pool K/V read.
//
// The design is the simple form: one CTA per (row, kv head, query block),
// with Cblk*G <= 64 query rows (all G heads of the group share each K/V
// tile). Queries stay in shared memory; 32-token K and V tiles are staged
// in shared memory with 16-byte loads; each thread computes a 2x4 tile of
// scores and a 2 x D/8 slice of the accumulator in fp32; loads are not
// overlapped with compute.

#include <type_traits>

#include "common.cuh"

namespace radixmesh {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // keys per tile
constexpr int kRows = 64;  // query rows (Cblk * G) per CTA, at most

template <int D>
constexpr size_t smem_bytes() {
  // Qs [kRows][D+1], KVs [kTile][D+1], Ps [kRows][kTile+1], m/l/corr
  // [kRows], k/v scales [kTile] floats, then key offsets [kTile] int64.
  return sizeof(float) * (kRows * (D + 1) + kTile * (D + 1) + kRows * (kTile + 1) +
                          3 * kRows + 2 * kTile) +
         sizeof(long long) * kTile;
}

// Stage one tile of keys (K or V) as float: row t < n from src + off[t]
// (times sc[t] when kScaled), zeros for t >= n.
template <typename T, int D, bool kScaled>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          const long long* off, const float* sc, int n,
                                          float* KVs) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int DP = D + 1;
  for (int e = threadIdx.x; e < kTile * D / VEC; e += kThreads) {
    const int t = (e * VEC) / D, d = (e * VEC) % D;
    float v[VEC];
    if (t < n) {
      load_vec<T, VEC>(src + off[t] + d, v);
      if constexpr (kScaled) {
        const float s = sc[t];
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] *= s;
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) KVs[t * DP + d + i] = v[i];
  }
}

// Key t of the tile is visible to query row r: r is a live row, t a loaded
// key, and (dense tiles) causal in chunk coordinates.
template <int G>
__device__ __forceinline__ bool visible(int r, int t, int R, int n, bool causal,
                                        int k0, int c0) {
  return r < R && t < n && (!causal || k0 + t <= c0 + r / G);
}

// One tile of the online softmax: scores, row max/sum update, P·V.
// Keys are already described by off[] (n valid, with their scales in
// ks[]/vs[] when kScaled); the tile is causal for dense chunk keys
// starting at chunk offset k0.
template <typename T, int D, int G, bool kScaled>
__device__ __forceinline__ void tile_step(const T* __restrict__ ksrc,
                                          const T* __restrict__ vsrc, int n,
                                          bool causal, int k0, int c0, int R,
                                          const float* Qs, float* KVs, float* Ps,
                                          float* m_s, float* l_s, float* c_s,
                                          const long long* off, const float* ks,
                                          const float* vs, float (&acc)[2][D / 8]) {
  constexpr int DP = D + 1, PP = kTile + 1;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  load_tile<T, D, kScaled>(ksrc, off, ks, n, KVs);
  __syncthreads();
  // Scores for rows {ty, ty+32} x keys {tx, tx+8, tx+16, tx+24}.
  float s[2][4] = {};
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float qa = Qs[ty * DP + d], qb = Qs[(ty + 32) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float k = KVs[(tx + 8 * j) * DP + d];
      s[0][j] += qa * k;
      s[1][j] += qb * k;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 32 * i, t = tx + 8 * j;
      Ps[r * PP + t] = visible<G>(r, t, R, n, causal, k0, c0) ? s[i][j] : kMask;
    }
  __syncthreads();
  // Row statistics (one thread per query row) while all threads stage V.
  if (tid < kRows) {
    const int r = tid;
    float mx = kMask;
    for (int t = 0; t < kTile; ++t) mx = fmaxf(mx, Ps[r * PP + t]);
    const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int t = 0; t < kTile; ++t) {
      const float p = visible<G>(r, t, R, n, causal, k0, c0) ? expf(Ps[r * PP + t] - m_new) : 0.f;
      Ps[r * PP + t] = p;
      sum += p;
    }
    const float corr = expf(m_old - m_new);
    c_s[r] = corr;
    l_s[r] = l_s[r] * corr + sum;
    m_s[r] = m_new;
  }
  load_tile<T, D, kScaled>(vsrc, off, vs, n, KVs);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 32 * i;
    const float corr = c_s[r];
#pragma unroll
    for (int k = 0; k < D / 8; ++k) acc[i][k] *= corr;
    for (int t = 0; t < kTile; ++t) {
      const float p = Ps[r * PP + t];
#pragma unroll
      for (int k = 0; k < D / 8; ++k) acc[i][k] += p * KVs[t * DP + tx + 8 * k];
    }
  }
  __syncthreads();
}

// TQ: queries and output; TP: the pool (int8_t with kv_scale); TC: the
// chunk's dense K/V (the pool dtype for bf16/f32 pools, float for int8).
template <typename TQ, typename TP, typename TC, int D, int G>
__global__ void __launch_bounds__(kThreads) paged_chunk_kernel(
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
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KVs = Qs + kRows * DP;
  float* Ps = KVs + kTile * DP;
  float* m_s = Ps + kRows * (kTile + 1);
  float* l_s = m_s + kRows;
  float* c_s = l_s + kRows;
  float* ks_s = c_s + kRows;
  float* vs_s = ks_s + kTile;
  long long* off = reinterpret_cast<long long*>(vs_s + kTile);

  const int b = blockIdx.x, h = blockIdx.y, cb = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int R = cblk * G;
  const int c0 = cb * cblk;
  const int prior = min(max(prior_lengths[b], 0), max_pages * page);
  const int n_dense = min(max(kv_lengths[b] - prior, 0), C);
  const float scale = 1.0f / sqrtf((float)D);

  // Query row r = (c - c0) * G + g, pre-scaled; rows >= R stay zero.
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float v = 0.f;
    if (r < R) {
      const int c = c0 + r / G, g = r % G;
      v = to_f(q[(((size_t)b * C + c) * Hq + (size_t)h * G + g) * D + d]) * scale;
    }
    Qs[r * DP + d] = v;
  }
  if (tid < kRows) {
    m_s[tid] = kMask;
    l_s[tid] = 0.f;
  }
  float acc[2][D / 8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < D / 8; ++k) acc[i][k] = 0.f;

  // Prior context from the pool pages.
  const size_t head_stride = (size_t)num_slots * D;
  const TP* k_pool = kv + ((size_t)layer * Hkv + h) * head_stride;
  const TP* v_pool = kv + ((size_t)(L + layer) * Hkv + h) * head_stride;
  const float* k_sc = kQuant ? kv_scale + ((size_t)layer * Hkv + h) * num_slots : nullptr;
  const float* v_sc = kQuant ? kv_scale + ((size_t)(L + layer) * Hkv + h) * num_slots : nullptr;
  const int* pt = page_table + (size_t)b * max_pages;
  for (int t0 = 0; t0 < prior; t0 += kTile) {
    const int n = min(kTile, prior - t0);
    __syncthreads();  // previous readers of off[] are done
    if (tid < n) {
      const int tok = t0 + tid;
      const int slot = pt[tok / page] * page + tok % page;
      off[tid] = (long long)slot * D;
      if constexpr (kQuant) {
        ks_s[tid] = k_sc[slot];
        vs_s[tid] = v_sc[slot];
      }
    }
    __syncthreads();
    tile_step<TP, D, G, kQuant>(k_pool, v_pool, n, false, 0, c0, R, Qs, KVs, Ps, m_s,
                                l_s, c_s, off, ks_s, vs_s, acc);
  }
  // The chunk itself, dense and causal: keys below min(c0 + cblk, n_dense).
  const int k_end = min(c0 + cblk, n_dense);
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int n = min(kTile, k_end - k0);
    __syncthreads();
    if (tid < n) off[tid] = (((long long)b * C + k0 + tid) * Hkv + h) * D;
    __syncthreads();
    tile_step<TC, D, G, false>(k_cur, v_cur, n, true, k0, c0, R, Qs, KVs, Ps, m_s, l_s,
                               c_s, off, nullptr, nullptr, acc);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 32 * i;
    if (r < R) {
      const int c = c0 + r / G, g = r % G;
      const float l = l_s[r];
      TQ* o = out + (((size_t)b * C + c) * Hq + (size_t)h * G + g) * D;
#pragma unroll
      for (int k = 0; k < D / 8; ++k)
        o[tx + 8 * k] = from_f<TQ>(l > 0.f ? acc[i][k] / l : 0.f);
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
  constexpr size_t bytes = smem_bytes<D>();
  static SmemOptIn opt_in;
  cudaError_t err = opt_in.ensure(paged_chunk_kernel<TQ, TP, TC, D, G>, (int)bytes);
  if (err != cudaSuccess) return err;
  paged_chunk_kernel<TQ, TP, TC, D, G>
      <<<dim3(a.B, a.Hkv, a.C / a.cblk), kThreads, bytes, stream>>>(
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

// q_dtype: must be 0 (float32; bfloat16 queries take
// paged_chunk_tc_launch); pool_dtype: 0 = float32 (k_cur/v_cur float32),
// or 2 = int8 with kv_scale [2, L, Hkv, num_slots] f32 (else nullptr) and
// k_cur/v_cur in float32. cblk = queries per CTA
// (divides C, cblk * (Hq / Hkv) <= 64). Returns the cudaError_t of the
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
