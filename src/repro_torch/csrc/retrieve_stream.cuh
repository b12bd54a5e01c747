// Streaming DS-Softmax retrieval shared by dss_topk_fused.cu, the decode
// body of dss_topk_grouped.cu and dss_topk.cu (sm_90a).
//
// The retrieval is bound by bytes at decode: a few tokens per expert, so
// each needed expert's rows are read once per call (once per group of up
// to tb of its tokens) and the fp32 products are 1-2 flops per row byte
// and token, below the CUDA cores' ridge. The design spends itself on the
// loads: enough bytes in flight on every SM to cover the memory's latency.
//
// Both kernels here are templates over a token source (GateTokens,
// SlotTokens, ExpertTokens below): slot i of the source is a token row
// x + i * d with gate value gate(i) and a local expert (or none). Order of operations is the
// contract of topk_common.cuh: z = x . w in fp32, times the row scale
// (int8), times g, padding rows -> -1e9, ties to the lowest packed position.
//
// 1. retrieve_kernel, a grid fixed by the shapes (two blocks on each SM):
//    every block counts the source's slots per expert and builds the same
//    work list, the experts with at least one token in ascending id, each
//    cut into row chunks so that those experts, however many, share the
//    grid evenly (chunk_rows_for); block b takes items b, b + grid, ...; a
//    block with none exits after that count, and block 0 writes the count
//    for the merge. An item streams its chunk once per group of up to tb of
//    the expert's tokens, staged in shared memory as fp32. A producer warp
//    copies tiles of rs rows into a ring of shared-memory stages with
//    full/empty mbarriers, so tens of KB per block are in flight: one bulk
//    asynchronous copy (cp.async.bulk) per tile when rows are 16-byte
//    aligned, else a warp copy in VB-byte words; the chunk's ids and scales
//    are staged once, and padding rows at a tile's edges are not copied
//    (their value is -1e9 whatever the row holds). Consumer warp w scores
//    rows w and w + 8 of a tile together against up to 4 tokens at a time
//    (template bounds, so no token's work runs predicated): lane l reads
//    the VB-byte vectors l, l + 32, ... of a row and 16 bytes of a token per
//    load (the tokens are laid out so no two lanes meet in a bank), fmaf
//    over each vector's elements in order, then a butterfly. That tree
//    depends only on d and VB, never on the warp, block or chunk, so
//    duplicate rows tie exactly. Each warp keeps per token a list of
//    (value, packed position) ordered by (value desc, position asc) in
//    shared memory, inserted by the whole warp (ballot for the rank, a
//    shuffle for the shift) only when a candidate beats the k-th. The 8
//    warps' lists are merged by rank (every entry counts the entries before
//    it by binary search), all threads at once, into part[chunk][slot].
// 2. merge_kernel, one 8-warp block per slot: the chunks' lists fold into k
//    outputs, and the class ids of the k positions are looked up; a slot
//    with no expert gets the source's own output (Src::unserved).
// Candidates carry their packed position, so every merge order gives the
// same list. Empty list entries are (-inf, kNoPos), strictly below -1e9;
// every row is a candidate in some chunk and v_pad >= k, so none reaches an
// output.
#pragma once

#include <algorithm>

#include "topk_common.cuh"

namespace repro {
namespace stream {

constexpr int kWarps = 8;                  // consumer warps (merge: all warps)
constexpr int kThreads = kWarps * 32;
constexpr int kRetrieveThreads = kThreads + 32;  // + the producer warp
constexpr int kTB = 8;                     // most tokens staged per pass over a chunk
constexpr int kRowStep = 16;               // chunk lengths are multiples of this
constexpr int kTokenBytes = 40 * 1024;     // budget of the staged tokens
constexpr int kMaxChunkRows = 1024;        // ids and scales of a chunk live in shared memory
constexpr int kStageBytes = 24 * 1024;     // budget of one ring stage
constexpr int kMaxTileRows = 2 * kWarps;   // rows of a stage (a consumer warp takes 1 or 2)
constexpr int kRingBytes = 48 * 1024;      // budget of the ring
constexpr int kMaxStages = 8;
constexpr int kMergeEntries = 4096;        // partial-list entries the merge holds at once
constexpr int kNoPos = 0x7fffffff;         // position of an empty list slot
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float av, int ap, float bv, int bp) {
  return av > bv || (av == bv && ap < bp);
}

// A list holds stride = 32 or 64 slots (k <= 32 or k <= 64), lane l
// owning slots l and l + 32; slots from k on stay empty.
__host__ __device__ __forceinline__ int list_stride(int k) { return k <= 32 ? 32 : 64; }

__device__ __forceinline__ void list_init(float* lv, int* lp, int stride) {
  for (int j = threadIdx.x & 31; j < stride; j += 32) {
    lv[j] = -CUDART_INF_F;
    lp[j] = kNoPos;
  }
  __syncwarp();
}

// Insert (cv, cp), the same on every lane, into the warp's list of k if it
// beats the k-th entry.
__device__ __forceinline__ void list_insert(float* lv, int* lp, float cv, int cp, int k,
                                            int stride) {
  if (!better(cv, cp, lv[k - 1], lp[k - 1])) return;
  const int lane = threadIdx.x & 31;
  const float v0 = lv[lane];
  const int p0 = lp[lane];
  int rank = __popc(__ballot_sync(kFull, better(v0, p0, cv, cp)));
  const float u0 = __shfl_up_sync(kFull, v0, 1);
  const int q0 = __shfl_up_sync(kFull, p0, 1);
  if (stride > 32) {
    const float v1 = lv[lane + 32];
    const int p1 = lp[lane + 32];
    rank += __popc(__ballot_sync(kFull, better(v1, p1, cv, cp)));
    float u1 = __shfl_up_sync(kFull, v1, 1);
    int q1 = __shfl_up_sync(kFull, p1, 1);
    const float t = __shfl_sync(kFull, v0, 31);
    const int tp = __shfl_sync(kFull, p0, 31);
    if (lane == 0) u1 = t, q1 = tp;
    const int j = lane + 32;
    if (j < k && j >= rank) {
      lv[j] = j == rank ? cv : u1;
      lp[j] = j == rank ? cp : q1;
    }
  }
  if (lane < k && lane >= rank) {
    lv[lane] = lane == rank ? cv : u0;
    lp[lane] = lane == rank ? cp : q0;
  }
  __syncwarp();
}

// bytes (a multiple of 16) from 16-byte aligned global src to shared dst,
// completing on the barrier's transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// Named barrier of the consumer warps (the producer warp does not take it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}
// Named barrier of the whole retrieval block (producer and consumers).
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kRetrieveThreads) : "memory");
}

// Entries of the sorted list (lv, lp) of k that come before candidate
// (cv, cp) in a merge: strictly better ones, and equal ones too when
// `ties` (the list precedes the candidate's). Binary search.
__device__ __forceinline__ int count_before(const float* lv, const int* lp, int k, float cv,
                                            int cp, bool ties) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    const bool before = ties ? !better(cv, cp, lv[mid], lp[mid]) : better(lv[mid], lp[mid], cv, cp);
    if (before)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Rank merge of n_lists sorted lists of k (list L at lv/lp + L * lstride)
// into the first k of their union, by `nthreads` threads from `tid`: entry
// j of list L lands at j plus the entries of the other lists before it
// (equal entries of earlier lists first), so every rank is distinct. emit
// (rank, value, position) is called for the ranks below k.
template <typename Emit>
__device__ __forceinline__ void rank_merge(const float* lv, const int* lp, int lstride,
                                           int n_lists, int k, int tid, int nthreads,
                                           Emit emit) {
  for (int i = tid; i < n_lists * k; i += nthreads) {
    const int L = i / k, j = i - L * k;
    const float cv = lv[L * lstride + j];
    const int cp = lp[L * lstride + j];
    int rank = j;
    for (int M = 0; M < n_lists && rank < k; ++M)
      if (M != L) rank += count_before(lv + M * lstride, lp + M * lstride, k, cv, cp, M < L);
    if (rank < k) emit(rank, cv, cp);
  }
}

// Staged tokens are fp32, element n of row vector j of token t at
// xs[((t * (N / G) + n / G) * nv + j) * G + n % G] with G = min(N, 4): a
// warp reads G consecutive floats per lane for consecutive j, one 16-byte
// load where G is 4, and no two lanes of a warp meet in one bank.
template <int N>
constexpr int kGroupWidth = N < 4 ? N : 4;

template <int G>
__device__ __forceinline__ void load_group(const float* p, float* y) {
  if constexpr (G == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    y[0] = v.x, y[1] = v.y, y[2] = v.z, y[3] = v.w;
  } else if constexpr (G == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    y[0] = v.x, y[1] = v.y;
  } else {
    y[0] = *p;
  }
}

// Rows q0 + 8 i (i < R) of a tile against staged tokens t0 .. t0 + NT - 1
// (those below n_tok). Per row and token: lane l sums the VB-byte vectors
// l, l + 32, ... (fmaf over each vector's elements in order), a butterfly,
// then the row scale (int8) and g on the fp32 sum; a padding row (id < 0)
// scores -1e9. Each candidate (value, row) goes to the warp's list for its
// token. The R rows share each token load and give independent FMA
// chains. NT is a template bound: a loop over every staged token guarded
// by t < n_tok would run all their loads and FMAs predicated.
template <int NT, int R, typename TW, int VB>
__device__ __forceinline__ void score_rows(const char* stage, size_t row_bytes, int q0, int base,
                                           const int* sid, const float* ssc, const float* xs,
                                           int nv, int t0, int n_tok, const float* tg,
                                           float* my_v, int* my_p, int k, int stride) {
  using V = Vec<TW, VB>;
  constexpr int N = V::N, G = kGroupWidth<N>;
  const TW* row[R];
  int id[R];
  float z[R][NT];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    row[i] = reinterpret_cast<const TW*>(stage + (q0 + kWarps * i) * row_bytes);
    id[i] = sid[q0 + kWarps * i];
#pragma unroll
    for (int t = 0; t < NT; ++t) z[i][t] = 0.f;
  }
  bool any = false;
#pragma unroll
  for (int i = 0; i < R; ++i) any |= id[i] >= 0;
#pragma unroll 2
  for (int j = threadIdx.x % 32; any && j < nv; j += 32) {
    float x[R][N];
#pragma unroll
    for (int i = 0; i < R; ++i) V::load(row[i] + j * N, x[i]);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (NT == 1 || t0 + t < n_tok) {
#pragma unroll
        for (int ng = 0; ng < N / G; ++ng) {
          float y[G];
          load_group<G>(xs + (((t0 + t) * (N / G) + ng) * nv + j) * G, y);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int n = 0; n < G; ++n) z[i][t] = fmaf(x[i][ng * G + n], y[n], z[i][t]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (NT == 1 || t0 + t < n_tok) {
        float v = kNegInfMask;
        if (id[i] >= 0) {
          v = warp_sum(z[i][t]);
          if constexpr (std::is_same_v<TW, int8_t>) v *= ssc[q0 + kWarps * i];
          v *= tg[t0 + t];
        }
        list_insert(my_v + (t0 + t) * stride, my_p + (t0 + t) * stride, v,
                    base + q0 + kWarps * i, k, stride);
      }
    }
}

// All tokens of the pass against rows q0 + 8 i (i < R) of a tile, up to 4
// tokens per pass over the rows.
template <int R, typename TW, int VB>
__device__ __forceinline__ void score_tile_rows(const char* stage, size_t row_bytes, int q0,
                                                int base, const int* sid, const float* ssc,
                                                const float* xs, int nv, int n_tok,
                                                const float* tg, float* my_v, int* my_p, int k,
                                                int stride) {
  for (int t0 = 0; t0 < n_tok; t0 += 4) {
    const int n = n_tok - t0;
    if (n == 1)
      score_rows<1, R, TW, VB>(stage, row_bytes, q0, base, sid, ssc, xs, nv, t0, n_tok, tg, my_v,
                               my_p, k, stride);
    else if (n == 2)
      score_rows<2, R, TW, VB>(stage, row_bytes, q0, base, sid, ssc, xs, nv, t0, n_tok, tg, my_v,
                               my_p, k, stride);
    else
      score_rows<4, R, TW, VB>(stage, row_bytes, q0, base, sid, ssc, xs, nv, t0, n_tok, tg, my_v,
                               my_p, k, stride);
  }
}

// Rows per chunk when n_sel experts share `grid` blocks: each expert gets
// grid / n_sel blocks, so every SM holds the same number of chunks
// whatever the expert count; a multiple of kRowStep, at most kMaxChunkRows.
__host__ __device__ __forceinline__ int chunk_rows_for(int n_sel, int v_pad, int grid) {
  const int per = max(1, grid / max(1, n_sel));
  const int rows = ((v_pad + per - 1) / per + kRowStep - 1) / kRowStep * kRowStep;
  return min(kMaxChunkRows, max(kRowStep, rows));
}

// k outputs (-inf, -1), by the whole merge block: a token no expert serves.
__device__ __forceinline__ void emit_none(int k, float* ov, int* oi) {
  for (int j = threadIdx.x; j < k; j += kThreads) {
    ov[j] = -CUDART_INF_F;
    oi[j] = -1;
  }
}

// Token source of dss_topk_fused: slot t is token t (h row t, gate value
// g[t]) of global expert sel[t]; served when that expert is local (in
// [e_base, e_base + K)), else it emits (-inf, -1).
template <typename TX>
struct GateTokens {
  using T = TX;
  const TX* x;
  const float* g;
  const int* sel;
  int B, K, e_base;
  __device__ __forceinline__ int n_slots() const { return B; }
  __device__ __forceinline__ int expert(int i) const {
    const int e = sel[i] - e_base;
    return e >= 0 && e < K ? e : -1;
  }
  __device__ __forceinline__ float gate(int i) const { return g[i]; }
  // the slots where expert e's tokens lie
  __device__ __forceinline__ int first(int) const { return 0; }
  __device__ __forceinline__ int end(int) const { return B; }
  // By the whole merge block: slot r's k outputs when it has no expert.
  __device__ void unserved(int, const int*, int, int k, float* ov, int* oi) const {
    emit_none(k, ov, oi);
  }
};

// Token source of dss_topk_grouped: slot i = e * C + c is buf[e, c] with
// gate value g_buf[e, c], live when that value is not 0 (the gate's g is
// at least 1/K for a real token; the dispatch leaves empty slots at 0).
template <typename TX>
struct SlotTokens {
  using T = TX;
  const TX* x;
  const float* g;
  int K, C;
  __device__ __forceinline__ int n_slots() const { return K * C; }
  __device__ __forceinline__ int expert(int i) const { return g[i] != 0.f ? i / C : -1; }
  __device__ __forceinline__ float gate(int i) const { return g[i]; }
  __device__ __forceinline__ int first(int e) const { return e * C; }
  __device__ __forceinline__ int end(int e) const { return e * C + C; }
  // By the whole merge block: an empty slot r of expert e = r / C. For
  // finite rows and tokens every real row scores x . w * 0 = +-0, all tied,
  // and padding rows -1e9: the plain version's output is (0, id) on the
  // first k real packed positions, then (-1e9, -1). Written from ids alone,
  // 8 positions per thread per pass (a block scan ranks the real ones),
  // until k real rows are found or the rows end.
  __device__ void unserved(int r, const int* ids, int v_pad, int k, float* ov, int* oi) const {
    constexpr int P = 8;
    __shared__ int warp_n[kWarps];
    const int* ide = ids + static_cast<size_t>(r / C) * v_pad;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int found = 0;  // real rows before this pass
    for (int base = 0; base < v_pad && found < k; base += kThreads * P) {
      const int p0 = base + tid * P;
      int n = 0;
#pragma unroll
      for (int j = 0; j < P; ++j) n += p0 + j < v_pad && ide[p0 + j] >= 0;
      int incl = n;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) warp_n[warp] = incl;
      __syncthreads();
      int rank = found + incl - n, total = found;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) rank += warp_n[w];
        total += warp_n[w];
      }
      for (int j = 0; j < P && rank < k; ++j)
        if (p0 + j < v_pad && ide[p0 + j] >= 0) {
          ov[rank] = 0.f;
          oi[rank] = ide[p0 + j];
          ++rank;
        }
      __syncthreads();  // warp_n is rewritten by the next pass
      found = total;
    }
    for (int j = found + tid; j < k; j += kThreads) {
      ov[j] = kNegInfMask;
      oi[j] = -1;
    }
  }
};

// Token source of dss_topk: slot t is row t of h_scaled, the token already
// multiplied by its gate value, of expert expert_idx[t]; served when that
// lies in [0, K), else it emits (-inf, -1). Its gate value is exactly 1 (z * 1
// is exact, so the scores are the plain x . w).
template <typename TX>
struct ExpertTokens {
  using T = TX;
  const TX* x;
  const int* sel;
  int B, K;
  __device__ __forceinline__ int n_slots() const { return B; }
  __device__ __forceinline__ int expert(int i) const {
    const int e = sel[i];
    return e >= 0 && e < K ? e : -1;
  }
  __device__ __forceinline__ float gate(int) const { return 1.f; }
  __device__ __forceinline__ int first(int) const { return 0; }
  __device__ __forceinline__ int end(int) const { return B; }
  __device__ void unserved(int, const int*, int, int k, float* ov, int* oi) const {
    emit_none(k, ov, oi);
  }
};

// 1. The experts with a token, in chunks of chunk_rows_for(n_sel) rows:
// item i is chunk i % nck of the (i / nck)-th such expert in ascending id;
// block b takes items b, b + gridDim.x, ... (one each at decode). For each
// item the block streams the chunk once per group of up to tb of the
// expert's tokens and writes each token's partial list of k to
// part[c][slot]. Warps 0-7 consume, warp 8 produces the ring of rs-row
// tiles. Block 0 writes n_sel to *n_sel_out for the merge.
template <typename Src, typename TW, int VB>
__global__ void __launch_bounds__(kRetrieveThreads, 2)
retrieve_kernel(const Src src, const TW* __restrict__ w, const int* __restrict__ ids,
                const float* __restrict__ scales, float* __restrict__ part_v,
                int* __restrict__ part_p, int* __restrict__ n_sel_out, int K, int v_pad, int d,
                int k, int tb, int rs, int stages) {
  using V = Vec<TW, VB>;
  constexpr int N = V::N;
  extern __shared__ __align__(128) char smem[];
  __shared__ int tok[kTB], n_tok_s, n_sel_s;
  __shared__ float tg[kTB];
  const int stride = list_stride(k);
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(TW);
  const size_t stage_bytes = (rs * row_bytes + 15) / 16 * 16;
  char* ring = smem;                                            // [stages][rs rows]
  float* xs = reinterpret_cast<float*>(ring + stages * stage_bytes);  // [tb][d] tokens
  float* lv_all = xs + (static_cast<size_t>(tb) * d + 3) / 4 * 4;    // [kWarps][tb][stride]
  int* lp_all = reinterpret_cast<int*>(lv_all + kWarps * tb * stride);
  int* sid = lp_all + kWarps * tb * stride;                          // [kMaxChunkRows] ids
  float* ssc = reinterpret_cast<float*>(sid + kMaxChunkRows);       // [kMaxChunkRows] scales
  uint64_t* bars = reinterpret_cast<uint64_t*>(ssc + kMaxChunkRows);  // full, empty
  int* cnt = reinterpret_cast<int*>(bars + 2 * stages);              // [K] tokens per expert
  int* elist = cnt + K;                                              // [K] the experts with one
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // -- the work list: tokens per expert, the experts that have one -------
  for (int e = tid; e < K; e += kRetrieveThreads) cnt[e] = 0;
  __syncthreads();
  const int n_slots = src.n_slots();
  for (int i = tid; i < n_slots; i += kRetrieveThreads) {
    const int e = src.expert(i);
    if (e >= 0) atomicAdd(&cnt[e], 1);
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int e0 = 0; e0 < K; e0 += 32) {
      const int e = e0 + lane;
      const bool has = e < K && cnt[e] > 0;
      const unsigned bits = __ballot_sync(kFull, has);
      if (has) elist[n + __popc(bits & ((1u << lane) - 1u))] = e;
      n += __popc(bits);
    }
    if (lane == 0) {
      n_sel_s = n;
      if (blockIdx.x == 0) *n_sel_out = n;
      for (int s = 0; s < stages; ++s) {
        mbar_init(smem_u32(bars + s), 1);
        mbar_init(smem_u32(bars + stages + s), kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  const int n_sel = n_sel_s;
  const int chunk_rows = chunk_rows_for(n_sel, v_pad, gridDim.x);
  const int nck = (v_pad + chunk_rows - 1) / chunk_rows;
  const int n_items = n_sel * nck;
  if (static_cast<int>(blockIdx.x) >= n_items) return;
  auto full = [&](int s) { return smem_u32(bars + s); };
  auto empty = [&](int s) { return smem_u32(bars + stages + s); };
  const int nv = d / N;
  float* my_v = lv_all + warp * tb * stride;
  int* my_p = lp_all + warp * tb * stride;
  int tile = 0;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int e = elist[item / nck];  // this item's local expert
    const int c = item % nck;
    const size_t e_row = static_cast<size_t>(e) * v_pad;
    const TW* __restrict__ we = w + e_row * d;
    const int* __restrict__ ide = ids + e_row;
    const float* __restrict__ sce = scales != nullptr ? scales + e_row : nullptr;
    const int row_lo = c * chunk_rows, row_hi = min(v_pad, row_lo + chunk_rows);
    block_sync();  // the previous item is done with sid/ssc
    for (int r = row_lo + tid; r < row_hi; r += kRetrieveThreads) {  // the chunk's ids, scales
      sid[r - row_lo] = ide[r];
      ssc[r - row_lo] = sce != nullptr ? sce[r] : 1.f;
    }
    block_sync();
    const int n_groups = (cnt[e] + tb - 1) / tb;

    if (warp == kWarps) {
      // -- producer: tile i of the block goes to stage i % stages ----------
      for (int grp = 0; grp < n_groups; ++grp)
        for (int base = row_lo; base < row_hi; base += rs, ++tile) {
          const unsigned real = __ballot_sync(
              kFull, lane < rs && base + lane < row_hi && sid[base - row_lo + lane] >= 0);
          const int s = tile % stages;
          if (tile >= stages) mbar_wait(empty(s), ((tile / stages) - 1) & 1);
          char* dst = ring + s * stage_bytes;
          if (real == 0u) {
            if (lane == 0) mbar_arrive(full(s));
            continue;
          }
          const int first = __ffs(real) - 1, last = 31 - __clz(real);
          const size_t off = static_cast<size_t>(first) * row_bytes;
          const size_t bytes = static_cast<size_t>(last - first + 1) * row_bytes;
          const char* src_rows = reinterpret_cast<const char*>(we + static_cast<size_t>(base) * d);
          if constexpr (VB == 16) {
            if (lane == 0) {
              mbar_expect_tx(full(s), static_cast<uint32_t>(bytes));
              bulk_copy(smem_u32(dst + off), src_rows + off, static_cast<uint32_t>(bytes),
                        full(s));
            }
          } else {
            using Word = typename V::Raw;
            const Word* sw = reinterpret_cast<const Word*>(src_rows + off);
            Word* dw = reinterpret_cast<Word*>(dst + off);
            for (size_t i = lane; i < bytes / VB; i += 32) dw[i] = sw[i];
            __threadfence_block();
            __syncwarp();
            if (lane == 0) mbar_arrive(full(s));
          }
        }
      continue;
    }

    // -- consumers: warp w takes rows w and w + 8 of every tile -----------
    int cursor = src.first(e);
    const int scan_end = src.end(e);
    for (int grp = 0; grp < n_groups; ++grp) {
      if (warp == 0) {  // the next (at most tb) tokens of expert e, in slot order
        int n = 0, t0 = cursor;
        while (t0 < scan_end && n < tb) {
          const int t = t0 + lane;
          const bool hit = t < scan_end && src.expert(t) == e;
          const unsigned bits = __ballot_sync(kFull, hit);
          const int take = min(__popc(bits), tb - n);
          const int r = __popc(bits & ((1u << lane) - 1u));
          if (hit && r < take) {
            tok[n + r] = t;
            tg[n + r] = src.gate(t);
          }
          n += take;
          if (take < __popc(bits)) {  // resume at the first hit not taken
            unsigned rest = bits;
            for (int i = 0; i < take; ++i) rest &= rest - 1u;
            t0 += __ffs(rest) - 1;
            break;
          }
          t0 += 32;
        }
        cursor = t0;
        if (lane == 0) n_tok_s = n;
      }
      consumers_sync();
      const int n_tok = n_tok_s;
      for (int i = tid; i < n_tok * d; i += kThreads) {  // the layout of score_rows
        constexpr int G = kGroupWidth<N>;
        const int t = i / d, el = i - t * d, n = el % N;
        xs[((t * (N / G) + n / G) * nv + el / N) * G + n % G] =
            to_f32(src.x[static_cast<size_t>(tok[t]) * d + el]);
      }
      for (int t = 0; t < tb; ++t) list_init(my_v + t * stride, my_p + t * stride, stride);
      consumers_sync();

      for (int base = row_lo; base < row_hi; base += rs, ++tile) {
        const int s = tile % stages;
        mbar_wait(full(s), (tile / stages) & 1);
        const char* stage = ring + s * stage_bytes;
        // warp w: rows w and w + 8 of the tile together, or row w alone
        const int* tsid = sid + (base - row_lo);
        const float* tssc = ssc + (base - row_lo);
        if (warp + kWarps < rs && base + warp + kWarps < row_hi)
          score_tile_rows<2, TW, VB>(stage, row_bytes, warp, base, tsid, tssc, xs, nv, n_tok, tg,
                                     my_v, my_p, k, stride);
        else if (warp < rs && base + warp < row_hi)
          score_tile_rows<1, TW, VB>(stage, row_bytes, warp, base, tsid, tssc, xs, nv, n_tok, tg,
                                     my_v, my_p, k, stride);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }
      consumers_sync();
      // the 8 warps' lists of each token, merged by rank into part[c][slot]
      for (int t = 0; t < n_tok; ++t) {
        const size_t o = (static_cast<size_t>(c) * n_slots + tok[t]) * k;
        rank_merge(lv_all + t * stride, lp_all + t * stride, tb * stride, kWarps, k, tid,
                   kThreads, [&](int rank, float v, int p) {
                     part_v[o + rank] = v;
                     part_p[o + rank] = p;
                   });
      }
      consumers_sync();
    }
  }
}

// 2. Block r is slot r: its partial lists (one per chunk of its expert, the
// retrieval's chunking for the *n_sel experts it served) merged into its k
// outputs, the class ids looked up; a slot with no expert gets
// Src::unserved. The lists pass through shared memory in batches; each
// warp folds its share into a list (a list is read until its first entry
// that does not enter), and the 8 warps' lists are merged by rank.
template <typename Src>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const Src src, const float* __restrict__ part_v, const int* __restrict__ part_p,
             const int* __restrict__ ids, const int* __restrict__ n_sel_p,
             float* __restrict__ out_v, int* __restrict__ out_i, int v_pad, int k, int grid) {
  __shared__ float lv_all[kWarps * 64], bv[kMergeEntries];
  __shared__ int lp_all[kWarps * 64], bp[kMergeEntries];
  const int r = blockIdx.x, tid = threadIdx.x, warp = tid / 32;
  const int e = src.expert(r);
  float* ov = out_v + static_cast<size_t>(r) * k;
  int* oi = out_i + static_cast<size_t>(r) * k;
  if (e < 0) {
    src.unserved(r, ids, v_pad, k, ov, oi);
    return;
  }
  const int n_slots = src.n_slots();
  const int chunk_rows = chunk_rows_for(*n_sel_p, v_pad, grid);
  const int nchunks = (v_pad + chunk_rows - 1) / chunk_rows;
  const int* ide = ids + static_cast<size_t>(e) * v_pad;
  auto emit = [&](int rank, float v, int p) {
    ov[rank] = v;
    oi[rank] = p < v_pad ? ide[p] : -1;
  };
  const int stride = list_stride(k);
  float* lv = lv_all + warp * stride;
  int* lp = lp_all + warp * stride;
  list_init(lv, lp, stride);
  const int per = kMergeEntries / k;
  for (int c0 = 0; c0 < nchunks; c0 += per) {
    const int nl = min(per, nchunks - c0);
    for (int i = tid; i < nl * k; i += kThreads) {
      const int L = i / k;
      const size_t o = (static_cast<size_t>(c0 + L) * n_slots + r) * k + (i - L * k);
      bv[i] = part_v[o];
      bp[i] = part_p[o];
    }
    __syncthreads();
    for (int L = warp; L < nl; L += kWarps)
      for (int j = 0; j < k; ++j) {
        const float cv = bv[L * k + j];
        const int cp = bp[L * k + j];
        if (!better(cv, cp, lv[k - 1], lp[k - 1])) break;
        list_insert(lv, lp, cv, cp, k, stride);
      }
    __syncthreads();
  }
  rank_merge(lv_all, lp_all, stride, kWarps, k, tid, kThreads, emit);
}

// Shared memory of the retrieval: the ring, tb staged tokens, the lists,
// the chunk's ids and scales, the barriers, the per-expert counts.
struct Layout {
  int tb, rs, stages;
  size_t bytes;
};

inline Layout layout(int d, int wbytes, int k, int K) {
  Layout l;
  const size_t row = static_cast<size_t>(d) * wbytes;
  l.tb = static_cast<int>(std::min<size_t>(kTB, std::max<size_t>(1, kTokenBytes / (4 * static_cast<size_t>(d)))));
  l.rs = static_cast<int>(std::min<size_t>(kMaxTileRows, std::max<size_t>(1, kStageBytes / row)));
  const size_t stage = (l.rs * row + 15) / 16 * 16;
  l.stages = static_cast<int>(std::min<size_t>(kMaxStages, std::max<size_t>(2, kRingBytes / stage)));
  l.bytes = l.stages * stage + (static_cast<size_t>(l.tb) * d + 3) / 4 * 16 +
            sizeof(float) * 2 * kWarps * l.tb * list_stride(k) +
            sizeof(float) * 2 * kMaxChunkRows + 16 * l.stages + sizeof(int) * 2 * K;
  return l;
}

// Launch the retrieval over `grid` blocks, then the merge over the
// source's slots. part_v, part_p: (chunks of one expert when a single
// expert has tokens, n_slots, k) scratch; n_sel: one int of scratch.
template <typename Src, typename TW, int VB>
cudaError_t launch_retrieve(const Src& src, const TW* w, const int* ids, const float* scales,
                            float* part_v, int* part_p, int* n_sel, float* out_v, int* out_i,
                            int n_slots, int K, int v_pad, int d, int k, int grid,
                            cudaStream_t stream) {
  const Layout l = layout(d, sizeof(TW), k, K);
  auto kern = retrieve_kernel<Src, TW, VB>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(l.bytes));
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory, so two blocks fit
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<grid, kRetrieveThreads, l.bytes, stream>>>(src, w, ids, scales, part_v, part_p, n_sel,
                                                    K, v_pad, d, k, l.tb, l.rs, l.stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<Src><<<n_slots, kThreads, 0, stream>>>(src, part_v, part_p, ids, n_sel, out_v,
                                                      out_i, v_pad, k, grid);
  return cudaGetLastError();
}

// Checks shared by the entry points: the row load width VB (16 or 4 bytes,
// or one element) fits the rows and their base, and the layout fits a block.
inline bool stream_args_ok(const void* w, int d, int wbytes, int vb, int k, int K) {
  if ((vb != 16 && vb != 4 && vb != wbytes) || vb < wbytes ||
      (static_cast<long long>(d) * wbytes) % vb != 0 || reinterpret_cast<uintptr_t>(w) % vb != 0)
    return false;
  return layout(d, wbytes, k, K).bytes <= 232448;
}

}  // namespace stream
}  // namespace repro
