// Gate -> dispatch -> retrieve DS-Softmax decode kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dss_topk_fused.py::dss_topk_fused (Pallas,
// TPU; both bodies: `_kernel` for f32/bf16 rows and `_kernel_q` for int8
// rows with per-row fp32 scales). Per token: fp32 gate logits over the
// K_real gate rows (gate and tokens in the token dtype), the FIRST argmax
// of the logits, and g = 1 / sum(exp(l - max)). Then retrieval over the
// selected expert's packed rows: z = x . w in fp32, times the row scale
// (int8), times g, padding rows -> -1e9, top-k with ties to the lowest
// packed position. Outputs (B, k) values and class ids plus the (B,)
// GLOBAL expert id; a token whose expert lies outside [e_base, e_base + K)
// emits (-inf, -1).
//
// Bound on this card: bytes. At decode (a few tokens per expert) the work
// is the chosen experts' rows, each to be read once per call; the fp32
// products are 1 flop per row byte and token (bf16; 2 for int8), below the
// CUDA cores' 20 flop/byte ridge, so the design spends itself on the loads:
// enough bytes in flight on every SM to cover the memory's latency.
//
// Design: three launches, no host sync, no allocation.
// 1. gate_kernel, one 8-warp block per token: the logits through
//    repro::gate_logits (gate_top1.cu's summation tree, 16-byte loads when
//    aligned), the first argmax and g, written once to out_e and scratch.
// 2. retrieve_kernel, a grid fixed by the shapes (two blocks on each SM):
//    every block reads out_e and builds the same work list, the chosen
//    local experts in ascending id, each cut into row chunks so that the
//    experts chosen, however many, share the grid evenly (chunk_rows_for);
//    block b takes items b, b + grid, ...; a block with none exits after
//    that count. An item streams its chunk once per group of up to tb of
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
//    it by binary search), all threads at once, into part[chunk][token].
// 3. merge_kernel, one 8-warp block per token: the chunks' lists fold into
//    k outputs (below), and the class ids of the k positions are looked up.
// Candidates carry their packed position, so every merge order gives the
// same list. Empty slots are (-inf, kNoPos), strictly below -1e9; every
// row is a candidate in some chunk and v_pad >= k, so none reaches a token.
#include <algorithm>

#include "topk_common.cuh"

namespace {

constexpr int kWarps = 8;                  // consumer warps (gate, merge: all warps)
constexpr int kThreads = kWarps * 32;
constexpr int kRetrieveThreads = kThreads + 32;  // + the producer warp
constexpr int kTB = 8;                     // most tokens staged per pass over a chunk
constexpr int kRowStep = 16;               // chunk lengths are multiples of this
constexpr int kTokenBytes = 40 * 1024;     // budget of the staged tokens
constexpr int kMaxChunkRows = 512;         // ids and scales of a chunk live in shared memory
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

using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_u32;

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

// 1. Block b is token b: out_e[b] = first argmax of the logits (global
// expert id), g[b] = 1 / sum exp(l - max).
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
gate_kernel(const T* __restrict__ gate_w, const T* __restrict__ h, int* __restrict__ out_e,
            float* __restrict__ g, int K_real, int d) {
  __shared__ float z[repro::kMaxK];
  const int b = blockIdx.x, lane = threadIdx.x % 32;
  repro::gate_logits<T, VB, kWarps>(gate_w, h + static_cast<size_t>(b) * d, K_real, d, z);
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const bool has0 = lane < K_real, has1 = lane + 32 < K_real;
  const float z0 = has0 ? z[lane] : -CUDART_INF_F;
  const float z1 = has1 ? z[lane + 32] : -CUDART_INF_F;
  float m = z0;
  int arg = has0 ? lane : repro::kMaxK;
  if (has1 && z1 > m) m = z1, arg = lane + 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(kFull, m, off);
    const int oa = __shfl_xor_sync(kFull, arg, off);
    if (om > m || (om == m && oa < arg)) m = om, arg = oa;
  }
  const float sum = repro::warp_sum((has0 ? expf(z0 - m) : 0.f) + (has1 ? expf(z1 - m) : 0.f));
  if (lane == 0) {
    out_e[b] = arg;
    g[b] = 1.f / sum;
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
  using V = repro::Vec<TW, VB>;
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
        float v = repro::kNegInfMask;
        if (id[i] >= 0) {
          v = repro::warp_sum(z[i][t]);
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

// Bit e set: global expert e is local and chosen by some token.
__device__ __forceinline__ unsigned long long chosen_experts(const int* sel, int B, int K,
                                                             int e_base) {
  unsigned long long m = 0ull;
  for (int t = threadIdx.x % 32; t < B; t += 32) {
    const int ge = sel[t], e = ge - e_base;
    if (e >= 0 && e < K) m |= 1ull << ge;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m |= __shfl_xor_sync(kFull, m, off);
  return m;
}

// Named barrier of the whole retrieval block (producer and consumers).
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kRetrieveThreads) : "memory");
}

// 2. The chosen experts' rows in chunks of chunk_rows_for(n_sel) rows: item
// i is chunk i % nck of the (i / nck)-th chosen expert in ascending id
// order; block b takes items b, b + gridDim.x, ... (one each at decode). For each
// item the block streams the chunk once per group of up to tb of the
// expert's tokens and writes each token's partial list of k to
// part[c][token]. Warps 0-7 consume, warp 8 produces the ring of rs-row
// tiles.
template <typename TX, typename TW, int VB>
__global__ void __launch_bounds__(kRetrieveThreads, 2)
retrieve_kernel(const TW* __restrict__ w, const int* __restrict__ ids,
                const float* __restrict__ scales, const TX* __restrict__ h,
                const int* __restrict__ sel, const float* __restrict__ gval,
                float* __restrict__ part_v, int* __restrict__ part_p, int K, int B, int v_pad,
                int d, int k, int e_base, int tb, int rs, int stages) {
  using V = repro::Vec<TW, VB>;
  constexpr int N = V::N;
  extern __shared__ __align__(128) char smem[];
  __shared__ int ecount[repro::kMaxK], tok[kTB], n_tok_s;
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
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // -- the work list, from out_e: the chosen experts, their token counts ---
  const unsigned long long chosen = chosen_experts(sel, B, K, e_base);
  const int n_sel = __popcll(chosen);
  const int chunk_rows = chunk_rows_for(n_sel, v_pad, gridDim.x);
  const int nck = (v_pad + chunk_rows - 1) / chunk_rows;
  const int n_items = n_sel * nck;
  if (static_cast<int>(blockIdx.x) >= n_items) return;
  if (tid < repro::kMaxK) ecount[tid] = 0;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(bars + s), 1);
      mbar_init(smem_u32(bars + stages + s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int t = tid; t < B; t += kRetrieveThreads)
    if ((chosen >> sel[t]) & 1ull) atomicAdd(&ecount[sel[t]], 1);
  auto full = [&](int s) { return smem_u32(bars + s); };
  auto empty = [&](int s) { return smem_u32(bars + stages + s); };
  const int nv = d / N;
  float* my_v = lv_all + warp * tb * stride;
  int* my_p = lp_all + warp * tb * stride;
  int tile = 0;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    unsigned long long m = chosen;
    for (int i = 0; i < item / nck; ++i) m &= m - 1;
    const int ge = __ffsll(static_cast<long long>(m)) - 1;  // this item's global expert
    const int c = item % nck;
    const size_t e_row = static_cast<size_t>(ge - e_base) * v_pad;
    const TW* __restrict__ we = w + e_row * d;
    const int* __restrict__ ide = ids + e_row;
    const float* __restrict__ sce = scales != nullptr ? scales + e_row : nullptr;
    const int row_lo = c * chunk_rows, row_hi = min(v_pad, row_lo + chunk_rows);
    block_sync();  // the previous item is done with sid/ssc; ecount is complete
    for (int r = row_lo + tid; r < row_hi; r += kRetrieveThreads) {  // the chunk's ids, scales
      sid[r - row_lo] = ide[r];
      ssc[r - row_lo] = sce != nullptr ? sce[r] : 1.f;
    }
    block_sync();
    const int n_groups = (ecount[ge] + tb - 1) / tb;

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
          const char* src = reinterpret_cast<const char*>(we + static_cast<size_t>(base) * d);
          if constexpr (VB == 16) {
            if (lane == 0) {
              mbar_expect_tx(full(s), static_cast<uint32_t>(bytes));
              bulk_copy(smem_u32(dst + off), src + off, static_cast<uint32_t>(bytes), full(s));
            }
          } else {
            using Word = typename V::Raw;
            const Word* sw = reinterpret_cast<const Word*>(src + off);
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
    int cursor = 0;
    for (int grp = 0; grp < n_groups; ++grp) {
      if (warp == 0) {  // the next (at most tb) tokens of expert ge, in order
        int n = 0, t0 = cursor;
        while (t0 < B && n < tb) {
          const int t = t0 + lane;
          const bool hit = t < B && sel[t] == ge;
          const unsigned bits = __ballot_sync(kFull, hit);
          const int take = min(__popc(bits), tb - n);
          const int r = __popc(bits & ((1u << lane) - 1u));
          if (hit && r < take) {
            tok[n + r] = t;
            tg[n + r] = gval[t];
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
            repro::to_f32(h[static_cast<size_t>(tok[t]) * d + el]);
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
      // the 8 warps' lists of each token, merged by rank into part[c][token]
      for (int t = 0; t < n_tok; ++t) {
        const size_t o = (static_cast<size_t>(c) * B + tok[t]) * k;
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

// 3. Block b is token b: its partial lists (one per chunk of its expert,
// the retrieval's chunking) merged into its k outputs, the class ids looked
// up. The lists pass through shared memory in batches; each warp folds its
// share into a list (a list is read until its first entry that does not
// enter), and the 8 warps' lists are merged by rank.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_p,
             const int* __restrict__ sel, const int* __restrict__ ids, float* __restrict__ out_v,
             int* __restrict__ out_i, int K, int B, int v_pad, int k, int e_base, int grid) {
  __shared__ float lv_all[kWarps * 64], bv[kMergeEntries];
  __shared__ int lp_all[kWarps * 64], bp[kMergeEntries];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32;
  const int e = sel[b] - e_base;
  float* ov = out_v + static_cast<size_t>(b) * k;
  int* oi = out_i + static_cast<size_t>(b) * k;
  if (e < 0 || e >= K) {
    for (int j = tid; j < k; j += kThreads) {
      ov[j] = -CUDART_INF_F;
      oi[j] = -1;
    }
    return;
  }
  const int n_sel = __popcll(chosen_experts(sel, B, K, e_base));
  const int chunk_rows = chunk_rows_for(n_sel, v_pad, grid);
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
      const size_t o = (static_cast<size_t>(c0 + L) * B + b) * k + (i - L * k);
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

// Shared memory of the retrieval: the ring, tb staged tokens, the lists.
struct Layout {
  int tb, rs, stages;
  size_t bytes;
};

Layout layout(int d, int wbytes, int k) {
  Layout l;
  const size_t row = static_cast<size_t>(d) * wbytes;
  l.tb = static_cast<int>(std::min<size_t>(kTB, std::max<size_t>(1, kTokenBytes / (4 * static_cast<size_t>(d)))));
  l.rs = static_cast<int>(std::min<size_t>(kMaxTileRows, std::max<size_t>(1, kStageBytes / row)));
  const size_t stage = (l.rs * row + 15) / 16 * 16;
  l.stages = static_cast<int>(std::min<size_t>(kMaxStages, std::max<size_t>(2, kRingBytes / stage)));
  l.bytes = l.stages * stage + (static_cast<size_t>(l.tb) * d + 3) / 4 * 16 +
            sizeof(float) * 2 * kWarps * l.tb * list_stride(k) +
            sizeof(float) * 2 * kMaxChunkRows + 16 * l.stages;
  return l;
}

struct Args {
  const void *gate_w, *w, *h;
  const int* ids;
  const float* scales;
  float *out_v, *g, *part_v;
  int *out_i, *out_e, *part_p;
  int K_real, K, B, v_pad, d, k, e_base, grid, vb;
  cudaStream_t stream;
};

template <typename TX, typename TW, int VB>
cudaError_t launch(const Args& a) {
  // the gate: 16-byte loads when both base pointers and the row pitch allow
  const bool gvec = (reinterpret_cast<uintptr_t>(a.gate_w) | reinterpret_cast<uintptr_t>(a.h)) %
                            16 == 0 &&
                    (a.d * sizeof(TX)) % 16 == 0;
  const TX* gw = static_cast<const TX*>(a.gate_w);
  const TX* h = static_cast<const TX*>(a.h);
  if (gvec)
    gate_kernel<TX, 16><<<a.B, kThreads, 0, a.stream>>>(gw, h, a.out_e, a.g, a.K_real, a.d);
  else
    gate_kernel<TX, static_cast<int>(sizeof(TX))>
        <<<a.B, kThreads, 0, a.stream>>>(gw, h, a.out_e, a.g, a.K_real, a.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Layout l = layout(a.d, sizeof(TW), a.k);
  auto kern = retrieve_kernel<TX, TW, VB>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(l.bytes));
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory, so two blocks fit
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<a.grid, kRetrieveThreads, l.bytes, a.stream>>>(
      static_cast<const TW*>(a.w), a.ids, a.scales, h, a.out_e, a.g, a.part_v, a.part_p, a.K,
      a.B, a.v_pad, a.d, a.k, a.e_base, l.tb, l.rs, l.stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<a.B, kThreads, 0, a.stream>>>(a.part_v, a.part_p, a.out_e, a.ids, a.out_v,
                                               a.out_i, a.K, a.B, a.v_pad, a.k, a.e_base,
                                               a.grid);
  return cudaGetLastError();
}

// Row vectors of VB bytes: 16 or 4, or one element.
template <typename TX, typename TW>
cudaError_t dispatch_vb(const Args& a) {
  if (a.vb == 16) return launch<TX, TW, 16>(a);
  if (a.vb == 4) return launch<TX, TW, 4>(a);
  if constexpr (sizeof(TW) < 4) {
    if (a.vb == static_cast<int>(sizeof(TW))) return launch<TX, TW, static_cast<int>(sizeof(TW))>(a);
  }
  return cudaErrorInvalidValue;
}

// Token type TX with rows of the token type, or int8 rows with scales.
template <typename TX>
cudaError_t dispatch_w(int wdtype, const Args& a) {
  if (wdtype == repro::kDtypeI8) {
    if (a.scales == nullptr) return cudaErrorInvalidValue;
    return dispatch_vb<TX, int8_t>(a);
  }
  if (a.scales != nullptr) return cudaErrorInvalidValue;
  return dispatch_vb<TX, TX>(a);
}

}  // namespace

// wdtype: the rows' dtype code, either dtype (f32/bf16 rows, scales null)
// or kDtypeI8 (int8 rows with (K, v_pad) fp32 scales). g (B,), part_v and
// part_p (nchunks, B, k) are scratch, nchunks the chunks of one expert when
// a single expert is chosen (the most there can be). grid and vb come from
// kernels/dss_topk_fused.py::launch_plan.
extern "C" int dss_topk_fused(const void* gate_w, const void* w, const void* ids,
                              const void* scales, const void* h, void* out_v, void* out_i,
                              void* out_e, void* g, void* part_v, void* part_p, int K_real,
                              int K, int B, int v_pad, int d, int k, int e_base, int grid,
                              int vb, int dtype, int wdtype, void* stream) {
  if (k < 1 || k > repro::kMaxK || k > v_pad || K < 1 || K_real < 1 ||
      K_real > repro::kMaxK || B < 0 || d < 1 || grid < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  if (wdtype != dtype && wdtype != repro::kDtypeI8) return cudaErrorInvalidValue;
  const int wbytes = wdtype == repro::kDtypeI8 ? 1 : (wdtype == repro::kDtypeF32 ? 4 : 2);
  if ((vb != 16 && vb != 4 && vb != wbytes) || vb < wbytes ||
      (static_cast<long long>(d) * wbytes) % vb != 0 || reinterpret_cast<uintptr_t>(w) % vb != 0)
    return cudaErrorInvalidValue;
  if (layout(d, wbytes, k).bytes > 232448) return cudaErrorInvalidValue;
  const Args a{gate_w, w, h, static_cast<const int*>(ids), static_cast<const float*>(scales),
               static_cast<float*>(out_v), static_cast<float*>(g), static_cast<float*>(part_v),
               static_cast<int*>(out_i), static_cast<int*>(out_e), static_cast<int*>(part_p),
               K_real, K, B, v_pad, d, k, e_base, grid, vb, static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kDtypeF32) return dispatch_w<float>(wdtype, a);
  if (dtype == repro::kDtypeBF16) return dispatch_w<__nv_bfloat16>(wdtype, a);
  return cudaErrorInvalidValue;
}
