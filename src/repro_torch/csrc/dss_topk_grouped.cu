// Expert-grouped DS-Softmax retrieval for Hopper (sm_90a), three bodies for
// each row kind.
//
// Replaces: src/repro/kernels/dss_topk_grouped.py::dss_topk_grouped
// (Pallas, TPU; both bodies: `_kernel` for f32/bf16 rows and `_kernel_q`
// for int8 rows with per-row fp32 scales). Per expert e and token slot c:
// z = buf[e, c] . weights[e, v] in fp32, then z *= scales[e, v] (int8
// rows), then z *= g_buf[e, c], padding rows (ids == -1) -> -1e9, top-k
// over v with ties to the lowest packed position. Outputs (K, C, k) fp32
// values and int32 class ids; padding rows come out as exactly (-1e9, -1).
// int8 rows are widened exactly (|q| <= 127) like the tokens; an int8 x
// int8 tensor-core product would need the tokens quantized, which is not
// the reference's function. The wrapper (kernels/dss_topk_grouped.py::
// select_body) picks a body by the capacity C and the token dtype.
//
// Bound on this card, and what each body does about it.
//
// dss_topk_grouped, the decode body (C of a few slots). Bound: bytes, the
// rows of the experts that hold a token (1 byte per element plus a 4-byte
// scale per row for int8). It is the streaming retrieval of
// retrieve_stream.cuh over the token source SlotTokens: slot c of expert e
// is live when g_buf[e, c] != 0 (the gate's g is at least 1/K for a real
// token; the dispatch zeroes empty slots). Every block builds the work list
// from g_buf on the device (the experts with a live slot, in ascending id,
// cut into row chunks over a fixed grid of two blocks per SM), so the call
// makes no host sync and allocates nothing, and an expert without a live
// slot is never read. Each live expert's chunk streams once per group of up
// to tb of its live slots. An empty slot's output is written by the merge
// from ids alone: for FINITE rows and tokens the plain version scores every
// real row x . w * 0 = +-0 (a tie) and every padding row -1e9, so it is
// (0, id) on the first k real packed positions, then (-1e9, -1).
//
// dss_topk_grouped_wgmma, the tensor-core body (bf16 tokens at prefill
// capacities). Bound: the larger of every expert's rows read once and
// 2*K*C*V_pad*d operations at the bf16 tensor-core rate (at C 256, d 1536,
// K 16, V_pad 12,032: 0.59 GB and 151 GFLOP, about 0.17 and 0.15 ms).
// - One block of 384 threads per (vocab split, token tile, expert): two
//   consumer warpgroups and a producer warpgroup that gives its registers
//   up (setmaxnreg: 232 per consumer thread, so the N / 2 accumulators and
//   the epilogue do not spill). The wrapper's plan
//   (kernels/dss_topk_grouped.py::wgmma_plan) sizes the token tile N (16,
//   32, 64, 128 or 256, the smallest that holds C, at most 256) and splits
//   the vocab into 128-row tiles over enough blocks to fill the 132 SMs in
//   one wave; a second kernel merges the splits' lists in split order.
//   An expert's rows are read once per token tile: once for C <= 256.
// - Vocab rows are wgmma's M operand (64 rows per consumer warpgroup), the
//   token tile its N operand, both K-major as stored, so nothing is
//   transposed. One producer lane streams (128 rows x 64 d) row tiles and
//   (N tokens x 64 d) token tiles through a ring of 2-4 stages with
//   full/empty mbarriers (TMA, 3-D maps over (d, rows, K); rows past V_pad,
//   tokens past C and d past its end arrive as zero fill, so every k16
//   slice is issued: a product under a branch makes ptxas serialize them).
//   Waiting threads sleep in the barrier (try_wait with a time hint).
// - bf16 rows: both operands from shared memory (128-byte swizzle),
//   m64nNk16 with one group of products in flight while the next stage's
//   are issued, and the tile's last wait unconditional (a wait ptxas cannot
//   prove taken before the epilogue reads the accumulators makes it
//   serialize every product: C7518). int8 rows: the stage holds (128 x 64)
//   int8 bytes without swizzle; each thread widens its two rows to bf16 in
//   registers (exact) as the m64k16 A fragments and wgmma reads A from
//   registers.
// - The top-k, per tile, on the accumulators. Each token keeps one list of
//   k 64-bit keys (the value's bits made order-preserving, then the
//   position's complement: value desc, position asc in one compare) and a
//   threshold, the list's k-th entry (value, position); since the list only
//   gains, a value that does not beat the threshold of any earlier state
//   of the list is not in the top k. Pass 1, a few instructions a value:
//   a bit per (token, row pair) when either row's u = acc x scale reaches
//   the token's bound on u (u_bound of the threshold and g; padding rows
//   compare z = -1e9 with the threshold itself). Pass 2, one copy of the
//   loop body for the pairs that passed: both values picked from the
//   accumulators by a chain of selects, z = u x g (padding -1e9) compared
//   exactly, and each candidate takes a slot in its token's queue by a
//   shared-memory atomic (past 16 slots, in a spill area in device memory
//   that holds a tile's 128 rows, so nothing is dropped). After a named
//   barrier one thread per token merges its queue into its list (in
//   registers for k <= 8) and publishes the new threshold; the next tile's
//   filter starts after another barrier.
// - The first tile starts from a threshold: the k-th largest of the 8
//   consumer warps' top 2 per token (k <= 16; warp shuffles, exchanged
//   through the queue), or for padding rows (all -1e9, a tie) one past the
//   tile's k-th padding row. Empty slots (g 0) take no candidate: their
//   list follows from ids alone, as in the decode body.
// - Shared memory (wgmma_smem_bytes): the ring, stages x (row tile 16 KB
//   bf16 / 8 KB int8 + N x 128 B tokens) and its barriers, plus per token
//   the k-key list, the threshold and bound, 16 queue slots (8 bytes each),
//   a count and g, plus 1 KB of alignment; at N 256, k 8: 3 stages (202 KB)
//   bf16, 4 (218 KB) int8, of the 227 KB a block may use. The plan lowers
//   the stage count, then N, until it fits.
// - What bounds it (an H100 80GB HBM3 at 700 W; PERF.md section 6): the
//   products run as fast as rows (HBM) and token slices (L2) arrive (17 us
//   a 128-row tile at C 256, bf16); the epilogue adds ~6 us a tile with no
//   product in flight, its cost set by code size (it runs once a tile from
//   an instruction cache that the memory stream leaves cold) and by the two
//   barriers. Top-k warps merging beside the products slowed the products
//   by 3.5 us a tile, so the merge runs in the epilogue.
//
// dss_topk_grouped_tiled, the CUDA-core tiled body (fp32 tokens at prefill
// capacities, where tensor cores would need TF32 and change the function;
// also bf16 tokens that TMA cannot address). It replaces a body of 64-token
// tiles, 4 x 4 micro-tiles and a serial top-k (11.7 ms at C 256 on an H100
// 80GB HBM3 at 700 W, chip_smoke.py phase 2). Bound:
// operations, 2*128*BN*d fp32 FMA operations per (live token tile of BN
// slots, 128-row tile with a real row) at the fp32 CUDA-core rate of 67
// TFLOP/s (at C 256, d 1536, K 16, V_pad 12,032, every slot live: about
// 2.0 ms).
// - Work items of (vocab chunk, expert, token tile of BN = 16, 32, 64 or
//   128 slots), pulled from a counter by persistent blocks of 256 threads,
//   so the SMs stay busy however much work is skipped (with 128-slot tiles
//   each expert's last chunks hold one row tile, so the last items pulled
//   are short). An item whose token tile has no live slot (g_buf == 0
//   throughout) does no product: its slots get the decode body's rule from
//   ids alone. A 128-row tile whose
//   ids are all -1 does no product either: its rows are -1e9 candidates.
//   Both facts are read on the device: no host sync, no allocation.
// - The product: each thread keeps an 8 x BN/16 micro-tile of fp32
//   accumulators (8 x 8 at BN 128) and reads its rows and tokens of four d
//   as 16-byte shared-memory loads, one FMA per accumulator in turn. A ring
//   of 4 stages of (128 rows, BN tokens) x 32 d is filled by TMA (one
//   thread, two 3-D boxes a stage, zero fill past every edge, 128-byte
//   swizzle so those loads hit distinct banks); int8 rows arrive 4 slices
//   (128 bytes a row) at a time and are widened to fp32 once, a slice a
//   stage (topk_common.cuh's exact byte_perm widening). Token tiles of 16 and
//   32 map threads to 2 rows x BN/4 tokens instead (4 lanes share a row's
//   load) and pass their sums through shared memory to the top-k. Each
//   expert's rows are read once per token tile: twice at C 256, the second
//   time mostly from L2, since the two token tiles of a (chunk, expert) are
//   consecutive items.
// - The top-k on the accumulators: x scale[row] (int8), x g[token], padding
//   -1e9, each value compared once against its token's current k-th entry.
//   The 16 lanes of a half-warp hold all 128 rows of the tile for their
//   tokens, so a token's list (shared memory, value desc, position asc) is
//   kept by one half-warp without a block barrier: its best candidate is
//   found by shuffles and inserted by the 16 lanes at once, until the best
//   one left no longer beats the k-th entry. A chunk's items start with
//   empty lists, so a finished item publishes each slot's k-th value
//   (atomicMax of an order-preserving key): k values at or above it exist,
//   so the items still to come drop every value below it.
// - Vocab chunks (at most 64 per expert) write partial lists, which
//   topk_common.cuh's merge_splits_kernel merges in position order.
#include <algorithm>

#include "retrieve_stream.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kNoPos = 0x7fffffff;  // position of an unfilled list entry
constexpr int kSmemMax = 232448;    // shared memory a block may use

// (v, p) before (lv, lp) in the list order: value desc, position asc.
__device__ __forceinline__ bool before(float v, int p, float lv, int lp) {
  return v > lv || (v == lv && p < lp);
}

// The 3-D map (d, rows, K) of one operand, box (box_d, box_rows, 1);
// elements outside the tensor read as zero.
cudaError_t make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem,
                     int d, int rows, int K, int box_d, int box_rows,
                     CUtensorMapSwizzle swizzle) {
  repro::EncodeTiledFn encode = repro::encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t pitch = static_cast<cuuint64_t>(d) * elem;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(K)};
  cuuint64_t strides[2] = {pitch, pitch * rows};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(box_d), static_cast<cuuint32_t>(box_rows), 1};
  cuuint32_t es[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, es,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- the CUDA-core tiled body (fp32 tokens, prefill capacities) ----------

namespace simt {

constexpr int kRows = 128;          // vocab rows per tile
constexpr int kSlice = 32;          // d elements per ring stage: 128-byte fp32 rows
constexpr int kStages = 4;          // ring stages: 3 in flight while one is multiplied
constexpr int kRawSlices = 4;       // int8 rows: one raw block holds 4 slices (128 bytes a row)
constexpr int kRawSlots = 3;        // raw blocks in the ring: 2 in flight while one is widened
constexpr int kRawRow = kSlice * kRawSlices;  // bytes of a row in a raw block
constexpr int kThreads = 256;       // 16 row groups x 16 token groups
constexpr int kMaxChunks = 64;      // vocab chunks per expert (repro::launch_merge takes 288)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMisc = 16;           // ints of scratch: item[2], live count, real count, warp counts
constexpr int kNarrow = 32;         // token tiles up to this take the narrow product
constexpr int kZPitch = kRows + 4;  // fp32 per token of a narrow tile's logits

// Byte offsets from the 1024-aligned base of the dynamic shared memory
// (kernels/dss_topk_grouped.py::tiled_smem_bytes mirrors it). fp32 rows are
// staged in a ring of kStages; int8 rows land raw, 4 slices (128 bytes a
// row) at a time, in a ring of kRawSlots blocks and are widened a slice at a
// time into two fp32 buffers.
struct Layout {
  int rows;    // [row buffers][kRows][kSlice] fp32 rows, swizzled (sw)
  int toks;    // [kStages][BN][kSlice] fp32 tokens, swizzled
  int raw;     // [kRawSlots][kRows][kRawRow] int8 rows as loaded (int8 tables)
  int bars;    // [kStages] mbarriers: the stage's loads have landed, then
               // [kRawSlots] the raw blocks'
  int list_v;  // [BN][k] running top-k values, (value desc, position asc)
  int list_p;  // [BN][k] their packed positions
  int g;       // [BN] gate value per token
  int z;       // [BN][kZPitch] a narrow tile's logits, as the top-k step reads them
  int live;    // [tiles_per_chunk] the chunk's row tiles with a real row
  int misc;    // [kMisc + kMaxK] scratch, then the first k real rows of a chunk
  int total;   // bytes to request, with 1 KB to align the base
  __host__ __device__ Layout(int BN, int k, int tiles_per_chunk, bool q) {
    rows = 0;
    toks = rows + 4 * (q ? 2 : kStages) * kRows * kSlice;
    raw = toks + 4 * kStages * BN * kSlice;
    bars = raw + (q ? kRawSlots * kRows * kRawRow : 0);
    list_v = bars + 8 * (kStages + (q ? kRawSlots : 0));
    list_p = list_v + 4 * BN * k;
    g = list_p + 4 * BN * k;
    z = g + 4 * BN;
    live = z + (BN <= kNarrow ? 4 * BN * kZPitch : 0);
    misc = live + 4 * tiles_per_chunk;
    total = misc + 4 * (kMisc + repro::kMaxK) + 1024;
  }
};

// Float dd of unit u (a row or a token) in a staged tile: 128-byte units
// whose 16-byte chunks sit XOR-swizzled by the unit's low 3 bits, as TMA's
// 128-byte swizzle stores them, so the 16-byte loads of 8 consecutive units
// at one d hit distinct banks.
__device__ __forceinline__ int sw(int u, int dd) { return u * kSlice + (dd ^ ((u & 7) << 2)); }

// Thread row i (tr: its row group) and thread token j (tt: its token group):
// a half-warp's 16 lanes hold all 128 rows of a tile for its tokens.
__device__ __forceinline__ int row_of(int tr, int i) { return tr + 16 * i; }
__device__ __forceinline__ int tok_of(int tt, int j) { return tt + 16 * j; }

// A (UNITS x kSlice) slice of rows of d elements (units n_units and beyond,
// elements past d: zero) one element at a time, widened to fp32, for what
// TMA cannot address (bf16 tokens, unaligned rows).
template <typename T, int UNITS>
__device__ __forceinline__ void copy_sync(float* dst, const T* __restrict__ src, int n_units,
                                          int d, int d0) {
  for (int q = threadIdx.x; q < UNITS * kSlice; q += kThreads) {
    const int u = q / kSlice, c = q % kSlice;
    const bool ok = u < n_units && d0 + c < d;
    dst[sw(u, c)] = ok ? repro::to_f32(src[static_cast<size_t>(u) * d + d0 + c]) : 0.f;
  }
}

// The 16-byte int8 chunks of a slice each thread widens (and, without TMA,
// copies): chunk q = threadIdx.x + kThreads * m is bytes 16 c to 16 c + 15
// of row q / kChunks, c = q % kChunks.
constexpr int kChunks = kSlice / 16;  // int8 chunks per row and stage
constexpr int kOwn = kRows * kChunks / kThreads;
static_assert(kRows * kChunks % kThreads == 0, "every thread owns whole int8 chunks");

// int8 rows one byte at a time into a raw stage, each thread the chunks
// that widen_rows widens (so no barrier is needed in between).
__device__ __forceinline__ void copy_sync_raw(int8_t* dst, const int8_t* __restrict__ src,
                                              int n_units, int d, int d0) {
#pragma unroll
  for (int m = 0; m < kOwn; ++m) {
    const int q = threadIdx.x + kThreads * m, u = q / kChunks, c = q % kChunks;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int dd = c * 16 + e;
      const bool ok = u < n_units && d0 + dd < d;
      dst[u * kSlice + dd] = ok ? src[static_cast<size_t>(u) * d + d0 + dd] : int8_t{0};
    }
  }
}

// int8 rows: this thread's chunks of one slice of raw rows (row pitch
// `pitch` bytes) widened exactly to fp32 rows (swizzled like the fp32 ones).
__device__ __forceinline__ void widen_rows(float* __restrict__ dst,
                                           const unsigned char* __restrict__ raw, int pitch) {
#pragma unroll
  for (int m = 0; m < kOwn; ++m) {
    const int q = threadIdx.x + kThreads * m, u = q / kChunks, c = q % kChunks;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + u * pitch + c * 16);
    const uint32_t word[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x[4];
      repro::unpack(word[e], x, int8_t{});
      *reinterpret_cast<float4*>(dst + sw(u, c * 16 + 4 * e)) = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// One ring stage's products: acc[i][j] += row i . token j over kSlice d, in
// d order, from 16-byte loads of four d. Rows tr + 16 i share tr's swizzle,
// tokens tt + 16 j tt's: one XOR per d step serves all of them. Tokens go
// in halves of 4 (48 operand registers live, not 64: the 8 x 8 micro-tile
// of int8 rows spilled), each FMA one d of one accumulator in turn, so
// consecutive FMAs are independent.
template <int NT>
__device__ __forceinline__ void product(float (&acc)[8][NT], const float* __restrict__ rows,
                                        const float* __restrict__ toks, int tr, int tt) {
  constexpr int NH = NT > 4 ? 2 : 1, NJ = NT / NH;  // token halves, tokens per half
  const float* rb = rows + tr * kSlice;
  const float* tb = toks + tt * kSlice;
  const int sr = (tr & 7) << 2, st = (tt & 7) << 2;
#pragma unroll
  for (int dq = 0; dq < kSlice; dq += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(rb + 16 * i * kSlice + (dq ^ sr));
    const float* af = reinterpret_cast<const float*>(a);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float4 b[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        b[jj] = *reinterpret_cast<const float4*>(tb + 16 * (h * NJ + jj) * kSlice + (dq ^ st));
      const float* bf = reinterpret_cast<const float*>(b);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            acc[i][h * NJ + jj] = fmaf(af[4 * i + c], bf[4 * jj + c], acc[i][h * NJ + jj]);
    }
  }
}

// Token tiles of BN <= kNarrow: each warp takes 8 rows (and the same 8
// plus 64) by 4 groups of tokens, thread (rg, tl) rows rg and rg + 64 and
// tokens 4 j + tl, so a row's 16-byte load serves 4 lanes and every warp
// reads other rows (the wide mapping makes each of 16 token groups read
// all 128 rows, for one or two tokens). The accumulators hold the
// (row r2, token j) sum at flat index r2 * BN / 4 + j.
__device__ __forceinline__ int narrow_row(int r2) {
  return threadIdx.x % 8 + 8 * (threadIdx.x / 32) + 64 * r2;
}
__device__ __forceinline__ int narrow_tok(int j) { return 4 * j + (threadIdx.x % 32) / 8; }

template <int NT>
__device__ __forceinline__ void product_narrow(float (&acc)[8][NT], const float* __restrict__ rows,
                                               const float* __restrict__ toks) {
  constexpr int TN = 4 * NT;  // tokens per thread: BN / 4
  float* flat = &acc[0][0];
  // swizzles: rows narrow_row(r2) share theirs; tokens 4 j + tl alternate two
  const int lane = threadIdx.x % 32, sr = (lane & 7) << 2;
  const int st0 = (lane / 8) << 2, st1 = (4 + lane / 8) << 2;
  const float* rb = rows + narrow_row(0) * kSlice;
  const float* tb = toks + (lane / 8) * kSlice;
#pragma unroll
  for (int dq = 0; dq < kSlice; dq += 4) {
    float4 a[2], b[TN];
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2)
      a[r2] = *reinterpret_cast<const float4*>(rb + 64 * r2 * kSlice + (dq ^ sr));
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = *reinterpret_cast<const float4*>(tb + 4 * j * kSlice + (dq ^ ((j & 1) ? st1 : st0)));
    const float* af = reinterpret_cast<const float*>(a);
    const float* bf = reinterpret_cast<const float*>(b);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          flat[r2 * TN + j] = fmaf(af[4 * r2 + c], bf[4 * j + c], flat[r2 * TN + j]);
  }
}

// A narrow tile's sums through shared memory into the top-k step's layout
// (acc[i][j]: row row_of(tr, i), token tok_of(tt, j)). Every thread calls
// it; it holds a block barrier.
template <int NT>
__device__ __forceinline__ void narrow_to_rows(float (&acc)[8][NT], float* z, int tr, int tt) {
  constexpr int TN = 4 * NT;
  float* flat = &acc[0][0];
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
    for (int j = 0; j < TN; ++j) z[narrow_tok(j) * kZPitch + narrow_row(r2)] = flat[r2 * TN + j];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j] = z[tok_of(tt, j) * kZPitch + row_of(tr, i)];
}

// The 16 lanes of a half-warp insert (v, p) into one token's sorted list of
// k entries where `ins` holds (uniform over the half-warp); every lane of
// the warp calls it. Lane hl moves entries hl, hl + 16, ...
__device__ __forceinline__ void insert_half(float* lv, int* lp, int k, float v, int p, bool ins,
                                            int hl, unsigned half) {
  float cv[4], pv[4];
  int cp[4], pp[4];
  int at = 0;  // entries that stay before (v, p)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (16 * q >= k) break;  // uniform
    const int e = hl + 16 * q;
    bool stays = false;
    if (ins && e < k) {
      cv[q] = lv[e];
      cp[q] = lp[e];
      pv[q] = e > 0 ? lv[e - 1] : 0.f;
      pp[q] = e > 0 ? lp[e - 1] : 0;
      stays = before(cv[q], cp[q], v, p);
    }
    at += __popc(__ballot_sync(kFull, stays) & half);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = hl + 16 * q;
    if (ins && e < k && e >= at) {
      lv[e] = e == at ? v : pv[q];
      lp[e] = e == at ? p : pp[q];
    }
  }
  __syncwarp();
}

// Order-preserving int keys of floats (key 0: none yet), for atomicMax.
__device__ __forceinline__ unsigned float_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_float(unsigned key) {
  return key == 0u ? -CUDART_INF_F
                   : __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// One row tile's top-k step on the accumulators (rows v0 + row_of(tr, i),
// those at or past v_hi left out): z = acc x scale (int8 rows) x g, padding
// -1e9; a value goes on only if it beats its token's k-th entry and is not
// below the token's bound from the chunks already done (low). Then each
// token's half-warp moves those values into its list, best first, one per
// round for all NT tokens of the thread at once (independent shuffles),
// until the best one left of every token no longer beats its k-th entry.
// Every lane of the block calls it.
template <int NT, bool Q>
__device__ __forceinline__ void topk_step(float (&acc)[8][NT], const int* __restrict__ idp,
                                          const float* __restrict__ scp, const float* gs,
                                          const unsigned* low, float* lv_all, int* lp_all,
                                          int v0, int v_hi, int n_tok, int k, int tr, int tt,
                                          unsigned half) {
  int pos[8];
  bool in[8];
  float g[NT], lo[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int t = tok_of(tt, j);
    g[j] = gs[t];
    lo[j] = t < n_tok ? key_float(__ldcg(low + t)) : -CUDART_INF_F;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    pos[i] = v0 + row_of(tr, i);
    in[i] = pos[i] < v_hi;
    const int id = in[i] ? idp[pos[i]] : -1;
    const float sc = (Q && in[i]) ? scp[pos[i]] : 1.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float z = acc[i][j];
      if (Q) z *= sc;
      z *= g[j];
      acc[i][j] = id < 0 ? repro::kNegInfMask : z;
    }
  }
  uint32_t m[NT];  // bit i of m[j]: row i still goes on for token j
  bool any = false;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int t = tok_of(tt, j);
    m[j] = 0u;
    if (t < n_tok) {
      const float kv = lv_all[t * k + k - 1];
      const int kp = lp_all[t * k + k - 1];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        m[j] |= static_cast<uint32_t>(in[i] && acc[i][j] >= lo[j] &&
                                      before(acc[i][j], pos[i], kv, kp))
                << i;
    }
    any |= m[j] != 0u;
  }
  while (__any_sync(kFull, any)) {
    float bv[NT];
    int bp[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      bv[j] = -CUDART_INF_F;
      bp[j] = kNoPos;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (((m[j] >> i) & 1u) && before(acc[i][j], pos[i], bv[j], bp[j])) {
          bv[j] = acc[i][j];
          bp[j] = pos[i];
        }
    }
    bool act[NT];  // tokens some lane of the warp still holds values for
#pragma unroll
    for (int j = 0; j < NT; ++j) act[j] = __any_sync(kFull, m[j] != 0u);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (act[j]) {
          const float ov = __shfl_xor_sync(kFull, bv[j], off);
          const int op = __shfl_xor_sync(kFull, bp[j], off);
          if (before(ov, op, bv[j], bp[j])) {
            bv[j] = ov;
            bp[j] = op;
          }
        }
    any = false;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // the half-warp's best candidate, against the k-th entry as it is now
      const int t = tok_of(tt, j);
      float* lv = lv_all + t * k;
      int* lp = lp_all + t * k;
      const bool ins = act[j] && bp[j] != kNoPos && before(bv[j], bp[j], lv[k - 1], lp[k - 1]);
      if (__any_sync(kFull, ins)) insert_half(lv, lp, k, bv[j], bp[j], ins, tr, half);
      if (ins) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (pos[i] == bp[j]) m[j] &= ~(1u << i);
      } else {
        m[j] = 0u;  // the best one left does not reach the list: none does
      }
      any |= m[j] != 0u;
    }
  }
}

// Persistent blocks pull work items (vocab chunk, expert, token tile of BN
// slots) from *next_item and write each token's top-k (value, class id) of
// the chunk to out (nchunk, K, C, k) at the chunk (out (K, C, k) when
// nchunk is 1). TX: token type, TW: row type. TMA: fp32 rows (tw: (d,
// v_pad, K), box (32, 128, 1)) and fp32 tokens (tx: (d, C, K), box (32, BN,
// 1)) arrive by TMA with the 128-byte swizzle, int8 rows (tw: box (128,
// 128, 1), 4 slices) unswizzled; else (bf16 tokens, unaligned data)
// everything one element at a time, and tw, tx are unused.
template <typename TX, typename TW, int BN, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
tiled_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
             const TX* __restrict__ buf, const float* __restrict__ g_buf,
             const TW* __restrict__ w, const int* __restrict__ ids,
             const float* __restrict__ scales, float* __restrict__ out_v,
             int* __restrict__ out_i, int* __restrict__ next_item, unsigned* __restrict__ lows,
             int K, int C, int v_pad, int d, int k, int tiles_per_chunk, int big_tiles,
             int nchunk) {
  constexpr int NT = BN / 16;
  constexpr bool Q = std::is_same<TW, int8_t>::value;
  constexpr uint32_t kStageBytes = (Q ? 0 : kRows * kSlice * 4) + BN * kSlice * 4;
  constexpr uint32_t kRawBytes = kRows * kRawRow;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_base = repro::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw_base + 1023u) & ~1023u) - raw_base);
  const Layout L(BN, k, tiles_per_chunk, Q);
  float* rows = reinterpret_cast<float*>(smem + L.rows);
  float* toks = reinterpret_cast<float*>(smem + L.toks);
  unsigned char* raw = smem + L.raw;
  const uint32_t bars = repro::smem_u32(smem + L.bars);
  float* lv_all = reinterpret_cast<float*>(smem + L.list_v);
  int* lp_all = reinterpret_cast<int*>(smem + L.list_p);
  float* gs = reinterpret_cast<float*>(smem + L.g);
  float* zs = reinterpret_cast<float*>(smem + L.z);
  int* live = reinterpret_cast<int*>(smem + L.live);
  int* misc = reinterpret_cast<int*>(smem + L.misc);
  int* first_real = misc + kMisc;
  if (TMA && threadIdx.x == 0) {
    for (int s = 0; s < kStages + (Q ? kRawSlots : 0); ++s)
      repro::mbar_init(bars + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int done = 0;      // ring stages this block has used, over its items: slot and phase
  int raw_done = 0;  // raw int8 blocks likewise

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tr = lane % 16, tt = 2 * warp + lane / 16;
  const unsigned half = 0xffffu << (16 * (lane / 16));
  const int token_tiles = (C + BN - 1) / BN;
  const int n_items = nchunk * K * token_tiles;
  const int n_sl = (d + kSlice - 1) / kSlice;
  const int row_tiles = (v_pad + kRows - 1) / kRows;

  for (int round = 0;; ++round) {
    if (tid == 0) misc[round & 1] = atomicAdd(next_item, 1);
    __syncthreads();
    const int item = misc[round & 1];
    if (item >= n_items) break;
    // consecutive items: the token tiles of one (chunk, expert), which read
    // the same rows
    const int e = (item / token_tiles) % K, ch = item / (token_tiles * K);
    const int t0 = (item % token_tiles) * BN, n_tok = min(BN, C - t0);
    // chunks of tiles_per_chunk row tiles up to big_tiles, then one tile
    // each: the last items pulled are short, so the SMs finish together
    const int n_big = (big_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
    const int tile_lo = ch < n_big ? ch * tiles_per_chunk : big_tiles + (ch - n_big);
    const int n_tiles =
        ch < n_big ? min(tiles_per_chunk, big_tiles - tile_lo) : min(1, row_tiles - tile_lo);
    const int v_lo = tile_lo * kRows, v_hi = min(v_pad, v_lo + n_tiles * kRows);
    const int* idp = ids + static_cast<size_t>(e) * v_pad;
    const float* scp = Q ? scales + static_cast<size_t>(e) * v_pad : nullptr;
    const size_t out_row = (static_cast<size_t>(nchunk > 1 ? ch : 0) * K + e) * C + t0;
    unsigned* low = lows + static_cast<size_t>(e) * C + t0;

    float gv = 0.f;
    if (tid < BN) {
      gv = tid < n_tok ? g_buf[static_cast<size_t>(e) * C + t0 + tid] : 0.f;
      gs[tid] = gv;
    }
    if (!__syncthreads_or(gv != 0.f)) {
      // No live slot: for finite rows and tokens every real row scores
      // x . w * 0 = +-0 (a tie) and padding -1e9, so each slot gets (0, id)
      // on the chunk's first k real rows, then (-1e9, -1) while the chunk
      // has rows, then (-inf, -1) (the merge keeps chunks in order).
      if (tid == 0) misc[3] = 0;
      __syncthreads();
      for (int base = v_lo; base < v_hi; base += kThreads) {
        const int found = misc[3];
        if (found >= k) break;
        const int v = base + tid;
        const bool real = v < v_hi && idp[v] >= 0;
        const unsigned bal = __ballot_sync(kFull, real);
        if (lane == 0) misc[4 + warp] = __popc(bal);
        __syncthreads();
        int ahead = 0, total = 0;
        for (int x = 0; x < kThreads / 32; ++x) {
          ahead += x < warp ? misc[4 + x] : 0;
          total += misc[4 + x];
        }
        const int idx = found + ahead + __popc(bal & ((1u << lane) - 1u));
        if (real && idx < k) first_real[idx] = v;
        __syncthreads();
        if (tid == 0) misc[3] = found + total;
        __syncthreads();
      }
      const int n_real = min(misc[3], k), n_rows = v_hi - v_lo;
      for (int i = tid; i < n_tok * k; i += kThreads) {
        const int t = i / k, j = i % k;
        const size_t o = (out_row + t) * k + j;
        out_v[o] = j < n_real ? 0.f : (j < n_rows ? repro::kNegInfMask : -CUDART_INF_F);
        out_i[o] = j < n_real ? idp[first_real[j]] : -1;
      }
      continue;
    }

    // the chunk's row tiles that hold a real row, in order
    for (int i = tid; i < n_tiles; i += kThreads) live[i] = 0;
    for (int i = tid; i < BN * k; i += kThreads) {
      lv_all[i] = -CUDART_INF_F;
      lp_all[i] = kNoPos;
    }
    __syncthreads();
    for (int v = v_lo + tid; v < v_hi; v += kThreads)
      if (idp[v] >= 0) live[(v - v_lo) / kRows] = 1;
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int i = 0; i < n_tiles; ++i)
        if (live[i]) live[n++] = i;
      misc[2] = n;
    }
    __syncthreads();
    const int n_live = misc[2];

    // The ring: stage st holds d slice st % n_sl of live tile st / n_sl;
    // kStages - 1 of them are in flight while the block multiplies one.
    const int steps = n_live * n_sl;
    // int8 rows (TMA): raw block j of live tile t holds slices 4 j to 4 j + 3;
    // block b = t * n_blk + j goes to slot (raw_done + b) % kRawSlots
    const int n_blk = (n_sl + kRawSlices - 1) / kRawSlices;
    const int n_raw = n_live * n_blk;
    const uint32_t raw_bars = bars + 8u * kStages;
    auto issue_raw = [&](int blk) {
      if (Q && threadIdx.x == 0 && blk < n_raw) {
        const int slot = (raw_done + blk) % kRawSlots;
        const uint32_t bar = raw_bars + 8u * slot;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        repro::mbar_expect_tx(bar, kRawBytes);
        repro::tma_load_3d(repro::smem_u32(raw + slot * kRows * kRawRow), &tw, bar,
                           (blk % n_blk) * kRawRow, v_lo + live[blk / n_blk] * kRows, e);
      }
    };
    auto issue = [&](int st) {
      if (st >= steps) return;
      const int v0 = v_lo + live[st / n_sl] * kRows, d0 = (st % n_sl) * kSlice;
      const int slot = (done + st) % kStages;
      float* xd = toks + slot * BN * kSlice;
      unsigned char* rd = Q ? raw + slot * kRows * kSlice
                            : reinterpret_cast<unsigned char*>(rows + slot * kRows * kSlice);
      if constexpr (TMA) {
        if (threadIdx.x == 0) {
          // the slot was last read by ordinary loads; TMA writes it next
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          const uint32_t bar = bars + 8u * slot;
          repro::mbar_expect_tx(bar, kStageBytes);
          if constexpr (!Q) repro::tma_load_3d(repro::smem_u32(rd), &tw, bar, d0, v0, e);
          repro::tma_load_3d(repro::smem_u32(xd), &tx, bar, d0, t0, e);
        }
      } else {
        const TW* ws = w + (static_cast<size_t>(e) * v_pad + v0) * d;
        const int n_rows = min(kRows, v_hi - v0);
        if constexpr (Q)
          copy_sync_raw(reinterpret_cast<int8_t*>(rd), ws, n_rows, d, d0);
        else
          copy_sync<TW, kRows>(reinterpret_cast<float*>(rd), ws, n_rows, d, d0);
        copy_sync<TX, BN>(xd, buf + (static_cast<size_t>(e) * C + t0) * d, n_tok, d, d0);
      }
    };

    float acc[8][NT];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j] = 0.f;
    if constexpr (TMA && Q)
      for (int blk = 0; blk < kRawSlots - 1; ++blk) issue_raw(blk);
    for (int st = 0; st < kStages - 1; ++st) issue(st);
    for (int st = 0; st < steps; ++st) {
      const int slot = (done + st) % kStages;
      const int sl = st % n_sl, blk = (st / n_sl) * n_blk + sl / kRawSlices;
      if constexpr (TMA) repro::mbar_wait(bars + 8u * slot, ((done + st) / kStages) & 1);
      if constexpr (TMA && Q) {
        const int rs = (raw_done + blk) % kRawSlots;
        if (sl % kRawSlices == 0)  // the block's first slice: it has landed
          repro::mbar_wait(raw_bars + 8u * rs, ((raw_done + blk) / kRawSlots) & 1);
        widen_rows(rows + (st & 1) * kRows * kSlice,
                   raw + rs * kRows * kRawRow + (sl % kRawSlices) * kSlice, kRawRow);
      } else if constexpr (Q) {
        widen_rows(rows + (st & 1) * kRows * kSlice, raw + slot * kRows * kSlice, kSlice);
      }
      __syncthreads();  // stage st complete; stage st - 1 no longer read
      // a raw block is refilled once its last slice is widened: at the first
      // slice of the next block
      if (TMA && Q && sl % kRawSlices == 0) issue_raw(blk + kRawSlots - 1);
      issue(st + kStages - 1);
      const float* rs = rows + (Q ? st & 1 : slot) * kRows * kSlice;
      const float* xs = toks + slot * BN * kSlice;
      if constexpr (BN <= kNarrow)
        product_narrow<NT>(acc, rs, xs);
      else
        product<NT>(acc, rs, xs, tr, tt);
      if (st % n_sl == n_sl - 1) {
        if constexpr (BN <= kNarrow) narrow_to_rows<NT>(acc, zs, tr, tt);
        topk_step<NT, Q>(acc, idp, scp, gs, low, lv_all, lp_all,
                         v_lo + live[st / n_sl] * kRows, v_hi, n_tok, k, tr, tt, half);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) acc[i][j] = 0.f;
      }
    }
    done += steps;
    raw_done += Q ? n_raw : 0;
    // the tiles of padding alone: every row -1e9 (the mask ignores acc)
    for (int i = 0, li = 0; i < n_tiles; ++i) {
      if (li < n_live && live[li] == i) {
        ++li;
        continue;
      }
      topk_step<NT, Q>(acc, idp, scp, gs, low, lv_all, lp_all, v_lo + i * kRows, v_hi, n_tok,
                       k, tr, tt, half);
    }
    __syncthreads();
    for (int i = tid; i < n_tok * k; i += kThreads) {
      const int t = i / k, j = i % k;
      const size_t o = (out_row + t) * k + j;
      const int p = lp_all[t * k + j];
      out_v[o] = lv_all[t * k + j];
      out_i[o] = p == kNoPos ? -1 : idp[p];
    }
    // a full list's k-th value bounds the slot's top k from below: the
    // chunks still to come drop what lies under it
    if (nchunk > 1 && tid < n_tok && lp_all[tid * k + k - 1] != kNoPos)
      atomicMax(low + tid, float_key(lv_all[tid * k + k - 1]));
  }
}

struct Args {
  const void *buf, *w;
  const float* g_buf;
  const int* ids;
  const float* scales;
  float *out_v, *part_v;
  int *out_i, *part_i, *next_item;
  unsigned* lows;
  int K, C, v_pad, d, k, tiles_per_chunk, big_tiles, nchunk;
  cudaStream_t stream;
};

template <typename TX, typename TW, int BN, bool TMA>
cudaError_t launch(const Args& a) {
  constexpr bool Q = std::is_same<TW, int8_t>::value;
  const int smem = Layout(BN, a.k, a.tiles_per_chunk, Q).total;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  CUtensorMap mw{}, mx{};
  cudaError_t err = cudaSuccess;
  if constexpr (TMA) {
    err = Q ? make_map(&mw, a.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.d, a.v_pad, a.K, kRawRow,
                       kRows, CU_TENSOR_MAP_SWIZZLE_NONE)
            : make_map(&mw, a.w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.d, a.v_pad, a.K, kSlice,
                       kRows, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = make_map(&mx, a.buf, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.d, a.C, a.K, kSlice, BN,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  }
  auto kern = tiled_kernel<TX, TW, BN, TMA>;
  if (err == cudaSuccess) err = repro::smem_limit_once(reinterpret_cast<const void*>(kern), smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.next_item, 0, sizeof(int), a.stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(a.lows, 0, sizeof(unsigned) * a.K * a.C, a.stream);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(a.nchunk) * a.K * ((a.C + BN - 1) / BN);
  const int grid = static_cast<int>(std::min<long long>(items, 1LL * sms * std::max(per_sm, 1)));
  float* dst_v = a.nchunk > 1 ? a.part_v : a.out_v;
  int* dst_i = a.nchunk > 1 ? a.part_i : a.out_i;
  kern<<<grid, kThreads, smem, a.stream>>>(
      mw, mx, static_cast<const TX*>(a.buf), a.g_buf, static_cast<const TW*>(a.w), a.ids,
      a.scales, dst_v, dst_i, a.next_item, a.lows, a.K, a.C, a.v_pad, a.d, a.k,
      a.tiles_per_chunk, a.big_tiles, a.nchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nchunk == 1) return err;
  return repro::launch_merge(a.part_v, a.part_i, a.out_v, a.out_i, a.K * a.C, a.k, a.nchunk,
                             a.stream);
}

template <typename TX, typename TW, bool TMA>
cudaError_t launch_n(int n_tile, const Args& a) {
  switch (n_tile) {
    case 16: return launch<TX, TW, 16, TMA>(a);
    case 32: return launch<TX, TW, 32, TMA>(a);
    case 64: return launch<TX, TW, 64, TMA>(a);
    case 128: return launch<TX, TW, 128, TMA>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt

// ---- the decode body ------------------------------------------------------

using repro::stream::SlotTokens;

struct StreamArgs {
  const void *buf, *w;
  const float* g_buf;
  const int* ids;
  const float* scales;
  float *out_v, *part_v;
  int *out_i, *part_p, *n_sel;
  int K, C, v_pad, d, k, grid, vb;
  cudaStream_t stream;
};

template <typename TX, typename TW, int VB>
cudaError_t launch_stream(const StreamArgs& a) {
  const SlotTokens<TX> src{static_cast<const TX*>(a.buf), a.g_buf, a.K, a.C};
  return repro::stream::launch_retrieve<SlotTokens<TX>, TW, VB>(
      src, static_cast<const TW*>(a.w), a.ids, a.scales, a.part_v, a.part_p, a.n_sel, a.out_v,
      a.out_i, a.K * a.C, a.K, a.v_pad, a.d, a.k, a.grid, a.stream);
}

// Row vectors of VB bytes: 16 or 4, or one element.
template <typename TX, typename TW>
cudaError_t stream_vb(const StreamArgs& a) {
  if (a.vb == 16) return launch_stream<TX, TW, 16>(a);
  if (a.vb == 4) return launch_stream<TX, TW, 4>(a);
  if constexpr (sizeof(TW) < 4) {
    if (a.vb == static_cast<int>(sizeof(TW)))
      return launch_stream<TX, TW, static_cast<int>(sizeof(TW))>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t stream_w(int wdtype, const StreamArgs& a) {
  if (wdtype == repro::kDtypeI8) {
    if (a.scales == nullptr) return cudaErrorInvalidValue;
    return stream_vb<TX, int8_t>(a);
  }
  if (a.scales != nullptr) return cudaErrorInvalidValue;
  return stream_vb<TX, TX>(a);
}

// ---- the tensor-core body (bf16 tokens, prefill capacities) ---------------

namespace wg {

constexpr int kRows = 128;                 // vocab rows per tile: 64 per consumer warpgroup
constexpr int kSlice = 64;                 // d elements per ring stage (128 bytes of bf16)
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kWarps = kConsumers / 32;    // consumer warps: 16 rows of a tile each
constexpr int kThreads = kConsumers + 128; // + the producer warpgroup
// Registers per thread after setmaxnreg. The launch gives every thread 168
// (65,536 / 384, in steps of 8), and the consumers can take only what the
// producer warpgroup gives up: 128 x (168 - 40) = 256 x (232 - 168). The
// consumers hold N / 2 fp32 accumulators (128 at N 256) beside the filter.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kQueue = 16;                 // queue slots per token in shared memory
constexpr int kSpill = kRows - kQueue;     // the rest of a tile's rows, in device memory
constexpr int kSeedK = 16;                 // the first tile's threshold serves k up to this
constexpr int kRegK = 8;                   // a list being merged sits in registers up to this k

__host__ __device__ constexpr int row_tile_bytes(bool q) { return kRows * kSlice * (q ? 1 : 2); }

// Byte offsets from the 1024-aligned base of the dynamic shared memory.
struct Layout {
  int stage;   // bytes of one ring stage: the row tile, then the token tile
  int bars;    // full[stages], empty[stages]
  int thr;     // [N] each token's threshold (value, position bound): a
               // candidate beats it; from its list's k-th entry
  int lob;     // [N] the bound on u that the threshold implies (u_bound)
  int list;    // [k][N] the token's top-k keys, largest first (slot-major: the
               // threads of consecutive tokens hit consecutive banks)
  int queue;   // [kQueue][N] the tile's candidates (value, position); the
               // first tile's seed scratch before that
  int cnt;     // [N] candidates of the tile
  int g;       // [N] gate value per token
  int total;   // bytes to request, with 1 KB to align the base
  __host__ __device__ Layout(int N, int k, int stages, bool q) {
    stage = row_tile_bytes(q) + N * kSlice * 2;
    bars = stages * stage;
    thr = bars + 16 * stages;
    lob = thr + 8 * N;
    list = lob + 4 * N;
    queue = list + 8 * N * k;
    cnt = queue + 8 * kQueue * N;
    g = cnt + 4 * N;
    total = g + 4 * N + 1024;
  }
};

using repro::bar_sync;

// A list entry as one 64-bit key: the value's bits made order-preserving
// (both zeros alike, as the float compare has them), then the complement
// of its packed position, so a larger key comes first in the list order
// (value desc, position asc) and one compare decides.
__device__ __forceinline__ uint64_t key_of(float v, int pos) {
  const uint32_t u = v == 0.f ? 0u : __float_as_uint(v);
  const uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(o) << 32) | (0xffffffffu - static_cast<uint32_t>(pos));
}
__device__ __forceinline__ float key_value(uint64_t key) {
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
__device__ __forceinline__ int key_pos(uint64_t key) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
}

// A bound on u (a row's value before x g) below which z = u x g cannot
// reach the threshold value tv: for g > 0 rounding keeps the order, and the
// margins (relative 2^-20, absolute 2^-100 / g) cover the roundings of z
// and of the bound itself (tv x 1/g, each rounded once), underflow to zero
// included. Empty slots (g 0) admit nothing; g < 0 leaves every row to the
// exact compare.
__device__ __forceinline__ float u_bound(float tv, float g) {
  if (!(g > 0.f)) return g == 0.f ? CUDART_INF_F : -CUDART_INF_F;
  const float r = __frcp_rn(g), q = tv * r;
  return q - fabsf(q) * 0x1p-20f - 0x1p-100f * r;
}

// Insert key x into a sorted list of k keys, entry j at l[j * S].
template <int S>
__device__ __forceinline__ void insert_key(uint64_t* l, int k, uint64_t x) {
  if (x <= l[(k - 1) * S]) return;
  int j = k - 1;
  while (j > 0 && x > l[(j - 1) * S]) {
    l[j * S] = l[(j - 1) * S];
    --j;
  }
  l[j * S] = x;
}

// A token's list in registers while one thread inserts a tile's candidates
// into it (k up to kRegK): each insertion is a fixed chain of compares and
// selects instead of a chain of dependent shared-memory loads. Entries past
// k hold 0 (below every key) or keys pushed out of the first k; only the
// first k are stored back.
struct RegKeys {
  uint64_t v[kRegK];
  __device__ __forceinline__ void insert(uint64_t x) {
#pragma unroll
    for (int j = kRegK - 1; j >= 0; --j) {
      const uint64_t above = v[j > 0 ? j - 1 : 0];
      v[j] = (j > 0 && x > above) ? above : (x > v[j] ? x : v[j]);
    }
  }
};

// Wait for a barrier's phase with the thread suspended in hardware until
// it completes (a time hint of 10 ms a try): a wait that spins takes issue
// slots and shared-memory bandwidth from the warps that work meanwhile.
__device__ __forceinline__ void mbar_sleep(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1, %2;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity), "r"(10000000u)
      : "memory");
}

// The m64k16 A fragments of the four k16 slices of one stage for this
// thread's rows row0 and row0 + 8 of the (128 x 64) int8 row tile, widened
// exactly to bf16: a[kk] = {(row0, k 2q, 2q+1), (row0+8, ...), (row0, k
// 8+2q, 9+2q), (row0+8, ...)} of slice kk, q = lane % 4.
__device__ __forceinline__ void int8_fragments(uint32_t (&a)[4][4],
                                               const unsigned char* tile, int row0, int q) {
  const uint32_t sel = (q & 1) ? 0x7632u : 0x5410u;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const unsigned char* r = tile + (row0 + 8 * rr) * kSlice;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint4 v = *reinterpret_cast<const uint4*>(r + 16 * kk);
      const uint32_t lo = (q & 2) ? v.y : v.x;  // bytes 2q, 2q + 1 of the slice
      const uint32_t hi = (q & 2) ? v.w : v.z;  // bytes 8 + 2q, 9 + 2q
      float x[4];
      repro::unpack(__byte_perm(lo, hi, sel), x, int8_t{});
      a[kk][rr] = repro::pack_bf16(x[0], x[1]);
      a[kk][2 + rr] = repro::pack_bf16(x[2], x[3]);
    }
  }
}

// One block per (vocab split blockIdx.x, token tile blockIdx.y, expert
// blockIdx.z); writes the split's top-k (value, class id) of each token of
// the tile to out (nsplit, K, C, k) at split blockIdx.x. spill: N x kSpill
// (value, position) pairs per block, a token's candidates in a tile past its
// kQueue slots.
template <int N, bool Q>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
             const float* __restrict__ g_buf, const int* __restrict__ ids,
             const float* __restrict__ scales, float* __restrict__ out_v,
             int* __restrict__ out_i, float2* __restrict__ spill, int K, int C, int v_pad,
             int d, int k, int tiles_per_split, int stages) {
  constexpr int NA = N / 2;  // accumulator registers per thread
  // int8 rows at token tiles of 128 and more: the next stage's fragments
  // are widened while this stage's products run (two fragment buffers, one
  // group in flight), over an even number of slices (the last zero fill
  // past d). At narrower tiles (the verify heads) widening in series
  // measured faster.
  constexpr bool kPipe = Q && N >= 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = repro::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const Layout L(N, k, stages, Q);
  auto full = [&](int s) { return base + L.bars + 8u * s; };
  auto empty = [&](int s) { return base + L.bars + 8u * (stages + s); };
  float2* thr = reinterpret_cast<float2*>(sm + L.thr);
  float* lob = reinterpret_cast<float*>(sm + L.lob);
  uint64_t* lst = reinterpret_cast<uint64_t*>(sm + L.list);
  float2* que = reinterpret_cast<float2*>(sm + L.queue);
  int* cnt = reinterpret_cast<int*>(sm + L.cnt);
  float* gs = reinterpret_cast<float*>(sm + L.g);

  const int sp = blockIdx.x, t0 = blockIdx.y * N, e = blockIdx.z;
  const int n_tok = min(N, C - t0);
  const int v_lo = sp * tiles_per_split * kRows;
  const int v_hi = min(v_pad, v_lo + tiles_per_split * kRows);
  const int n_tiles = v_hi > v_lo ? (v_hi - v_lo + kRows - 1) / kRows : 0;
  const int n_sl = kPipe ? (d + 2 * kSlice - 1) / (2 * kSlice) * 2 : (d + kSlice - 1) / kSlice;
  const int steps = n_tiles * n_sl;
  const int* idp = ids + static_cast<size_t>(e) * v_pad;
  spill += ((static_cast<size_t>(e) * gridDim.y + blockIdx.y) * gridDim.x + sp) * N * kSpill;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      repro::mbar_init(full(s), 1);
      repro::mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // A threshold (v, b) admits z > v, and z == v at a position below b.
  // Empty slots and slots past C admit nothing (+inf); the rest everything.
  for (int t = threadIdx.x; t < N; t += kThreads) {
    const float g = t < n_tok ? g_buf[static_cast<size_t>(e) * C + t0 + t] : 0.f;
    gs[t] = g;
    thr[t] = make_float2(g != 0.f ? -CUDART_INF_F : CUDART_INF_F, 0.f);
    lob[t] = u_bound(thr[t].x, g);
  }
  for (int i = threadIdx.x; i < N; i += kThreads) cnt[i] = 0;
  const uint64_t none = key_of(-CUDART_INF_F, kNoPos);
  for (int i = threadIdx.x; i < N * k; i += kThreads) lst[i] = none;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // -- one lane issues every TMA load ------------------------------------
    if (warp == kWarps && lane == 0) {
      const uint32_t bytes = L.stage;
      for (int st = 0; st < steps; ++st) {
        const int s = st % stages;
        if (st >= stages) mbar_sleep(empty(s), ((st / stages) - 1) & 1);
        repro::mbar_expect_tx(full(s), bytes);
        const int tile = st / n_sl, sl = st % n_sl;
        const uint32_t dst = base + s * L.stage;
        repro::tma_load_3d(dst, &tw, full(s), sl * kSlice, v_lo + tile * kRows, e);
        repro::tma_load_3d(dst + row_tile_bytes(Q), &tx, full(s), sl * kSlice, t0, e);
      }
    }
    return;
  }

  // -- consumers: warpgroup wgi owns rows 64 wgi .. 64 wgi + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wgi = warp / 4, q4 = lane % 4;
  const int row0 = 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8

  for (int tile = 0; tile < n_tiles; ++tile) {
    int pos[2];
    bool in[2], masked[2];
    float mask_val[2], sc[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      pos[rr] = v_lo + tile * kRows + row0 + 8 * rr;
      in[rr] = pos[rr] < v_hi;
      masked[rr] = !in[rr] || idp[pos[rr]] < 0;
      mask_val[rr] = in[rr] ? repro::kNegInfMask : -CUDART_INF_F;
      sc[rr] = (Q && in[rr]) ? scales[static_cast<size_t>(e) * v_pad + pos[rr]] : 1.f;
    }
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;

    if constexpr (kPipe) {
      uint32_t fa[4][4], fb[4][4];
      auto widen = [&](uint32_t (&f)[4][4], int sl) {
        const int st = tile * n_sl + sl, s = st % stages;
        repro::mbar_wait(full(s), (st / stages) & 1);
        int8_fragments(f, sm + s * L.stage, row0, q4);
      };
      auto issue = [&](uint32_t (&f)[4][4], int sl) {
        const uint32_t toks = base + ((tile * n_sl + sl) % stages) * L.stage + row_tile_bytes(Q);
        repro::fence_regs(acc);
        repro::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          repro::Mma<N>::rs(acc, f[kk], repro::sw128_desc(toks + kk * 32), sl > 0 || kk > 0);
        repro::wgmma_commit();
        repro::wgmma_wait<1>();  // the previous stage's products are done
        repro::fence_regs(acc);
      };
      auto retire = [&](int sl) { repro::mbar_arrive(empty((tile * n_sl + sl) % stages)); };
      widen(fa, 0);
      for (int sl = 0; sl < n_sl; sl += 2) {
        issue(fa, sl);
        if (sl > 0) retire(sl - 1);
        widen(fb, sl + 1);
        issue(fb, sl + 1);
        retire(sl);
        if (sl + 2 < n_sl) widen(fa, sl + 2);
      }
      repro::wgmma_wait<0>();
      repro::fence_regs(acc);
      retire(n_sl - 1);
    } else {
      int prev = -1;
      for (int sl = 0; sl < n_sl; ++sl) {
        const int st = tile * n_sl + sl, s = st % stages;
        mbar_sleep(full(s), (st / stages) & 1);
        const uint32_t rows = base + s * L.stage, toks = rows + row_tile_bytes(Q);
        // Every k16 slice is issued, past d too (zero fill, zero products):
        // a product under a branch would make ptxas serialize them all.
        if constexpr (Q) {
          uint32_t a[4][4];
          int8_fragments(a, sm + s * L.stage, row0, q4);
          repro::fence_regs(acc);
          repro::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            repro::Mma<N>::rs(acc, a[kk], repro::sw128_desc(toks + kk * 32), sl > 0 || kk > 0);
          repro::wgmma_commit();
          repro::wgmma_wait<0>();
          repro::fence_regs(acc);
          repro::mbar_arrive(empty(s));
        } else {
          const uint32_t a0 = rows + wgi * 64 * 128;
          repro::fence_regs(acc);
          repro::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            repro::Mma<N>::ss(acc, repro::sw128_desc(a0 + kk * 32),
                              repro::sw128_desc(toks + kk * 32), sl > 0 || kk > 0);
          repro::wgmma_commit();
          repro::wgmma_wait<1>();  // the previous stage's products are done
          repro::fence_regs(acc);
          if (prev >= 0) repro::mbar_arrive(empty(prev));
          prev = s;
        }
      }
      if constexpr (!Q) {
        // Unconditional: the epilogue's branches read the accumulators, and
        // a wait ptxas cannot prove taken makes it serialize every product
        // (C7518).
        repro::wgmma_wait<0>();
        repro::fence_regs(acc);
        if (prev >= 0) repro::mbar_arrive(empty(prev));
      }
    }

    // a row's value before x g: x scale[row] (int8 rows); padding and rows
    // outside the split left out (-inf) of the seed below
    auto unscaled = [&](int i) {
      const int rr = (i >> 1) & 1;
      return masked[rr] ? -CUDART_INF_F : (Q ? acc[i] * sc[rr] : acc[i]);
    };
    if (tile == 0 && k <= kSeedK) {
      // The first tile would make every value a candidate. Each warp's top 2
      // of its 16 rows per token (shuffles over the 8 lanes holding them),
      // before x g, meet in the queue, empty yet; a token's threshold starts
      // at the k-th largest u of those 16, times g: at least k of the tile's
      // rows have u >= it, and for g > 0 rounding keeps the order, so their
      // z = u x g reach the threshold. No value below it is in the top k;
      // values at it are candidates. Larger k, and g < 0, start from -inf.
      // Padding rows (all -1e9, a tie) are left out of that and give a
      // threshold of their own: (-1e9, one past the tile's k-th padding
      // row), which a tile of padding alone needs to take only k rows.
      float2* top = que;  // [kWarps][N]
      uint32_t* padm = reinterpret_cast<uint32_t*>(top + kWarps * N);  // [kWarps] 16 rows each
      {
        // lane 4 i holds rows 16 warp + i (rr 0) and 16 warp + 8 + i (rr 1)
        const uint32_t p0 = __ballot_sync(0xffffffffu, masked[0] && in[0]);
        const uint32_t p1 = __ballot_sync(0xffffffffu, masked[1] && in[1]);
        uint32_t m16 = 0u;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          m16 |= (((p0 >> (4 * i)) & 1u) << i) | (((p1 >> (4 * i)) & 1u) << (8 + i));
        if (lane == 0) padm[warp] = m16;
      }
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x = unscaled(4 * j + h), y = unscaled(4 * j + 2 + h);
          float a1 = fmaxf(x, y), a2 = fminf(x, y);
#pragma unroll
          for (int off = 4; off < 32; off *= 2) {
            const float b1 = __shfl_xor_sync(0xffffffffu, a1, off);
            const float b2 = __shfl_xor_sync(0xffffffffu, a2, off);
            a2 = fmaxf(fminf(a1, b1), fmaxf(a2, b2));
            a1 = fmaxf(a1, b1);
          }
          if (lane < 4) top[warp * N + 8 * j + 2 * q4 + h] = make_float2(a1, a2);
        }
      bar_sync(1, kConsumers);
      int t;  // the thread index read again: kept across the shuffles, it spilled
      asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
      if (t < n_tok && gs[t] > 0.f) {
        // the k-th largest: (#values above it) < k <= (#values at or above
        // it), the 16 read from shared memory in turn
        const float* x = reinterpret_cast<const float*>(top) + 2 * t;
        float kth = -CUDART_INF_F;
#pragma unroll 1
        for (int a = 0; a < 2 * kWarps; ++a) {
          const float xa = x[(a >> 1) * 2 * N + (a & 1)];
          int gt = 0, ge = 0;
#pragma unroll
          for (int b = 0; b < 2 * kWarps; ++b) {
            const float xb = x[(b >> 1) * 2 * N + (b & 1)];
            gt += xb > xa;
            ge += xb >= xa;
          }
          kth = (gt < k && ge >= k) ? xa : kth;
        }
        float2 th = make_float2(kth * gs[t], __uint_as_float(0xffffffffu));  // z >= kth x g
        // the k-th padding row of the tile, if there are k
        int need = k;
#pragma unroll 1
        for (int w = 0; w < kWarps && need > 0; ++w) {
          uint32_t m = padm[w];
          const int c = __popc(m);
          if (need > c) {
            need -= c;
            continue;
          }
          for (; need > 1; --need) m &= m - 1u;
          need = 0;
          const uint32_t b = static_cast<uint32_t>(v_lo + 16 * w + __ffs(static_cast<int>(m)));
          if (!(th.x > repro::kNegInfMask))
            th = make_float2(repro::kNegInfMask, __uint_as_float(b));
        }
        thr[t] = th;
        lob[t] = u_bound(th.x, gs[t]);
      }
      bar_sync(1, kConsumers);  // thresholds set, scratch read: the queue may fill
    }

    // After the barrier the previous tile is merged: the queue is empty, and
    // the thresholds cover every earlier tile. z = u x g[token] (padding
    // -1e9, rows outside the split -inf) is a candidate when it beats its
    // token's threshold: the threshold is a list's k-th entry, and the list
    // only gains, so the compare is exact whatever tile the entry comes
    // from. Code size sets the epilogue's time (it runs once a tile, from an
    // instruction cache the products' memory stream leaves cold), so each
    // value gets a few instructions of unrolled code and one copy of a loop
    // handles the few candidates. The spill area holds a tile's 128 rows of
    // a token, so no candidate is ever dropped.
    if (tile > 0) bar_sync(1, kConsumers);
    // A row outside the split (-inf) never passes: its position bound is
    // the largest there is.
    const uint32_t upos[2] = {in[0] ? static_cast<uint32_t>(pos[0]) : 0xffffffffu,
                              in[1] ? static_cast<uint32_t>(pos[1]) : 0xffffffffu};
    auto u_of = [&](float v, int rr) { return Q ? v * sc[rr] : v; };
    // Pass 1, a few instructions a value: a bit per (j, h), the two rows
    // of token 8 j + 2 (lane % 4) + h this thread holds, set when either
    // may be a candidate: its u reaches the token's bound lob (in a warp
    // with padding, a padding row's z = -1e9 is compared with the threshold
    // itself).
    constexpr int NP = N / 4;  // (j, h) pairs
    uint32_t pass[(NP + 31) / 32];
#pragma unroll
    for (int w = 0; w < (NP + 31) / 32; ++w) pass[w] = 0u;
    if (!__any_sync(0xffffffffu, masked[0] | masked[1])) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 lo = *reinterpret_cast<const float2*>(lob + 8 * j + 2 * q4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m = fmaxf(u_of(acc[4 * j + h], 0), u_of(acc[4 * j + 2 + h], 1));
          pass[(2 * j + h) / 32] |= static_cast<uint32_t>(m >= (h ? lo.y : lo.x))
                                    << ((2 * j + h) % 32);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 lo = *reinterpret_cast<const float2*>(lob + 8 * j + 2 * q4);
        const float4 tt = *reinterpret_cast<const float4*>(thr + 8 * j + 2 * q4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float tv = h ? tt.z : tt.x;
          const uint32_t tb = __float_as_uint(h ? tt.w : tt.y);
          bool p = false;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            p |= masked[rr] ? (mask_val[rr] > tv) | ((mask_val[rr] == tv) & (upos[rr] < tb))
                            : u_of(acc[4 * j + 2 * rr + h], rr) >= (h ? lo.y : lo.x);
          pass[(2 * j + h) / 32] |= static_cast<uint32_t>(p) << ((2 * j + h) % 32);
        }
      }
    }
    // Pass 2, one copy of the loop body for the few pairs that passed: both
    // rows picked from the accumulators by a chain of selects (an index into
    // them would move them to local memory), z exact and compared with the
    // threshold; a candidate takes a slot in its token's queue by a
    // shared-memory atomic, past kQueue one in the block's spill area.
    uint32_t bits = pass[0];
    for (int wbase = 0;;) {
      while (bits != 0u) {
        const int pr = wbase + __ffs(static_cast<int>(bits)) - 1, j = pr >> 1, h = pr & 1;
        bits &= bits - 1u;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
          for (int x = 0; x < 4; ++x) v[x] = jj == j ? acc[4 * jj + x] : v[x];
        const int col = 8 * j + 2 * q4 + h;
        const float g = gs[col];
        const float2 t = thr[col];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float z = u_of(h ? v[2 * rr + 1] : v[2 * rr], rr) * g;
          z = masked[rr] ? mask_val[rr] : z;
          if ((z > t.x) | ((z == t.x) & (upos[rr] < __float_as_uint(t.y)))) {
            const float2 e = make_float2(z, __int_as_float(pos[rr]));
            const int slot = atomicAdd(&cnt[col], 1);
            if (slot < kQueue)
              que[slot * N + col] = e;
            else
              spill[col * kSpill + slot - kQueue] = e;
          }
        }
      }
      if ((wbase += 32) >= NP) break;
#pragma unroll
      for (int w = 1; w < (NP + 31) / 32; ++w)
        if (w * 32 == wbase) bits = pass[w];
    }
    // Every candidate is queued: one thread per token merges its token's
    // into the list and publishes the token's new threshold (read from the
    // next tile's filter on, after its barrier).
    bar_sync(1, kConsumers);
    const int t = threadIdx.x;
    const int n = t < n_tok ? cnt[t] : 0;
    if (n > 0) {
      cnt[t] = 0;
      uint64_t* l = lst + t;
      RegKeys r;
      if (k <= kRegK) {
#pragma unroll
        for (int j = 0; j < kRegK; ++j) r.v[j] = j < k ? l[j * N] : 0ull;
      }
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
        const float2 c = j < kQueue ? que[j * N + t] : spill[t * kSpill + j - kQueue];
        const uint64_t x = key_of(c.x, __float_as_int(c.y));
        if (k <= kRegK)
          r.insert(x);
        else
          insert_key<N>(l, k, x);
      }
      if (k <= kRegK) {
#pragma unroll
        for (int j = 0; j < kRegK; ++j)
          if (j < k) l[j * N] = r.v[j];
      }
      const uint64_t kth = l[(k - 1) * N];
      thr[t] = make_float2(key_value(kth), __uint_as_float(static_cast<uint32_t>(key_pos(kth))));
      lob[t] = u_bound(key_value(kth), gs[t]);
    }
  }

  // The lists out, each by the thread that merged it; positions become
  // class ids. An empty slot (g 0) took no candidate: its list follows from
  // ids alone, as in the decode body (for finite rows and tokens every real
  // row scores x . w * 0 = +-0, a tie, and every padding row -1e9): (0, id)
  // on the split's first k real packed positions, then (-1e9, -1) while its
  // rows last, then (-inf, -1).
  const int t = threadIdx.x;
  if (t < n_tok) {
    float* ov = out_v + ((static_cast<size_t>(sp) * K + e) * C + t0 + t) * k;
    int* oi = out_i + ((static_cast<size_t>(sp) * K + e) * C + t0 + t) * k;
    if (gs[t] != 0.f) {
      for (int j = 0; j < k; ++j) {
        const uint64_t x = lst[j * N + t];
        const int p = key_pos(x);
        ov[j] = key_value(x);
        oi[j] = p == kNoPos ? -1 : idp[p];
      }
    } else {
      int j = 0;
      for (int p = v_lo; p < v_hi && j < k; ++p) {
        const int id = idp[p];
        if (id >= 0) {
          ov[j] = 0.f;
          oi[j++] = id;
        }
      }
      for (int pads = max(0, v_hi - v_lo - j), jj = j; jj < k; ++jj) {
        ov[jj] = jj - j < pads ? repro::kNegInfMask : -CUDART_INF_F;
        oi[jj] = -1;
      }
    }
  }
}

struct Args {
  const void *buf, *w;
  const float* g_buf;
  const int* ids;
  const float* scales;
  float *out_v, *part_v;
  int *out_i, *part_i;
  float2* spill;
  int K, C, v_pad, d, k, nsplit, tiles_per_split, stages;
  cudaStream_t stream;
};

template <int N, bool Q>
cudaError_t launch(const Args& a) {
  CUtensorMap mw, mx;
  cudaError_t err =
      make_map(&mw, a.w, Q ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               Q ? 1 : 2, a.d, a.v_pad, a.K, kSlice, kRows,
               Q ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_map(&mx, a.buf, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.d, a.C, a.K, kSlice, N,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const int smem = Layout(N, a.k, a.stages, Q).total;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kern = wgmma_kernel<N, Q>;
  err = repro::smem_limit_once(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nsplit, (a.C + N - 1) / N, a.K);
  float* dst_v = a.nsplit > 1 ? a.part_v : a.out_v;
  int* dst_i = a.nsplit > 1 ? a.part_i : a.out_i;
  kern<<<grid, kThreads, smem, a.stream>>>(mw, mx, a.g_buf, a.ids, a.scales, dst_v, dst_i,
                                           a.spill, a.K, a.C, a.v_pad, a.d, a.k,
                                           a.tiles_per_split, a.stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  return repro::launch_merge(a.part_v, a.part_i, a.out_v, a.out_i, a.K * a.C, a.k, a.nsplit,
                             a.stream);
}

template <bool Q>
cudaError_t launch_n(int n_tile, const Args& a) {
  switch (n_tile) {
    case 16: return launch<16, Q>(a);
    case 32: return launch<32, Q>(a);
    case 64: return launch<64, Q>(a);
    case 128: return launch<128, Q>(a);
    case 256: return launch<256, Q>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

// The decode body. wdtype: the rows' dtype code, either dtype (f32/bf16
// rows, scales null) or kDtypeI8 (int8 rows with (K, v_pad) fp32 scales).
// part_v, part_p (nchunks, K, C, k) and n_sel (1,) are scratch, nchunks the
// chunks of one expert when a single expert has live slots (the most there
// can be). grid and vb come from kernels/dss_topk_grouped.py::launch_plan.
extern "C" int dss_topk_grouped(const void* buf, const void* g_buf, const void* w,
                                const void* ids, const void* scales, void* out_v, void* out_i,
                                void* part_v, void* part_p, void* n_sel, int K, int C, int v_pad,
                                int d, int k, int grid, int vb, int dtype, int wdtype,
                                void* stream) {
  if (k < 1 || k > repro::kMaxK || k > v_pad || K < 1 || C < 1 || d < 1 || grid < 1)
    return cudaErrorInvalidValue;
  if (wdtype != dtype && wdtype != repro::kDtypeI8) return cudaErrorInvalidValue;
  const int wbytes = wdtype == repro::kDtypeI8 ? 1 : (wdtype == repro::kDtypeF32 ? 4 : 2);
  if (!repro::stream::stream_args_ok(w, d, wbytes, vb, k, K)) return cudaErrorInvalidValue;
  const StreamArgs a{buf, w, static_cast<const float*>(g_buf), static_cast<const int*>(ids),
                     static_cast<const float*>(scales), static_cast<float*>(out_v),
                     static_cast<float*>(part_v), static_cast<int*>(out_i),
                     static_cast<int*>(part_p), static_cast<int*>(n_sel), K, C, v_pad, d, k,
                     grid, vb, static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kDtypeF32) return stream_w<float>(wdtype, a);
  if (dtype == repro::kDtypeBF16) return stream_w<__nv_bfloat16>(wdtype, a);
  return cudaErrorInvalidValue;
}

// The tiled body: fp32 tokens with fp32 rows or int8 rows ((K, v_pad) fp32
// scales), or bf16 tokens with bf16 or int8 rows. tma 1: rows and tokens
// staged by TMA (fp32 tokens only; d a multiple of 4, of 16 for int8 rows,
// buf and weights 16-byte aligned), else one element at a time. part_v,
// part_i (nchunk, K, C, k) are scratch when nchunk > 1; next_item (one int)
// and lows (K, C) always. n_tile (16, 32, 64 or 128), tiles_per_chunk,
// big_tiles (the row tiles in chunks of tiles_per_chunk; one tile a chunk
// after them) and nchunk come from kernels/dss_topk_grouped.py::tiled_plan.
extern "C" int dss_topk_grouped_tiled(const void* buf, const void* g_buf, const void* w,
                                      const void* ids, const void* scales, void* out_v,
                                      void* out_i, void* part_v, void* part_i, void* next_item,
                                      void* lows, int K, int C, int v_pad, int d, int k,
                                      int n_tile, int tiles_per_chunk, int big_tiles,
                                      int nchunk, int tma, int dtype, int wdtype,
                                      void* stream) {
  const bool q = wdtype == repro::kDtypeI8;
  const int row_tiles = (v_pad + simt::kRows - 1) / simt::kRows;
  if (k < 1 || k > repro::kMaxK || k > v_pad || K < 1 || C < 1 || d < 1 ||
      tiles_per_chunk < 1 || big_tiles < 0 || big_tiles > row_tiles || nchunk < 1 ||
      nchunk > simt::kMaxChunks ||
      nchunk != (big_tiles + tiles_per_chunk - 1) / tiles_per_chunk + row_tiles - big_tiles ||
      next_item == nullptr || lows == nullptr ||
      (nchunk > 1 && (part_v == nullptr || part_i == nullptr)))
    return cudaErrorInvalidValue;
  if ((wdtype != dtype && !q) || q != (scales != nullptr)) return cudaErrorInvalidValue;
  if (tma && (dtype != repro::kDtypeF32 || d % (q ? 16 : 4) != 0 ||
              reinterpret_cast<uintptr_t>(buf) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(w) % 16 != 0))
    return cudaErrorInvalidValue;
  const simt::Args a{buf, w, static_cast<const float*>(g_buf), static_cast<const int*>(ids),
                     static_cast<const float*>(scales), static_cast<float*>(out_v),
                     static_cast<float*>(part_v), static_cast<int*>(out_i),
                     static_cast<int*>(part_i), static_cast<int*>(next_item),
                     static_cast<unsigned*>(lows), K, C, v_pad, d, k, tiles_per_chunk,
                     big_tiles, nchunk, static_cast<cudaStream_t>(stream)};
  using bf16 = __nv_bfloat16;
  if (dtype == repro::kDtypeF32) {
    if (tma)
      return q ? simt::launch_n<float, int8_t, true>(n_tile, a)
               : simt::launch_n<float, float, true>(n_tile, a);
    return q ? simt::launch_n<float, int8_t, false>(n_tile, a)
             : simt::launch_n<float, float, false>(n_tile, a);
  }
  if (dtype == repro::kDtypeBF16 && !tma)
    return q ? simt::launch_n<bf16, int8_t, false>(n_tile, a)
             : simt::launch_n<bf16, bf16, false>(n_tile, a);
  return cudaErrorInvalidValue;
}

// The tensor-core body: bf16 tokens with bf16 rows (wdtype kDtypeBF16,
// scales null) or int8 rows (kDtypeI8, (K, v_pad) fp32 scales). d a
// multiple of 8 (16 for int8 rows) and 16-byte aligned buf and weights, as
// TMA requires. part_v, part_i (nsplit, K, C, k) are scratch when nsplit >
// 1; spill (8-byte aligned) is scratch of (nsplit x token tiles x K blocks)
// x n_tile x 112 (fp32, int32) pairs (wgmma_spill_pairs); n_tile (16, 32,
// 64, 128 or 256), nsplit, tiles_per_split and stages come from
// kernels/dss_topk_grouped.py::wgmma_plan.
extern "C" int dss_topk_grouped_wgmma(const void* buf, const void* g_buf, const void* w,
                                      const void* ids, const void* scales, void* out_v,
                                      void* out_i, void* part_v, void* part_i, void* spill,
                                      int K, int C, int v_pad, int d, int k, int n_tile,
                                      int nsplit, int tiles_per_split, int stages, int wdtype,
                                      void* stream) {
  const bool q = wdtype == repro::kDtypeI8;
  if (k < 1 || k > repro::kMaxK || k > v_pad || K < 1 || K > 65535 || C < 1 || d < 1 ||
      nsplit < 1 || nsplit > 65535 || tiles_per_split < 1 || stages < 2 || stages > 4 ||
      (C + n_tile - 1) / std::max(n_tile, 1) > 65535)
    return cudaErrorInvalidValue;
  if (!q && wdtype != repro::kDtypeBF16) return cudaErrorInvalidValue;
  if (spill == nullptr || reinterpret_cast<uintptr_t>(spill) % 8 != 0) return cudaErrorInvalidValue;
  if (q != (scales != nullptr) || d % (q ? 16 : 8) != 0 ||
      reinterpret_cast<uintptr_t>(buf) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  const wg::Args a{buf, w, static_cast<const float*>(g_buf), static_cast<const int*>(ids),
                   static_cast<const float*>(scales), static_cast<float*>(out_v),
                   static_cast<float*>(part_v), static_cast<int*>(out_i),
                   static_cast<int*>(part_i), static_cast<float2*>(spill), K, C, v_pad, d, k,
                   nsplit, tiles_per_split, stages, static_cast<cudaStream_t>(stream)};
  return q ? wg::launch_n<true>(n_tile, a) : wg::launch_n<false>(n_tile, a);
}
