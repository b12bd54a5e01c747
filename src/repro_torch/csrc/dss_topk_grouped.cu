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
// - bf16 rows: both operands from shared memory (128-byte swizzle),
//   m64nNk16 with one group of products in flight while the next stage's
//   are issued. int8 rows: the stage holds (128 x 64) int8 bytes without
//   swizzle; each thread widens its two rows to bf16 in registers (exact)
//   as the m64k16 A fragments and wgmma reads A from registers.
// - The epilogue runs on the accumulator registers: x scale[row] (int8),
//   x g[token], padding -> -1e9, then one compare per value against its
//   token's current k-th value (shared memory), branch-free, into bits.
//   Only values above it take a slot (a shared-memory atomic, unrolled and
//   predicated: branches that diverge across a warp's lanes cost every
//   lane) in a per-token buffer of kCand; the warpgroup's 128 threads then
//   insert them, one thread per token, into the token's sorted list (value
//   desc, position asc; for k <= 8 the list sits in registers meanwhile).
//   Values that found the slots full go in further rounds. Lists and slots
//   are stored slot-major, so the threads of consecutive tokens hit
//   consecutive banks. Each warpgroup keeps its own lists, merged per token
//   at the end.
// - The first tile would make every value a candidate: each token starts
//   from the smallest of its 4 warps' top 2 (warp shuffles; at least 8 of
//   the tile's values reach it, so for k <= 8 no value below it can be in
//   the top k), exchanged through the ring while the producer waits on a
//   `seed` barrier. Larger k start from -inf.
// - Shared memory (wgmma_smem_bytes): the ring, stages x (row tile 16 KB
//   bf16 / 8 KB int8 + N x 128 B tokens), plus per warpgroup and token the
//   k-th value, a slot count, kCand candidate slots and the k-entry list
//   (8 bytes each), plus g and 1 KB of alignment; at N 256, k 8: 3 stages,
//   214 KB bf16, 190 KB int8, of the 227 KB a block may use. The plan
//   lowers the stage count, then N, until it fits.
// - Measured (chip_smoke.py phase 2, PERF.md): the epilogue still stalls
//   the tensor cores (both warpgroups reach it together); overlapping it
//   with the next tile's products is the next step.
//
// dss_topk_grouped_tiled, the CUDA-core tiled body (fp32 tokens, where
// tensor cores would need TF32 and change the function, and bf16 tokens
// that TMA cannot address, at prefill capacities). Bound: operations,
// 2*K*C*V_pad*d FLOPs at the fp32 CUDA-core rate. A block owns one (expert,
// token tile, vocab split) and loops over the split's vocab tiles itself,
// keeping the running top-k in shared memory (topk_common.cuh). Each
// weight tile is read once per token tile and used by every token in it.
// Vocab splits (chosen by the wrapper to fill the 132 SMs) write partial
// lists that a second small kernel merges in split order. The product runs
// on CUDA cores in fp32 FMA.
#include "retrieve_stream.cuh"
#include "wgmma_common.cuh"

namespace {

// ---- the tiled body (prefill capacities) --------------------------------

using repro::TileSmem;

template <typename TX, typename TW, int TB>
__global__ void __launch_bounds__(repro::kThreads)
grouped_kernel(const TX* __restrict__ buf, const float* __restrict__ g_buf,
               const TW* __restrict__ w, const int* __restrict__ ids,
               const float* __restrict__ scales, float* __restrict__ out_v,
               int* __restrict__ out_i, int K, int C, int v_pad, int d, int k,
               int tiles_per_split) {
  extern __shared__ __align__(16) char smem[];
  const TileSmem<TB> s = TileSmem<TB>::carve(smem, k);
  const int t0 = blockIdx.x * TB, e = blockIdx.y, sp = blockIdx.z;
  const int n_tok = min(TB, C - t0);
  const int v_lo = sp * tiles_per_split * repro::kTV;
  const int v_hi = min(v_pad, v_lo + tiles_per_split * repro::kTV);
  if (threadIdx.x < TB) {
    const int t = threadIdx.x;
    s.tok_off[t] = (static_cast<long long>(e) * C + t0 + t) * d;
    s.g[t] = t < n_tok ? g_buf[static_cast<size_t>(e) * C + t0 + t] : 0.f;
  }
  repro::init_topk(s, k);
  __syncthreads();
  const size_t e_row = static_cast<size_t>(e) * v_pad;
  repro::retrieve_tile<TX, TW, TB>(s, buf, n_tok, w + e_row * d, ids + e_row,
                                   scales != nullptr ? scales + e_row : nullptr,
                                   v_lo, v_hi, d, k);
  for (int i = threadIdx.x; i < n_tok * k; i += repro::kThreads) {
    const int t = i / k, j = i % k;
    const size_t row = (static_cast<size_t>(sp) * K + e) * C + t0 + t;
    out_v[row * k + j] = s.top_v[t * k + j];
    out_i[row * k + j] = s.top_i[t * k + j];
  }
}

template <typename TX, typename TW, int TB>
cudaError_t launch(const void* buf, const float* g_buf, const void* w,
                   const int* ids, const float* scales, float* out_v,
                   int* out_i, float* part_v, int* part_i, int K, int C,
                   int v_pad, int d, int k, int nsplit, int tiles_per_split,
                   cudaStream_t stream) {
  const size_t smem = TileSmem<TB>::bytes(k);
  auto kern = grouped_kernel<TX, TW, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((C + TB - 1) / TB, K, nsplit);
  float* dst_v = nsplit > 1 ? part_v : out_v;
  int* dst_i = nsplit > 1 ? part_i : out_i;
  kern<<<grid, repro::kThreads, smem, stream>>>(
      static_cast<const TX*>(buf), g_buf, static_cast<const TW*>(w), ids,
      scales, dst_v, dst_i, K, C, v_pad, d, k, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return repro::launch_merge(part_v, part_i, out_v, out_i, K * C, k, nsplit, stream);
}

template <typename TX, typename TW>
cudaError_t dispatch_tb(int tb, const void* buf, const float* g_buf,
                        const void* w, const int* ids, const float* scales,
                        float* out_v, int* out_i, float* part_v, int* part_i,
                        int K, int C, int v_pad, int d, int k, int nsplit,
                        int tps, cudaStream_t s) {
  if (tb == 16)
    return launch<TX, TW, 16>(buf, g_buf, w, ids, scales, out_v, out_i, part_v,
                              part_i, K, C, v_pad, d, k, nsplit, tps, s);
  if (tb == 64)
    return launch<TX, TW, 64>(buf, g_buf, w, ids, scales, out_v, out_i, part_v,
                              part_i, K, C, v_pad, d, k, nsplit, tps, s);
  return cudaErrorInvalidValue;
}

// Token type TX with rows of the token type, or int8 rows with scales.
template <typename TX>
cudaError_t dispatch_w(int wdtype, int tb, const void* buf, const float* g_buf,
                       const void* w, const int* ids, const float* scales,
                       float* out_v, int* out_i, float* part_v, int* part_i,
                       int K, int C, int v_pad, int d, int k, int nsplit,
                       int tps, cudaStream_t s) {
  if (wdtype == repro::kDtypeI8) {
    if (scales == nullptr) return cudaErrorInvalidValue;
    return dispatch_tb<TX, int8_t>(tb, buf, g_buf, w, ids, scales, out_v, out_i,
                                   part_v, part_i, K, C, v_pad, d, k, nsplit,
                                   tps, s);
  }
  if (scales != nullptr) return cudaErrorInvalidValue;
  return dispatch_tb<TX, TX>(tb, buf, g_buf, w, ids, nullptr, out_v, out_i,
                             part_v, part_i, K, C, v_pad, d, k, nsplit, tps, s);
}

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
constexpr int kThreads = kConsumers + 128; // + the producer warpgroup
// Registers per thread after setmaxnreg: the producer warpgroup gives its
// registers up to the two consumer warpgroups, which hold N / 2 fp32
// accumulators each (128 at N 256) beside the epilogue's state: 128 x 40 +
// 256 x 232 <= 65,536. Without it a 384-thread block gets 168 each and the
// epilogue spills.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kCand = 8;                   // candidate slots per token, warpgroup and round
constexpr int kSmemMax = 232448;           // shared memory a block may use
constexpr int kNoPos = 0x7fffffff;         // position of an unfilled list entry
constexpr int kTop2K = 8;                  // the first tile's threshold serves k up to this

__host__ __device__ constexpr int row_tile_bytes(bool q) { return kRows * kSlice * (q ? 1 : 2); }

// Byte offsets from the 1024-aligned base of the dynamic shared memory.
struct Layout {
  int stage;   // bytes of one ring stage: the row tile, then the token tile
  int bars;    // full[stages], empty[stages], then seed
  int g;       // [N] gate value per token
  int thresh;  // [2][N] each warpgroup's current k-th value per token
  int cnt;     // [2][N] candidate slots taken this round
  int cand_v;  // [2][kCand][N] candidate values (slot-major: the threads of
               // consecutive tokens hit consecutive banks)
  int cand_p;  // [2][kCand][N] candidate packed positions
  int list_v;  // [2][k][N] running top-k values, (value desc, position asc)
  int list_p;  // [2][k][N] their packed positions
  int total;   // bytes to request, with 1 KB to align the base
  __host__ __device__ Layout(int N, int k, int stages, bool q) {
    stage = row_tile_bytes(q) + N * kSlice * 2;
    bars = stages * stage;
    g = bars + 16 * stages + 16;
    thresh = g + 4 * N;
    cnt = thresh + 8 * N;
    cand_v = cnt + 8 * N;
    cand_p = cand_v + 8 * N * kCand;
    list_v = cand_p + 8 * N * kCand;
    list_p = list_v + 8 * N * k;
    total = list_p + 8 * N * k + 1024;
  }
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// A named barrier that also returns whether any participant passed true.
__device__ __forceinline__ bool bar_any(int id, int n, bool p) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred q, o;\nsetp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred o, %2, %3, q;\nselp.u32 %0, 1, 0, o;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(p)), "r"(id), "r"(n)
      : "memory");
  return r != 0;
}

// (v, p) before (lv, lp) in the list order: value desc, position asc.
__device__ __forceinline__ bool before(float v, int p, float lv, int lp) {
  return v > lv || (v == lv && p < lp);
}

// Insert (v, p) into a sorted list of k entries, entry j at lv[j * S].
template <int S>
__device__ __forceinline__ void insert(float* lv, int* lp, int k, float v, int p) {
  if (!before(v, p, lv[(k - 1) * S], lp[(k - 1) * S])) return;
  int j = k - 1;
  while (j > 0 && before(v, p, lv[(j - 1) * S], lp[(j - 1) * S])) {
    lv[j * S] = lv[(j - 1) * S];
    lp[j * S] = lp[(j - 1) * S];
    --j;
  }
  lv[j * S] = v;
  lp[j * S] = p;
}

// A token's list in registers while one thread inserts a round's
// candidates into it (k up to kRegK): the list's loads are independent and
// each insertion is a fixed chain of compares and selects, where the list
// in shared memory made each insertion a chain of dependent loads. Entries
// past k hold (-inf, kNoPos) or values pushed out of the first k; only the
// first k are stored back.
constexpr int kRegK = 8;

template <int S>  // stride between a list's entries in shared memory
struct RegList {
  float v[kRegK];
  int p[kRegK];
  __device__ __forceinline__ void load(const float* lv, const int* lp, int k) {
#pragma unroll
    for (int j = 0; j < kRegK; ++j) {
      v[j] = j < k ? lv[j * S] : -CUDART_INF_F;
      p[j] = j < k ? lp[j * S] : kNoPos;
    }
  }
  __device__ __forceinline__ void insert(float x, int q) {
#pragma unroll
    for (int j = kRegK - 1; j >= 0; --j) {
      const bool up = j > 0 && before(x, q, v[j > 0 ? j - 1 : 0], p[j > 0 ? j - 1 : 0]);
      const bool here = before(x, q, v[j], p[j]);
      const float nv = up ? v[j > 0 ? j - 1 : 0] : (here ? x : v[j]);
      const int np = up ? p[j > 0 ? j - 1 : 0] : (here ? q : p[j]);
      v[j] = nv;
      p[j] = np;
    }
  }
  __device__ __forceinline__ void store(float* lv, int* lp, int k) const {
#pragma unroll
    for (int j = 0; j < kRegK; ++j)
      if (j < k) {
        lv[j * S] = v[j];
        lp[j * S] = p[j];
      }
  }
};

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
// the tile to out (nsplit, K, C, k) at split blockIdx.x.
template <int N, bool Q>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
             const float* __restrict__ g_buf, const int* __restrict__ ids,
             const float* __restrict__ scales, float* __restrict__ out_v,
             int* __restrict__ out_i, int K, int C, int v_pad, int d, int k,
             int tiles_per_split, int stages) {
  constexpr int NA = N / 2;          // accumulator registers per thread
  constexpr int NW = (NA + 31) / 32;  // words of one bit per accumulator
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = repro::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const Layout L(N, k, stages, Q);
  auto full = [&](int s) { return base + L.bars + 8u * s; };
  auto empty = [&](int s) { return base + L.bars + 8u * (stages + s); };
  const uint32_t seed = base + L.bars + 16u * stages;  // the first tile's lists are seeded
  float* gs = reinterpret_cast<float*>(sm + L.g);

  const int sp = blockIdx.x, t0 = blockIdx.y * N, e = blockIdx.z;
  const int n_tok = min(N, C - t0);
  const int v_lo = sp * tiles_per_split * kRows;
  const int v_hi = min(v_pad, v_lo + tiles_per_split * kRows);
  const int n_tiles = v_hi > v_lo ? (v_hi - v_lo + kRows - 1) / kRows : 0;
  const int n_sl = (d + kSlice - 1) / kSlice;
  const int steps = n_tiles * n_sl;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      repro::mbar_init(full(s), 1);
      repro::mbar_init(empty(s), kConsumers);
    }
    repro::mbar_init(seed, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    float* th = reinterpret_cast<float*>(sm + L.thresh);
    int* cn = reinterpret_cast<int*>(sm + L.cnt);
    float* lv = reinterpret_cast<float*>(sm + L.list_v);
    int* lp = reinterpret_cast<int*>(sm + L.list_p);
    for (int t = threadIdx.x; t < N; t += kThreads)
      gs[t] = t < n_tok ? g_buf[static_cast<size_t>(e) * C + t0 + t] : 0.f;
    for (int i = threadIdx.x; i < 2 * N; i += kThreads) {
      th[i] = i % N < n_tok ? -CUDART_INF_F : CUDART_INF_F;  // slots past C: never a candidate
      cn[i] = 0;
    }
    for (int i = threadIdx.x; i < 2 * N * k; i += kThreads) {
      lv[i] = -CUDART_INF_F;
      lp[i] = kNoPos;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers / 32) {
    // -- producer warpgroup: one lane issues every TMA load ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      const uint32_t bytes = L.stage;
      for (int st = 0; st < steps; ++st) {
        const int s = st % stages;
        if (st == n_sl) repro::mbar_wait(seed, 0);  // the ring holds the seed scratch
        if (st >= stages) repro::mbar_wait(empty(s), ((st / stages) - 1) & 1);
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
  const int wgi = warp / 4, wi = warp % 4, q4 = lane % 4;
  const int ct = threadIdx.x % 128;
  const int bar_id = 1 + wgi;
  float* th = reinterpret_cast<float*>(sm + L.thresh) + wgi * N;
  // The other warpgroup's k-th values: its list holds k values at or above
  // them, so a value below one of them cannot reach the merged top k. It
  // only rises, so a read that races its update is still a bound; a tie
  // may come from a lower position of the current tile and is kept.
  const float* th_other = reinterpret_cast<const float*>(sm + L.thresh) + (1 - wgi) * N;
  int* cn = reinterpret_cast<int*>(sm + L.cnt) + wgi * N;
  float* cv = reinterpret_cast<float*>(sm + L.cand_v) + wgi * N * kCand;
  int* cp = reinterpret_cast<int*>(sm + L.cand_p) + wgi * N * kCand;
  float* lv = reinterpret_cast<float*>(sm + L.list_v) + wgi * N * k;
  int* lp = reinterpret_cast<int*>(sm + L.list_p) + wgi * N * k;
  const int* idp = ids + static_cast<size_t>(e) * v_pad;
  const int row0 = 64 * wgi + 16 * wi + lane / 4;  // this thread's rows: row0, row0 + 8

  // The warpgroup inserts this round's candidates, one thread per token,
  // and publishes each token's new k-th value.
  auto insert_round = [&]() {
    for (int t = ct; t < n_tok; t += 128) {
      const int n = min(cn[t], kCand);
      float* v = lv + t;
      int* p = lp + t;
      if (k <= kRegK) {
        if (n > 0) {
          RegList<N> l;
          l.load(v, p, k);
          for (int j = 0; j < n; ++j) l.insert(cv[j * N + t], cp[j * N + t]);
          l.store(v, p, k);
        }
      } else {
        for (int j = 0; j < n; ++j) insert<N>(v, p, k, cv[j * N + t], cp[j * N + t]);
      }
      cn[t] = 0;
      th[t] = v[(k - 1) * N];
    }
  };

  for (int tile = 0; tile < n_tiles; ++tile) {
    int pos[2];
    bool masked[2];
    float mask_val[2], sc[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      pos[rr] = v_lo + tile * kRows + row0 + 8 * rr;
      const bool in = pos[rr] < v_hi;
      masked[rr] = !in || idp[pos[rr]] < 0;
      mask_val[rr] = in ? repro::kNegInfMask : -CUDART_INF_F;
      sc[rr] = (Q && in) ? scales[static_cast<size_t>(e) * v_pad + pos[rr]] : 1.f;
    }
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;

    // The set bits of pend take candidate slots (a shared-memory atomic per
    // value); a value that finds its token's slots full stays pending. With
    // redo, a pending value first meets the token's current k-th values
    // again (>=: ties go on to insertion) and leaves if below one. Unrolled
    // and predicated (branches that diverge across a warp's lanes cost every
    // lane); a group of 8 values is skipped when no lane of the warp has a
    // candidate in it, and its 8 atomics issue back to back before their
    // results are used, instead of one atomic's latency per value.
    auto take_slots = [&](uint32_t (&pend)[NW], bool redo) {
#pragma unroll
      for (int gq = 0; gq < NA / 8; ++gq) {
        const uint32_t bits = (pend[gq / 4] >> (8 * (gq % 4))) & 0xffu;
        if (!__any_sync(0xffffffffu, bits != 0u)) continue;
        bool on[8];
        int slot[8];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int i = 8 * gq + b;
          const int col = 8 * (i >> 2) + 2 * q4 + (i & 1);
          on[b] = (bits >> b) & 1u;
          if (redo && on[b]) on[b] = acc[i] >= th[col] && acc[i] >= th_other[col];
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int i = 8 * gq + b;
          slot[b] = on[b] ? atomicAdd(&cn[8 * (i >> 2) + 2 * q4 + (i & 1)], 1) : kCand;
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int i = 8 * gq + b;
          const int col = 8 * (i >> 2) + 2 * q4 + (i & 1);
          if (slot[b] < kCand) {
            cv[slot[b] * N + col] = acc[i];
            cp[slot[b] * N + col] = (i & 2) ? pos[1] : pos[0];
          }
          const uint32_t keep = (on[b] && slot[b] >= kCand) ? 1u : 0u;
          pend[i / 32] = (pend[i / 32] & ~(1u << (i % 32))) | (keep << (i % 32));
        }
      }
    };

    int prev = -1;
    for (int sl = 0; sl < n_sl; ++sl) {
      const int st = tile * n_sl + sl, s = st % stages;
      repro::mbar_wait(full(s), (st / stages) & 1);
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
      if (prev >= 0) {
        repro::wgmma_wait<0>();
        repro::fence_regs(acc);
        repro::mbar_arrive(empty(prev));
      }
    }

    // z on the accumulators, in place: x scale[row] (int8 rows), x g[token],
    // padding rows -1e9; rows outside the split -inf (never a candidate).
    // Round 0's pass bits in the same pass, branch-free: a candidate must
    // beat the token's k-th value, all of whose positions come from earlier
    // tiles (lower positions), so a tie loses and the compare is strict.
    uint32_t pend[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) pend[w] = 0u;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 gg = *reinterpret_cast<const float2*>(gs + 8 * j + 2 * q4);
      const float2 tt = *reinterpret_cast<const float2*>(th + 8 * j + 2 * q4);
      const float2 to = *reinterpret_cast<const float2*>(th_other + 8 * j + 2 * q4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr + h;
          float z = acc[i];
          if (Q) z *= sc[rr];
          z *= h ? gg.y : gg.x;
          z = masked[rr] ? mask_val[rr] : z;
          acc[i] = z;
          pend[i / 32] |= static_cast<uint32_t>(z > (h ? tt.y : tt.x) && z >= (h ? to.y : to.x))
                          << (i % 32);
        }
    }

    if (tile == 0) {
      // The first tile: every value would pass the empty lists, so each
      // token starts from a threshold instead: the smallest of its 4 warps'
      // top 2 (8 values, so at least k >= 8 of the tile's values reach it:
      // a value below it is out). The warps' top 2 per token by shuffles
      // over the 8 lanes holding a token's 16 rows, exchanged through the
      // ring (idle: the producer waits on `seed` before the second tile).
      // Larger k start from -inf. Then round 0 takes every value at or
      // above the threshold (ties go on to insertion).
      if (k <= kTop2K) {
        bar_sync(3, kConsumers);  // both warpgroups are done reading the ring
        float2* top2 = reinterpret_cast<float2*>(sm) + wgi * 4 * N;  // [4 warps][N]
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x = acc[4 * j + h], y = acc[4 * j + 2 + h];
            float a1 = fmaxf(x, y), a2 = fminf(x, y);
#pragma unroll
            for (int off = 4; off < 32; off *= 2) {
              const float b1 = __shfl_xor_sync(0xffffffffu, a1, off);
              const float b2 = __shfl_xor_sync(0xffffffffu, a2, off);
              a2 = fmaxf(fminf(a1, b1), fmaxf(a2, b2));
              a1 = fmaxf(a1, b1);
            }
            if (lane < 4) top2[wi * N + 8 * j + 2 * q4 + h] = make_float2(a1, a2);
          }
        bar_sync(bar_id, 128);
        for (int t = ct; t < n_tok; t += 128) {
          float m = CUDART_INF_F;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float2 x = top2[w * N + t];
            m = fminf(m, x.y);  // x.y <= x.x
          }
          th[t] = m;
        }
        bar_sync(bar_id, 128);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      repro::mbar_arrive(seed);
#pragma unroll
      for (int w = 0; w < NW; ++w) pend[w] = 0u;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 tt = *reinterpret_cast<const float2*>(th + 8 * j + 2 * q4);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = 4 * j + b;
          pend[i / 32] |= static_cast<uint32_t>(acc[i] > -CUDART_INF_F &&
                                                acc[i] >= ((b & 1) ? tt.y : tt.x))
                          << (i % 32);
        }
      }
    }

    take_slots(pend, false);
    bool any_pend = false;
#pragma unroll
    for (int w = 0; w < NW; ++w) any_pend |= pend[w] != 0u;
    bool more = bar_any(bar_id, 128, any_pend);
    insert_round();
    bar_sync(bar_id, 128);
    // Further rounds: the candidates that found no slot, against k-th
    // values that may now come from this tile, so ties go on to insertion.
    while (more) {
      take_slots(pend, true);
      any_pend = false;
#pragma unroll
      for (int w = 0; w < NW; ++w) any_pend |= pend[w] != 0u;
      more = bar_any(bar_id, 128, any_pend);
      insert_round();
      bar_sync(bar_id, 128);
    }
  }

  // both warpgroups' lists, merged per token; positions become class ids
  bar_sync(3, kConsumers);
  const float* lv_all = reinterpret_cast<const float*>(sm + L.list_v);
  const int* lp_all = reinterpret_cast<const int*>(sm + L.list_p);
  for (int t = threadIdx.x; t < n_tok; t += kConsumers) {
    const float* av = lv_all + t;
    const int* ap = lp_all + t;
    const float* bv = lv_all + N * k + t;
    const int* bp = lp_all + N * k + t;
    const size_t row = (static_cast<size_t>(sp) * K + e) * C + t0 + t;
    int ia = 0, ib = 0;
    for (int j = 0; j < k; ++j) {
      float v;
      int p;
      if (before(av[ia * N], ap[ia * N], bv[ib * N], bp[ib * N])) {
        v = av[ia * N];
        p = ap[N * ia++];
      } else {
        v = bv[ib * N];
        p = bp[N * ib++];
      }
      out_v[row * k + j] = v;
      out_i[row * k + j] = p == kNoPos ? -1 : idp[p];
    }
  }
}

// The 3-D map (d, rows, K) of one operand, box (64, box_rows, 1); elements
// outside the tensor read as zero.
cudaError_t make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem,
                     int d, int rows, int K, int box_rows, CUtensorMapSwizzle swizzle) {
  repro::EncodeTiledFn encode = repro::encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t pitch = static_cast<cuuint64_t>(d) * elem;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(K)};
  cuuint64_t strides[2] = {pitch, pitch * rows};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(kSlice), static_cast<cuuint32_t>(box_rows), 1};
  cuuint32_t es[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, es,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
  const void *buf, *w;
  const float* g_buf;
  const int* ids;
  const float* scales;
  float *out_v, *part_v;
  int *out_i, *part_i;
  int K, C, v_pad, d, k, nsplit, tiles_per_split, stages;
  cudaStream_t stream;
};

template <int N, bool Q>
cudaError_t launch(const Args& a) {
  CUtensorMap mw, mx;
  cudaError_t err =
      make_map(&mw, a.w, Q ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               Q ? 1 : 2, a.d, a.v_pad, a.K, kRows,
               Q ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_map(&mx, a.buf, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.d, a.C, a.K, N,
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
  kern<<<grid, kThreads, smem, a.stream>>>(mw, mx, a.g_buf, a.ids, a.scales, dst_v, dst_i, a.K,
                                           a.C, a.v_pad, a.d, a.k, a.tiles_per_split, a.stages);
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

// The tiled body. wdtype as above; part_v, part_i (nsplit, K, C, k) are
// scratch when nsplit > 1; tb, nsplit and tiles_per_split come from
// kernels/dss_topk_grouped.py::tiled_plan.
extern "C" int dss_topk_grouped_tiled(const void* buf, const void* g_buf,
                                const void* w, const void* ids,
                                const void* scales, void* out_v, void* out_i,
                                void* part_v, void* part_i, int K, int C,
                                int v_pad, int d, int k, int tb, int nsplit,
                                int tiles_per_split, int dtype, int wdtype,
                                void* stream) {
  if (k < 1 || k > repro::kMaxK || k > v_pad || K < 1 || C < 1 || d < 1 ||
      nsplit < 1 || tiles_per_split < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(g_buf);
  const int* id = static_cast<const int*>(ids);
  const float* sc = static_cast<const float*>(scales);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  if (wdtype != dtype && wdtype != repro::kDtypeI8) return cudaErrorInvalidValue;
  if (dtype == repro::kDtypeF32)
    return dispatch_w<float>(wdtype, tb, buf, g, w, id, sc, ov, oi, pv, pi, K, C,
                             v_pad, d, k, nsplit, tiles_per_split, s);
  if (dtype == repro::kDtypeBF16)
    return dispatch_w<__nv_bfloat16>(wdtype, tb, buf, g, w, id, sc, ov, oi, pv,
                                     pi, K, C, v_pad, d, k, nsplit,
                                     tiles_per_split, s);
  return cudaErrorInvalidValue;
}


// The tensor-core body: bf16 tokens with bf16 rows (wdtype kDtypeBF16,
// scales null) or int8 rows (kDtypeI8, (K, v_pad) fp32 scales). d a
// multiple of 8 (16 for int8 rows) and 16-byte aligned buf and weights, as
// TMA requires. part_v, part_i (nsplit, K, C, k) are scratch when nsplit >
// 1; n_tile (16, 32, 64, 128 or 256), nsplit, tiles_per_split and stages
// come from kernels/dss_topk_grouped.py::wgmma_plan.
extern "C" int dss_topk_grouped_wgmma(const void* buf, const void* g_buf, const void* w,
                                      const void* ids, const void* scales, void* out_v,
                                      void* out_i, void* part_v, void* part_i, int K, int C,
                                      int v_pad, int d, int k, int n_tile, int nsplit,
                                      int tiles_per_split, int stages, int wdtype, void* stream) {
  const bool q = wdtype == repro::kDtypeI8;
  if (k < 1 || k > repro::kMaxK || k > v_pad || K < 1 || K > 65535 || C < 1 || d < 1 ||
      nsplit < 1 || nsplit > 65535 || tiles_per_split < 1 || stages < 2 || stages > 4 ||
      (C + n_tile - 1) / std::max(n_tile, 1) > 65535)
    return cudaErrorInvalidValue;
  if (!q && wdtype != repro::kDtypeBF16) return cudaErrorInvalidValue;
  if (q != (scales != nullptr) || d % (q ? 16 : 8) != 0 ||
      reinterpret_cast<uintptr_t>(buf) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  const wg::Args a{buf, w, static_cast<const float*>(g_buf), static_cast<const int*>(ids),
                   static_cast<const float*>(scales), static_cast<float*>(out_v),
                   static_cast<float*>(part_v), static_cast<int*>(out_i),
                   static_cast<int*>(part_i), K, C, v_pad, d, k, nsplit, tiles_per_split,
                   stages, static_cast<cudaStream_t>(stream)};
  return q ? wg::launch_n<true>(n_tile, a) : wg::launch_n<false>(n_tile, a);
}
