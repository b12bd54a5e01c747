// Expert-grouped DS-Softmax retrieval for Hopper (sm_90a), two bodies.
//
// Replaces: src/repro/kernels/dss_topk_grouped.py::dss_topk_grouped
// (Pallas, TPU; both bodies: `_kernel` for f32/bf16 rows and `_kernel_q`
// for int8 rows with per-row fp32 scales). Per expert e and token slot c:
// z = buf[e, c] . weights[e, v] in fp32, then z *= scales[e, v] (int8
// rows), then z *= g_buf[e, c], padding rows (ids == -1) -> -1e9, top-k
// over v with ties to the lowest packed position. Outputs (K, C, k) fp32
// values and int32 class ids; padding rows come out as exactly (-1e9, -1).
// int8 rows are widened to fp32 like the tokens; an int8 x int8 tensor-core
// product would need the tokens quantized, which is not the reference's
// function. The wrapper (kernels/dss_topk_grouped.py::select_body) picks a
// body by the capacity C alone.
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
// dss_topk_grouped_tiled, the tiled body (prefill capacities, C in the
// hundreds). Bound: operations, 2*K*C*V_pad*d FLOPs. The TPU grid carried
// the top-k across vocab blocks in VMEM; Hopper blocks run in parallel and
// carry nothing, so a block owns one (expert, token tile, vocab split) and
// loops over the split's vocab tiles itself, keeping the running top-k in
// shared memory (topk_common.cuh). Each weight tile is read once per token
// tile and used by every token in it. Vocab splits (chosen by the wrapper
// to fill the 132 SMs) write partial lists that a second small kernel
// merges in split order. The product runs on CUDA cores in fp32 FMA;
// tensor cores (wgmma) are later work.
#include "retrieve_stream.cuh"

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
