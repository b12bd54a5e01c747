// Expert-grouped DS-Softmax retrieval for Hopper (sm_90a).
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
// function.
//
// Bound on this card: at decode capacities (C of a few slots) it is
// bytes, the (K, V_pad, d) table streamed once (1 byte per element plus a
// 4-byte scale per row for int8); at prefill capacities (C in the
// hundreds) it is operations, 2*K*C*V_pad*d FLOPs.
// Design: the TPU grid carried the top-k across vocab blocks in VMEM;
// Hopper blocks run in parallel and carry nothing, so a block owns one
// (expert, token tile, vocab split) and loops over the split's vocab
// tiles itself, keeping the running top-k in shared memory (topk_common.cuh).
// Each weight tile is read once per token tile and used by every token
// in it. Vocab splits (chosen by the wrapper to fill the 132 SMs) write
// partial lists that a second small kernel merges in split order. The
// product runs on CUDA cores in fp32 FMA; tensor cores (wgmma) are later
// work.
#include "topk_common.cuh"

namespace {

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

}  // namespace

// wdtype: the rows' dtype code, either dtype (f32/bf16 rows, scales null)
// or kDtypeI8 (int8 rows with (K, v_pad) fp32 scales).
extern "C" int dss_topk_grouped(const void* buf, const void* g_buf,
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
