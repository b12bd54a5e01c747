// Single-launch gate -> dispatch -> retrieve DS-Softmax decode kernel for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dss_topk_fused.py::dss_topk_fused (Pallas,
// TPU; both bodies: `_kernel` for f32/bf16 rows and `_kernel_q` for int8
// rows with per-row fp32 scales). Prologue per token: fp32 gate logits
// over the K_real gate rows (gate and tokens in the token dtype), the
// FIRST argmax of the logits, and g = 1 / sum(exp(l - max)). Body:
// retrieval over the selected expert's packed rows, the row scale (int8)
// and then g applied to the fp32 logits after the product, padding
// rows -> -1e9, top-k with ties to the lowest packed position. Outputs
// (B, k) values and class ids plus the (B,) GLOBAL expert id; a token
// whose expert lies outside [e_base, e_base + K) emits (-inf, -1).
//
// Bound on this card: bytes. At decode shapes the work is the selected
// experts' rows, read once per token tile (int8: 1 byte per element plus a
// 4-byte scale per row).
// Design: the TPU kernel streamed every expert and masked the foreign
// ones to -inf; here block (token tile, expert e, vocab split) runs the
// gating for its tile (the same warp routine as gate_top1.cu), keeps
// only the tokens that chose expert e, and returns early when there are
// none, so only selected experts' rows are read. The retrieval body and
// the split merge are shared with dss_topk_grouped.cu (topk_common.cuh).
#include "topk_common.cuh"

namespace {

using repro::TileSmem;
constexpr int kTB = 16;  // tokens per tile (one gating pass per tile)

__host__ __device__ size_t gate_smem_bytes(int K_real) {
  return sizeof(float) * (kTB * K_real + 2 * kTB) + sizeof(int) * (2 * kTB + 1);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(repro::kThreads)
fused_kernel(const TX* __restrict__ gate_w, const TW* __restrict__ w,
             const int* __restrict__ ids, const float* __restrict__ scales,
             const TX* __restrict__ h, float* __restrict__ out_v,
             int* __restrict__ out_i,
             int* __restrict__ out_e, int K_real, int K, int B, int v_pad,
             int d, int k, int e_base, int tiles_per_split) {
  extern __shared__ __align__(16) char smem[];
  const TileSmem<kTB> s = TileSmem<kTB>::carve(smem, k);
  float* glog = reinterpret_cast<float*>(smem + TileSmem<kTB>::bytes(k));
  float* gval = glog + kTB * K_real;  // [kTB] 1 / sum exp
  int* sel = reinterpret_cast<int*>(gval + kTB);  // [kTB] global expert
  int* tok_idx = sel + kTB;                       // [kTB] compacted tokens
  int* n_mine = tok_idx + kTB;                    // [1]

  const int b0 = blockIdx.x * kTB, e = blockIdx.y, sp = blockIdx.z;
  const int n_in = min(kTB, B - b0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < n_in; t += repro::kThreads / 32) {
    float* z = glog + t * K_real;
    repro::warp_gate_logits(h + static_cast<size_t>(b0 + t) * d, gate_w, K_real, d, z);
    if (lane == 0) {
      float m = z[0];
      int arg = 0;
      for (int j = 1; j < K_real; ++j)
        if (z[j] > m) {
          m = z[j];
          arg = j;
        }
      float sum = 0.f;
      for (int j = 0; j < K_real; ++j) sum += expf(z[j] - m);
      sel[t] = arg;
      gval[t] = 1.f / sum;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < n_in; ++t)
      if (sel[t] - e_base == e) {
        s.tok_off[n] = static_cast<long long>(b0 + t) * d;
        s.g[n] = gval[t];
        tok_idx[n] = b0 + t;
        ++n;
      }
    *n_mine = n;
  }
  if (e == 0) {
    // tokens owned by no local expert: (-inf, -1) rows in every split
    for (int i = threadIdx.x; i < n_in * k; i += repro::kThreads) {
      const int t = i / k, j = i % k;
      const int local = sel[t] - e_base;
      if (local < 0 || local >= K) {
        const size_t row = static_cast<size_t>(sp) * B + b0 + t;
        out_v[row * k + j] = -CUDART_INF_F;
        out_i[row * k + j] = -1;
      }
    }
    if (sp == 0 && threadIdx.x < n_in) out_e[b0 + threadIdx.x] = sel[threadIdx.x];
  }
  repro::init_topk(s, k);
  __syncthreads();
  const int n_tok = *n_mine;
  if (n_tok == 0) return;
  const int v_lo = sp * tiles_per_split * repro::kTV;
  const int v_hi = min(v_pad, v_lo + tiles_per_split * repro::kTV);
  const size_t e_row = static_cast<size_t>(e) * v_pad;
  repro::retrieve_tile<TX, TW, kTB>(s, h, n_tok, w + e_row * d, ids + e_row,
                                    scales != nullptr ? scales + e_row : nullptr,
                                    v_lo, v_hi, d, k);
  for (int i = threadIdx.x; i < n_tok * k; i += repro::kThreads) {
    const int t = i / k, j = i % k;
    const size_t row = static_cast<size_t>(sp) * B + tok_idx[t];
    out_v[row * k + j] = s.top_v[t * k + j];
    out_i[row * k + j] = s.top_i[t * k + j];
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* gate_w, const void* w, const int* ids,
                   const float* scales, const void* h, float* out_v,
                   int* out_i, int* out_e, float* part_v, int* part_i,
                   int K_real, int K, int B, int v_pad, int d, int k,
                   int e_base, int nsplit, int tiles_per_split,
                   cudaStream_t stream) {
  const size_t smem = TileSmem<kTB>::bytes(k) + gate_smem_bytes(K_real);
  auto kern = fused_kernel<TX, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kTB - 1) / kTB, K, nsplit);
  float* dst_v = nsplit > 1 ? part_v : out_v;
  int* dst_i = nsplit > 1 ? part_i : out_i;
  kern<<<grid, repro::kThreads, smem, stream>>>(
      static_cast<const TX*>(gate_w), static_cast<const TW*>(w), ids, scales,
      static_cast<const TX*>(h), dst_v, dst_i, out_e, K_real, K, B, v_pad, d, k,
      e_base, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return repro::launch_merge(part_v, part_i, out_v, out_i, B, k, nsplit, stream);
}

// Token type TX with rows of the token type, or int8 rows with scales.
template <typename TX>
cudaError_t dispatch_w(int wdtype, const void* gate_w, const void* w,
                       const int* ids, const float* scales, const void* h,
                       float* out_v, int* out_i, int* out_e, float* part_v,
                       int* part_i, int K_real, int K, int B, int v_pad, int d,
                       int k, int e_base, int nsplit, int tps, cudaStream_t s) {
  if (wdtype == repro::kDtypeI8) {
    if (scales == nullptr) return cudaErrorInvalidValue;
    return launch<TX, int8_t>(gate_w, w, ids, scales, h, out_v, out_i, out_e,
                              part_v, part_i, K_real, K, B, v_pad, d, k, e_base,
                              nsplit, tps, s);
  }
  if (scales != nullptr) return cudaErrorInvalidValue;
  return launch<TX, TX>(gate_w, w, ids, nullptr, h, out_v, out_i, out_e, part_v,
                        part_i, K_real, K, B, v_pad, d, k, e_base, nsplit, tps, s);
}

}  // namespace

// wdtype: the rows' dtype code, either dtype (f32/bf16 rows, scales null)
// or kDtypeI8 (int8 rows with (K, v_pad) fp32 scales).
extern "C" int dss_topk_fused(const void* gate_w, const void* w,
                              const void* ids, const void* scales,
                              const void* h, void* out_v, void* out_i,
                              void* out_e, void* part_v, void* part_i,
                              int K_real, int K, int B, int v_pad, int d, int k,
                              int e_base, int nsplit, int tiles_per_split,
                              int dtype, int wdtype, void* stream) {
  if (k < 1 || k > repro::kMaxK || k > v_pad || K < 1 || K_real < 1 ||
      K_real > repro::kMaxK || B < 0 || d < 1 || nsplit < 1 ||
      tiles_per_split < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  int* oe = static_cast<int*>(out_e);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  const float* sc = static_cast<const float*>(scales);
  if (wdtype != dtype && wdtype != repro::kDtypeI8) return cudaErrorInvalidValue;
  if (dtype == repro::kDtypeF32)
    return dispatch_w<float>(wdtype, gate_w, w, id, sc, h, ov, oi, oe, pv, pi,
                             K_real, K, B, v_pad, d, k, e_base, nsplit,
                             tiles_per_split, s);
  if (dtype == repro::kDtypeBF16)
    return dispatch_w<__nv_bfloat16>(wdtype, gate_w, w, id, sc, h, ov, oi, oe,
                                     pv, pi, K_real, K, B, v_pad, d, k, e_base,
                                     nsplit, tiles_per_split, s);
  return cudaErrorInvalidValue;
}
