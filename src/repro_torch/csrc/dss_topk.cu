// Per-token DS-Softmax retrieval for Hopper (sm_90a), fp tables only.
//
// Replaces: src/repro/kernels/dss_topk.py::dss_topk (Pallas, TPU; body
// `_kernel`). Per token b with expert e = expert_idx[b]:
// z = h_scaled[b] . weights[e, v] in fp32 (the gate value is already
// folded into h_scaled by the wrapper, rounded to h's dtype as the
// reference rounds it), padding rows (ids == -1) -> -1e9, top-k over v with
// ties to the lowest packed position. Outputs (B, k) fp32 values and int32
// class ids. An expert with fewer than k real rows fills the tail with its
// padding rows, (-1e9, -1); the TPU kernel's in-block loop emits duplicate
// real ids there instead, which depends on its block size. An expert id
// outside [0, K) emits (-inf, -1).
//
// Bound on this card: bytes. Each token streams its own expert's rows,
// (V_pad, d) elements, so B tokens read up to B expert tables; the
// arithmetic is 2*B*V_pad*d FLOPs, one FMA per element read.
// Design: the TPU kernel spilled a (B, n_blocks, k) candidate list to HBM
// and merged it with a second top_k. Here block (token, vocab split) runs
// the retrieval body shared with the grouped and fused kernels
// (topk_common.cuh) over its split's vocab tiles with one token, keeping
// the running top-k in shared memory; the wrapper splits the vocab so that
// about two blocks per SM have work, and the split merge writes (B, k)
// directly. The 16-token tile holds one token, so the body's FMAs are
// mostly idle; its loads, which bound it, are not.
#include "topk_common.cuh"

namespace {

using repro::TileSmem;
constexpr int kTB = 16;  // the retrieval body's smallest token tile

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
pertoken_kernel(const T* __restrict__ w, const int* __restrict__ ids,
                const T* __restrict__ h, const int* __restrict__ expert_idx,
                float* __restrict__ out_v, int* __restrict__ out_i, int K,
                int B, int v_pad, int d, int k, int tiles_per_split) {
  extern __shared__ __align__(16) char smem[];
  const TileSmem<kTB> s = TileSmem<kTB>::carve(smem, k);
  const int b = blockIdx.x, sp = blockIdx.y;
  const int e = expert_idx[b];
  const size_t out_row = (static_cast<size_t>(sp) * B + b) * k;
  if (e < 0 || e >= K) {  // block-uniform: every thread leaves here
    for (int j = threadIdx.x; j < k; j += repro::kThreads) {
      out_v[out_row + j] = -CUDART_INF_F;
      out_i[out_row + j] = -1;
    }
    return;
  }
  if (threadIdx.x < kTB) {
    s.tok_off[threadIdx.x] = static_cast<long long>(b) * d;
    s.g[threadIdx.x] = 1.f;  // g is in h_scaled already; z * 1 is exact
  }
  repro::init_topk(s, k);
  __syncthreads();
  const int v_lo = sp * tiles_per_split * repro::kTV;
  const int v_hi = min(v_pad, v_lo + tiles_per_split * repro::kTV);
  const size_t e_row = static_cast<size_t>(e) * v_pad;
  repro::retrieve_tile<T, T, kTB>(s, h, 1, w + e_row * d, ids + e_row, nullptr,
                                  v_lo, v_hi, d, k);
  for (int j = threadIdx.x; j < k; j += repro::kThreads) {
    out_v[out_row + j] = s.top_v[j];
    out_i[out_row + j] = s.top_i[j];
  }
}

template <typename T>
cudaError_t launch(const void* w, const int* ids, const void* h,
                   const int* expert_idx, float* out_v, int* out_i,
                   float* part_v, int* part_i, int K, int B, int v_pad, int d,
                   int k, int nsplit, int tiles_per_split, cudaStream_t stream) {
  const size_t smem = TileSmem<kTB>::bytes(k);
  auto kern = pertoken_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B, nsplit);
  float* dst_v = nsplit > 1 ? part_v : out_v;
  int* dst_i = nsplit > 1 ? part_i : out_i;
  kern<<<grid, repro::kThreads, smem, stream>>>(
      static_cast<const T*>(w), ids, static_cast<const T*>(h), expert_idx,
      dst_v, dst_i, K, B, v_pad, d, k, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return repro::launch_merge(part_v, part_i, out_v, out_i, B, k, nsplit, stream);
}

}  // namespace

extern "C" int dss_topk(const void* w, const void* ids, const void* h_scaled,
                        const void* expert_idx, void* out_v, void* out_i,
                        void* part_v, void* part_i, int K, int B, int v_pad,
                        int d, int k, int nsplit, int tiles_per_split, int dtype,
                        void* stream) {
  if (k < 1 || k > repro::kMaxK || k > v_pad || K < 1 || B < 0 || d < 1 ||
      nsplit < 1 || nsplit > 65535 || tiles_per_split < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const int* ei = static_cast<const int*>(expert_idx);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  if (dtype == repro::kDtypeF32)
    return launch<float>(w, id, h_scaled, ei, ov, oi, pv, pi, K, B, v_pad, d, k,
                         nsplit, tiles_per_split, s);
  if (dtype == repro::kDtypeBF16)
    return launch<__nv_bfloat16>(w, id, h_scaled, ei, ov, oi, pv, pi, K, B,
                                 v_pad, d, k, nsplit, tiles_per_split, s);
  return cudaErrorInvalidValue;
}
