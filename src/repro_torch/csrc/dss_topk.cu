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
// Bound on this card: bytes. Tokens share experts, so the work is the rows
// of the experts that hold a token, each to be read once per call; the
// fp32 products are 1 flop per row byte and token (bf16), below the CUDA
// cores' ridge.
// Design: the TPU kernel spilled a (B, n_blocks, k) candidate list to HBM
// and merged it with a second top_k. Here the streaming retrieval of the
// decode kernels (retrieve_stream.cuh) runs over the token source
// ExpertTokens: slot t is row t of h_scaled with gate value 1, so a fixed
// grid of two blocks per SM builds the work list of the experts that hold a
// token on the device, streams each one's rows once per group of up to tb
// of its tokens through a ring of asynchronous copies, and the merge writes
// (B, k) directly. Two launches, no host sync, no allocation.
#include "retrieve_stream.cuh"

namespace {

using repro::stream::ExpertTokens;

template <typename T, int VB>
cudaError_t launch(const void* w, const int* ids, const void* h, const int* expert_idx,
                   float* out_v, int* out_i, float* part_v, int* part_p, int* n_sel, int K, int B,
                   int v_pad, int d, int k, int grid, cudaStream_t stream) {
  const ExpertTokens<T> src{static_cast<const T*>(h), expert_idx, B, K};
  return repro::stream::launch_retrieve<ExpertTokens<T>, T, VB>(
      src, static_cast<const T*>(w), ids, nullptr, part_v, part_p, n_sel, out_v, out_i, B, K,
      v_pad, d, k, grid, stream);
}

// Row vectors of VB bytes: 16 or 4, or one element.
template <typename T>
cudaError_t dispatch_vb(int vb, const void* w, const int* ids, const void* h, const int* e,
                        float* ov, int* oi, float* pv, int* pp, int* ns, int K, int B, int v_pad,
                        int d, int k, int grid, cudaStream_t s) {
  if (vb == 16) return launch<T, 16>(w, ids, h, e, ov, oi, pv, pp, ns, K, B, v_pad, d, k, grid, s);
  if (vb == 4) return launch<T, 4>(w, ids, h, e, ov, oi, pv, pp, ns, K, B, v_pad, d, k, grid, s);
  if constexpr (sizeof(T) < 4) {
    if (vb == static_cast<int>(sizeof(T)))
      return launch<T, static_cast<int>(sizeof(T))>(w, ids, h, e, ov, oi, pv, pp, ns, K, B, v_pad,
                                                    d, k, grid, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// w (K, v_pad, d) and h_scaled (B, d) in `dtype`; part_v and part_p
// (chunks of one expert when a single expert holds every token, B, k) and
// n_sel (1,) are scratch. grid and vb come from
// kernels/dss_topk.py::launch_plan.
extern "C" int dss_topk(const void* w, const void* ids, const void* h_scaled,
                        const void* expert_idx, void* out_v, void* out_i, void* part_v,
                        void* part_p, void* n_sel, int K, int B, int v_pad, int d, int k,
                        int grid, int vb, int dtype, void* stream) {
  if (k < 1 || k > repro::kMaxK || k > v_pad || K < 1 || B < 0 || d < 1 || grid < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int wbytes = dtype == repro::kDtypeF32 ? 4 : 2;
  if (!repro::stream::stream_args_ok(w, d, wbytes, vb, k, K)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const int* ei = static_cast<const int*>(expert_idx);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  float* pv = static_cast<float*>(part_v);
  int* pp = static_cast<int*>(part_p);
  int* ns = static_cast<int*>(n_sel);
  if (dtype == repro::kDtypeF32)
    return dispatch_vb<float>(vb, w, id, h_scaled, ei, ov, oi, pv, pp, ns, K, B, v_pad, d, k,
                              grid, s);
  if (dtype == repro::kDtypeBF16)
    return dispatch_vb<__nv_bfloat16>(vb, w, id, h_scaled, ei, ov, oi, pv, pp, ns, K, B, v_pad, d,
                                      k, grid, s);
  return cudaErrorInvalidValue;
}
