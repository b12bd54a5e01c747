// Fused top-1 gate for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gate_top1.py::gate_top1 (Pallas, TPU).
// Computes, per token: fp32 logits z = h . U^T over K <= 64 gate rows,
// p = softmax(z), idx = first argmax of p, g = max p (not renormalized).
//
// Bound on this card: bytes. Each token row is read once (B*d elements)
// and the (K, d) gate matrix stays in L1/L2; the arithmetic is 2*B*K*d
// FLOPs, far below the card's rate for any B the serve path gives it.
// Design: one warp per token, lanes stride over d so a warp's loads are
// contiguous; a butterfly reduction gives every lane the logit; lane 0
// runs the K-wide softmax in registers. No shared-memory staging.
#include "topk_common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gate_top1_kernel(const T* __restrict__ gate_w, const T* __restrict__ h,
                 int* __restrict__ idx, float* __restrict__ g, int B, int K,
                 int d) {
  __shared__ float z_s[kWarps][repro::kMaxK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;
  float* z = z_s[warp];
  repro::warp_gate_logits(h + static_cast<size_t>(b) * d, gate_w, K, d, z);
  if (lane != 0) return;
  float m = z[0];
  for (int e = 1; e < K; ++e) m = fmaxf(m, z[e]);
  float sum = 0.f;
  for (int e = 0; e < K; ++e) sum += expf(z[e] - m);
  float best = -1.f;
  int arg = 0;
  for (int e = 0; e < K; ++e) {
    const float p = expf(z[e] - m) / sum;
    if (p > best) {
      best = p;
      arg = e;
    }
  }
  idx[b] = arg;
  g[b] = best;
}

template <typename T>
cudaError_t launch(const void* gate_w, const void* h, int* idx, float* g,
                   int B, int K, int d, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  gate_top1_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(gate_w), static_cast<const T*>(h), idx, g, B, K, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gate_top1(const void* gate_w, const void* h, void* idx, void* g,
                         int B, int K, int d, int dtype, void* stream) {
  if (K < 1 || K > repro::kMaxK || B < 0 || d < 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* i = static_cast<int*>(idx);
  float* gv = static_cast<float*>(g);
  if (dtype == repro::kDtypeF32) return launch<float>(gate_w, h, i, gv, B, K, d, s);
  if (dtype == repro::kDtypeBF16) return launch<__nv_bfloat16>(gate_w, h, i, gv, B, K, d, s);
  return cudaErrorInvalidValue;
}
