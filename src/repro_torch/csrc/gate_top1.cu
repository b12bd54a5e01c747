// Fused top-1 gate for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gate_top1.py::gate_top1 (Pallas, TPU).
// Computes, per token: fp32 logits z = h . U^T over K <= 64 gate rows,
// p = softmax(z) = expf(z - m) / sum expf(z - m), idx = the first argmax of
// p (ties to the lowest expert), g = max p (not renormalized).
//
// Bound on this card: bytes (B 8, K 16, d 1536 bf16: 74 KB, 0.02 us, so
// the launch sets the time). Every caller passes one row per sequence: the
// last position of one prompt at prefill (B 1), the resident slots at
// decode (B <= n_slots), so no path gives the gate a prefill-sized B.
//
// Design: one block of 8 warps per token, B blocks, so B SMs work. The
// experts are split across the warps (warp w takes experts w, w + 8, ...),
// each warp's experts independent accumulators. Every logit is the same
// fp32 sum in the same order whatever the expert: lane l of a warp sums the
// 16-byte vectors l, l + 32, ... of h . U[e] (fmaf over the vector's
// elements in order), then a butterfly over the 32 lanes. So two identical
// gate rows give identical logits, and the tie goes to the lower expert.
// - Loads are 16 bytes (8 bf16 or 4 fp32 per lane) when d and both base
//   pointers allow it, else one element (the same order, VEC = false).
// - The K-wide softmax and argmax run across the lanes (expert l and l + 32
//   on lane l) with shuffles.
#include "topk_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Softmax over z[0..K) (K <= 64) by one warp; lane 0 writes the first
// argmax of p and max p.
__device__ __forceinline__ void warp_top1(const float* z, int K, int* idx, float* g) {
  const int lane = threadIdx.x & 31;
  const bool has0 = lane < K, has1 = lane + 32 < K;
  const float z0 = has0 ? z[lane] : -CUDART_INF_F;
  const float z1 = has1 ? z[lane + 32] : -CUDART_INF_F;
  float m = fmaxf(z0, z1);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float e0 = has0 ? expf(z0 - m) : 0.f;
  const float e1 = has1 ? expf(z1 - m) : 0.f;
  const float sum = repro::warp_sum(e0 + e1);
  float best = has0 ? e0 / sum : -1.f;
  int arg = lane;
  if (has1) {
    const float p1 = e1 / sum;
    if (p1 > best) best = p1, arg = lane + 32;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    if (ob > best || (ob == best && oa < arg)) best = ob, arg = oa;
  }
  if (lane == 0) {
    *idx = arg;
    *g = best;
  }
}

// Block b is token b; warp w computes the logits of experts w, w + 8, ...
// (at most 8 each).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
gate_top1_kernel(const T* __restrict__ gate_w, const T* __restrict__ h, int* __restrict__ idx,
                 float* __restrict__ g, int K, int d) {
  __shared__ float z[repro::kMaxK];
  const int b = blockIdx.x;
  repro::gate_logits<T, VEC ? 16 : static_cast<int>(sizeof(T)), kWarps>(
      gate_w, h + static_cast<size_t>(b) * d, K, d, z);
  __syncthreads();
  if (threadIdx.x < 32) warp_top1(z, K, idx + b, g + b);
}

template <typename T, bool VEC>
cudaError_t launch(const void* gate_w, const void* h, int* idx, float* g, int B, int K, int d,
                   cudaStream_t stream) {
  gate_top1_kernel<T, VEC><<<B, kThreads, 0, stream>>>(
      static_cast<const T*>(gate_w), static_cast<const T*>(h), idx, g, K, d);
  return cudaGetLastError();
}

// 16-byte loads when both base pointers and the row pitch allow them.
template <typename T>
cudaError_t dispatch(const void* gate_w, const void* h, int* idx, float* g, int B, int K, int d,
                     cudaStream_t s) {
  const bool vec = (reinterpret_cast<uintptr_t>(gate_w) | reinterpret_cast<uintptr_t>(h)) % 16 ==
                       0 &&
                   (d * sizeof(T)) % 16 == 0;
  return vec ? launch<T, true>(gate_w, h, idx, g, B, K, d, s)
             : launch<T, false>(gate_w, h, idx, g, B, K, d, s);
}

}  // namespace

extern "C" int gate_top1(const void* gate_w, const void* h, void* idx, void* g,
                         int B, int K, int d, int dtype, void* stream) {
  if (K < 1 || K > repro::kMaxK || B < 0 || d < 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* i = static_cast<int*>(idx);
  float* gv = static_cast<float*>(g);
  if (dtype == repro::kDtypeF32) return dispatch<float>(gate_w, h, i, gv, B, K, d, s);
  if (dtype == repro::kDtypeBF16) return dispatch<__nv_bfloat16>(gate_w, h, i, gv, B, K, d, s);
  return cudaErrorInvalidValue;
}
