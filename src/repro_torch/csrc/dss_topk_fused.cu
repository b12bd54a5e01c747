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
// CUDA cores' 20 flop/byte ridge, so the design spends itself on the loads.
//
// Design: three launches, no host sync, no allocation.
// 1. gate_kernel, one 8-warp block per token: the logits through
//    repro::gate_logits (gate_top1.cu's summation tree, 16-byte loads when
//    aligned), the first argmax and g, written once to out_e and scratch.
// 2. and 3. the streaming retrieval and its merge (retrieve_stream.cuh)
//    over the token source GateTokens: slot t is token t of the expert the
//    gate chose, so the work list holds the chosen local experts, each
//    streamed once per group of up to tb of its tokens; a token whose
//    expert is not local emits (-inf, -1).
#include "retrieve_stream.cuh"

namespace {

using repro::stream::GateTokens;
using repro::stream::kFull;
using repro::stream::kThreads;
using repro::stream::kWarps;

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

struct Args {
  const void *gate_w, *w, *h;
  const int* ids;
  const float* scales;
  float *out_v, *g, *part_v;
  int *out_i, *out_e, *part_p, *n_sel;
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
  const GateTokens<TX> src{h, a.g, a.out_e, a.B, a.K, a.e_base};
  return repro::stream::launch_retrieve<GateTokens<TX>, TW, VB>(
      src, static_cast<const TW*>(a.w), a.ids, a.scales, a.part_v, a.part_p, a.n_sel, a.out_v,
      a.out_i, a.B, a.K, a.v_pad, a.d, a.k, a.grid, a.stream);
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
// part_p (nchunks, B, k), n_sel (1,) are scratch, nchunks the chunks of one
// expert when a single expert is chosen (the most there can be). grid and
// vb come from kernels/dss_topk_fused.py::launch_plan.
extern "C" int dss_topk_fused(const void* gate_w, const void* w, const void* ids,
                              const void* scales, const void* h, void* out_v, void* out_i,
                              void* out_e, void* g, void* part_v, void* part_p, void* n_sel,
                              int K_real, int K, int B, int v_pad, int d, int k, int e_base,
                              int grid, int vb, int dtype, int wdtype, void* stream) {
  if (k < 1 || k > repro::kMaxK || k > v_pad || K < 1 || K_real < 1 ||
      K_real > repro::kMaxK || B < 0 || d < 1 || grid < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  if (wdtype != dtype && wdtype != repro::kDtypeI8) return cudaErrorInvalidValue;
  const int wbytes = wdtype == repro::kDtypeI8 ? 1 : (wdtype == repro::kDtypeF32 ? 4 : 2);
  if (!repro::stream::stream_args_ok(w, d, wbytes, vb, k, K)) return cudaErrorInvalidValue;
  const Args a{gate_w, w, h, static_cast<const int*>(ids), static_cast<const float*>(scales),
               static_cast<float*>(out_v), static_cast<float*>(g), static_cast<float*>(part_v),
               static_cast<int*>(out_i), static_cast<int*>(out_e), static_cast<int*>(part_p),
               static_cast<int*>(n_sel), K_real, K, B, v_pad, d, k, e_base, grid, vb,
               static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kDtypeF32) return dispatch_w<float>(wdtype, a);
  if (dtype == repro::kDtypeBF16) return dispatch_w<__nv_bfloat16>(wdtype, a);
  return cudaErrorInvalidValue;
}
