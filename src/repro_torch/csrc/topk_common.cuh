// Shared device code of the DS-Softmax kernels (sm_90a): the dtype codes,
// the widening vector loads Vec<T, VB> (the gate logits and
// retrieve_stream.cuh; unpack also in dss_topk_grouped.cu), the gate
// logits, the mbarrier helpers and the split merge of the bodies that
// split the vocab.
//
// Order of operations (every path of the port follows it): z = x . w in
// fp32 (bf16 operands are widened, so each product is exact; int8 rows are
// widened too, which equals the reference's cast to the token dtype since
// |q| <= 127), then z *= scale[row] for int8 rows, then z *= g, each on
// the fp32 accumulator after the product (fp32 multiplication is not
// associative, so this order is fixed), padding rows (id -1) -> -1e9.
// Every top-k is ordered by (value desc, packed position asc), so equal
// values go to the lowest position. Empty list entries hold -inf, below the
// -1e9 padding value, so none is emitted while the rows scanned number at
// least k.
#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace repro {

constexpr float kNegInfMask = -1e9f;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kDtypeI8 = 2;    // table rows only, with per-row fp32 scales
constexpr int kMaxK = 64;      // largest top-k width the kernels take

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// VB bytes at p (VB = 16 or 4, or one element, VB = sizeof(T)) widened to
// N = VB / sizeof(T) fp32 values in memory order. int8 bytes become floats
// exactly through the 2^23 trick: (b ^ 0x80) in the low byte of 2^23's bit
// pattern is 2^23 + 128 + b, minus 2^23 + 128 (one byte_perm and one
// subtract per element).
__device__ __forceinline__ void unpack(uint32_t w, float* x, float) { x[0] = __uint_as_float(w); }
__device__ __forceinline__ void unpack(uint32_t w, float* x, __nv_bfloat16) {
  x[0] = __uint_as_float(w << 16);          // element 0 (low half)
  x[1] = __uint_as_float(w & 0xffff0000u);  // element 1
}
__device__ __forceinline__ void unpack(uint32_t w, float* x, int8_t) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    x[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388736.f;
}

template <typename T, int VB>
struct Vec {
  static constexpr int N = VB / static_cast<int>(sizeof(T));
  static_assert(VB == 16 || VB == 4 || VB == static_cast<int>(sizeof(T)), "vector width");
  // the loaded bytes, kept raw until they are used
  using Raw = std::conditional_t<
      VB == 16, uint4, std::conditional_t<(VB == 4 && sizeof(T) < 4), uint32_t, T>>;
  __device__ __forceinline__ static Raw fetch(const T* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ static void widen(const Raw& r, float (&x)[N]) {
    if constexpr (VB == 16) {
      constexpr int E = N / 4;  // elements per 32-bit word
      unpack(r.x, x, T{});
      unpack(r.y, x + E, T{});
      unpack(r.z, x + 2 * E, T{});
      unpack(r.w, x + 3 * E, T{});
    } else if constexpr (VB == 4 && sizeof(T) < 4) {
      unpack(r, x, T{});
    } else {
      x[0] = to_f32(r);
    }
  }
  __device__ __forceinline__ static void load(const T* p, float (&x)[N]) { widen(fetch(p), x); }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// fp32 gate logits of one token against K <= 64 gate rows, by the WARPS
// warps of the block: warp w takes experts w, w + WARPS, ...; lane l sums
// the VB-byte vectors l, l + 32, ... of h . U[e] (fmaf over each vector's
// elements in order), then a butterfly over the 32 lanes, which leaves the
// same sum on every lane. So every logit is the same fp32 sum in the same
// order whatever warp computes it, and identical gate rows tie exactly.
// Writes z[0..K); the caller synchronizes before reading z.
template <typename T, int VB, int WARPS>
__device__ __forceinline__ void gate_logits(const T* __restrict__ gate_w,
                                            const T* __restrict__ h_row, int K, int d,
                                            float* z) {
  using V = Vec<T, VB>;
  constexpr int J = kMaxK / WARPS;  // experts per warp, at most
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = d / V::N;
  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;
  for (int v = lane; v < nv; v += 32) {
    float x[V::N];
    V::load(h_row + v * V::N, x);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = warp + WARPS * j;
      if (e < K) {
        float u[V::N];
        V::load(gate_w + static_cast<size_t>(e) * d + v * V::N, u);
#pragma unroll
        for (int n = 0; n < V::N; ++n) acc[j] = fmaf(x[n], u[n], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = warp + WARPS * j;
    if (e < K) {
      const float s = warp_sum(acc[j]);
      if (lane == 0) z[e] = s;
    }
  }
}

// mbarrier helpers of the kernels that stage tiles asynchronously
// (flash_attention.cu, retrieve_stream.cuh).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Merge nsplit (<= kMaxSplits) partial top-k lists, split s covering lower
// packed positions than split s + 1: part (nsplit, R, k) -> out (R, k),
// ties to the lower split. One warp per row; lane l holds the heads of
// splits l, l + 32, ...; each step emits the best head (value desc, split
// asc) and advances it.
constexpr int kMergePerLane = 9;
constexpr int kMaxSplits = 32 * kMergePerLane;

__global__ void merge_splits_kernel(const float* __restrict__ part_v,
                                    const int* __restrict__ part_i,
                                    float* __restrict__ out_v,
                                    int* __restrict__ out_i, int R, int k,
                                    int nsplit) {
  const int lane = threadIdx.x % 32;
  const long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  if (r >= R) return;
  int h[kMergePerLane];
#pragma unroll
  for (int s = 0; s < kMergePerLane; ++s) h[s] = 0;
  for (int j = 0; j < k; ++j) {
    float bv = -CUDART_INF_F;
    int bc = INT_MAX, bid = -1;
#pragma unroll
    for (int s = 0; s < kMergePerLane; ++s) {
      const int c = lane + 32 * s;
      if (c < nsplit && h[s] < k) {
        const size_t at = (static_cast<size_t>(c) * R + r) * k + h[s];
        const float v = part_v[at];
        if (bc == INT_MAX || v > bv) {
          bv = v;
          bc = c;
          bid = part_i[at];
        }
      }
    }
    float wv = bv;
    int wc = bc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
      const int oc = __shfl_xor_sync(0xffffffffu, wc, off);
      if (ov > wv || (ov == wv && oc < wc)) {
        wv = ov;
        wc = oc;
      }
    }
    const int wid = __shfl_sync(0xffffffffu, bid, wc & 31);
    if (lane == 0) {
      out_v[r * k + j] = wv;
      out_i[r * k + j] = wid;
    }
    if (lane == (wc & 31)) {
#pragma unroll
      for (int s = 0; s < kMergePerLane; ++s)
        if (s == (wc >> 5)) ++h[s];
    }
  }
}

inline cudaError_t launch_merge(const float* part_v, const int* part_i,
                                float* out_v, int* out_i, int R, int k,
                                int nsplit, cudaStream_t stream) {
  if (nsplit < 1 || nsplit > kMaxSplits) return cudaErrorInvalidValue;
  const long long threads = 256;
  merge_splits_kernel<<<static_cast<int>((32LL * R + threads - 1) / threads), threads, 0,
                        stream>>>(part_v, part_i, out_v, out_i, R, k, nsplit);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
