// Group-lasso row norms and survival mask for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lasso_prune.py::lasso_prune (Pallas, TPU).
// Computes, for every row (e, n) of the expert tables W (K, N, d):
// norm = sqrt(sum_j w_j^2) in fp32 where mask[e, n], exactly 0 where not,
// and new_mask = mask && norm > gamma (gamma in fp32).
//
// Bound on this card: bytes. The work is one fp32 multiply-add per element
// read; each alive row is read once (d elements), each mask byte once, and
// each norm and new-mask entry written once. A masked row's norm is 0 by
// definition, so its d elements are never read: the bytes the call needs
// are those of the alive rows, whatever the table's size.
// Design: one warp per row, warps striding over the K*N rows (64-bit row
// offsets: a full-width table holds more than 2^31 elements). A warp reads
// the row's mask byte first and, for an alive row, streams the row with
// 16-byte loads (4 fp32 or 8 bf16 per lane per load, consecutive lanes on
// consecutive addresses, loads marked evict-first since nothing reads them
// again); the few elements before the first 16-byte boundary and after
// the last one take scalar loads, so any d and any row alignment work.
// Each lane keeps an fp32 sum of squares, a butterfly of shuffles reduces
// it, and lane 0 writes the norm and the new mask. No shared memory.
#include "topk_common.cuh"

namespace {

constexpr int kWarps = 8;

// Sum of squares of the 16 bytes in v, added to s, for each element type.
__device__ __forceinline__ float sumsq16(uint4 v, float s, float) {
  const float a = __uint_as_float(v.x), b = __uint_as_float(v.y);
  const float c = __uint_as_float(v.z), d = __uint_as_float(v.w);
  return fmaf(d, d, fmaf(c, c, fmaf(b, b, fmaf(a, a, s))));
}

// bf16 -> fp32 is exact: the bf16 bits are the top half of the fp32 bits
// (element 0 of a pair sits in the low half, little-endian).
__device__ __forceinline__ float sumsq_bf16x2(unsigned u, float s) {
  const float lo = __uint_as_float(u << 16), hi = __uint_as_float(u & 0xffff0000u);
  return fmaf(hi, hi, fmaf(lo, lo, s));
}

__device__ __forceinline__ float sumsq16(uint4 v, float s, __nv_bfloat16) {
  s = sumsq_bf16x2(v.x, s);
  s = sumsq_bf16x2(v.y, s);
  s = sumsq_bf16x2(v.z, s);
  return sumsq_bf16x2(v.w, s);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lasso_prune_kernel(const T* __restrict__ w, const uint8_t* __restrict__ mask,
                   float* __restrict__ norms, uint8_t* __restrict__ new_mask,
                   long long rows, int d, float gamma) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte load
  const int lane = threadIdx.x % 32;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
       row < rows; row += n_warps) {
    if (!mask[row]) {
      if (lane == 0) {
        norms[row] = 0.f;
        new_mask[row] = 0;
      }
      continue;
    }
    const T* r = w + row * static_cast<long long>(d);
    // elements before the first 16-byte boundary of this row
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(r) % 16);
    const int head = min(d, mis ? (16 - mis) / static_cast<int>(sizeof(T)) : 0);
    const int n_vec = (d - head) / kPer;
    const int tail = head + n_vec * kPer;
    float s = 0.f;
    if (lane < head) {
      const float x = repro::to_f32(r[lane]);
      s = fmaf(x, x, s);
    }
    const uint4* rv = reinterpret_cast<const uint4*>(r + head);
#pragma unroll 4
    for (int i = lane; i < n_vec; i += 32) s = sumsq16(__ldcs(rv + i), s, T());
    for (int j = tail + lane; j < d; j += 32) {
      const float x = repro::to_f32(r[j]);
      s = fmaf(x, x, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const float n = sqrtf(s);
      norms[row] = n;
      new_mask[row] = n > gamma;
    }
  }
}

template <typename T>
cudaError_t launch(const void* w, const uint8_t* mask, float* norms, uint8_t* new_mask,
                   long long rows, int d, float gamma, int blocks, cudaStream_t stream) {
  lasso_prune_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(w), mask, norms, new_mask, rows, d, gamma);
  return cudaGetLastError();
}

}  // namespace

// w (rows, d) row-major in `dtype`, mask/new_mask (rows,) uint8 0/1,
// norms (rows,) fp32. `blocks` is the grid size (the warps stride over
// the rows). Launches on `stream`, does not synchronize.
extern "C" int lasso_prune(const void* w, const void* mask, void* norms, void* new_mask,
                           long long rows, int d, float gamma, int dtype, int blocks,
                           void* stream) {
  if (rows < 0 || d < 1 || blocks < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* n = static_cast<float*>(norms);
  uint8_t* nm = static_cast<uint8_t*>(new_mask);
  if (dtype == repro::kDtypeF32) return launch<float>(w, m, n, nm, rows, d, gamma, blocks, s);
  if (dtype == repro::kDtypeBF16)
    return launch<__nv_bfloat16>(w, m, n, nm, rows, d, gamma, blocks, s);
  return cudaErrorInvalidValue;
}
