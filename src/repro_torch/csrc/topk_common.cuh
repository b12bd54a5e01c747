// Shared device code of the DS-Softmax retrieval kernels (sm_90a).
//
// retrieve_tile() is the body of both dss_topk_grouped.cu and
// dss_topk_fused.cu: a block holds up to TB token rows and streams one
// expert's packed rows through shared memory in (TV rows x TD dims)
// tiles, accumulating fp32 logits in registers, then merges each vocab
// tile into a running top-k per token kept in shared memory.
//
// Order of operations (every path of the port follows it): z = x . w in
// fp32 (bf16 operands are widened, so each product is exact; int8 rows are
// widened too, which equals the reference's cast to the token dtype since
// |q| <= 127), then z *= scale[row] for int8 rows, then z *= g, each on
// the fp32 accumulator after the product (fp32 multiplication is not
// associative, so this order is fixed), padding rows (id -1) -> -1e9.
// The running top-k is ordered by (value desc, packed position asc):
// candidates arrive in increasing position order and a candidate enters
// only when strictly greater than the current k-th value, landing after
// every equal value already held. Unfilled slots hold (-inf, -1), below
// the -1e9 padding value, so they can never be emitted while the rows
// scanned number at least k.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace repro {

constexpr float kNegInfMask = -1e9f;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kDtypeI8 = 2;    // table rows only, with per-row fp32 scales
constexpr int kThreads = 256;  // 16 x 16 thread grid over the output tile
constexpr int kTV = 64;        // vocab rows per tile
constexpr int kTD = 32;        // hidden dims per tile
constexpr int kMaxK = 64;      // largest top-k width the kernels take

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// Insert (v, id) into a (value desc, position asc) sorted list of k.
__device__ __forceinline__ void topk_insert(float* vals, int* ids, int k,
                                            float v, int id) {
  if (!(v > vals[k - 1])) return;
  int j = k - 1;
  while (j > 0 && v > vals[j - 1]) {
    vals[j] = vals[j - 1];
    ids[j] = ids[j - 1];
    --j;
  }
  vals[j] = v;
  ids[j] = id;
}

// Shared-memory layout of retrieve_tile for TB tokens and width k.
template <int TB>
struct TileSmem {
  long long* tok_off;  // [TB] element offset of each token row
  float* g;            // [TB] gate value per token
  int* ids;            // [kTV] class ids of the current vocab tile
  float* sc;           // [kTV] row scales of the current tile (int8 rows)
  float* xs;           // [kTD][TB + 1] token tile, transposed
  float* ws;           // [kTD][kTV + 1] weight tile, transposed
  float* zs;           // [TB][kTV + 1] logits of the current tile
  float* top_v;        // [TB][k] running top-k values
  int* top_i;          // [TB][k] running top-k class ids

  __host__ __device__ static size_t bytes(int k) {
    return TB * sizeof(long long) +
           sizeof(float) * (TB + 2 * kTV + kTD * (TB + 1) + kTD * (kTV + 1) +
                            TB * (kTV + 1) + 2 * TB * k);
  }
  __device__ static TileSmem carve(char* base, int k) {
    TileSmem s;
    s.tok_off = reinterpret_cast<long long*>(base);
    float* f = reinterpret_cast<float*>(base + TB * sizeof(long long));
    s.g = f;
    f += TB;
    s.ids = reinterpret_cast<int*>(f);
    f += kTV;
    s.sc = f;
    f += kTV;
    s.xs = f;
    f += kTD * (TB + 1);
    s.ws = f;
    f += kTD * (kTV + 1);
    s.zs = f;
    f += TB * (kTV + 1);
    s.top_v = f;
    f += TB * k;
    s.top_i = reinterpret_cast<int*>(f);
    return s;
  }
};

template <int TB>
__device__ void init_topk(const TileSmem<TB>& s, int k) {
  for (int i = threadIdx.x; i < TB * k; i += kThreads) {
    s.top_v[i] = -CUDART_INF_F;
    s.top_i[i] = -1;
  }
}

// Stream rows [v_lo, v_hi) of one expert (w: (v_pad, d), ids: (v_pad,),
// scales: (v_pad,) for int8 rows, else null) against the first n_tok
// tokens named by s.tok_off / s.g, merging into s.top_v / s.top_i. TX is
// the token type, TW the row type. Must be called by all kThreads threads
// of the block.
template <typename TX, typename TW, int TB>
__device__ void retrieve_tile(const TileSmem<TB>& s, const TX* __restrict__ x,
                              int n_tok, const TW* __restrict__ w,
                              const int* __restrict__ ids,
                              const float* __restrict__ scales, int v_lo,
                              int v_hi, int d, int k) {
  constexpr int MT = TB / 16;
  constexpr int NT = kTV / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int v0 = v_lo; v0 < v_hi; v0 += kTV) {
    float acc[MT][NT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j] = 0.f;
    for (int d0 = 0; d0 < d; d0 += kTD) {
      for (int i = tid; i < TB * kTD; i += kThreads) {
        const int t = i / kTD, dd = i % kTD;
        float v = 0.f;
        if (t < n_tok && d0 + dd < d) v = to_f32(x[s.tok_off[t] + d0 + dd]);
        s.xs[dd * (TB + 1) + t] = v;
      }
      for (int i = tid; i < kTV * kTD; i += kThreads) {
        const int r = i / kTD, dd = i % kTD;
        float v = 0.f;
        if (v0 + r < v_hi && d0 + dd < d)
          v = to_f32(w[static_cast<size_t>(v0 + r) * d + d0 + dd]);
        s.ws[dd * (kTV + 1) + r] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < kTD; ++dd) {
        float a[MT], b[NT];
#pragma unroll
        for (int i = 0; i < MT; ++i) a[i] = s.xs[dd * (TB + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NT; ++j) b[j] = s.ws[dd * (kTV + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < kTV) {
      const bool in = v0 + tid < v_hi;
      s.ids[tid] = in ? ids[v0 + tid] : -1;
      s.sc[tid] = (in && scales != nullptr) ? scales[v0 + tid] : 1.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = tx + 16 * j;
        float z = acc[i][j];
        if (scales != nullptr) z *= s.sc[c];
        z *= s.g[t];
        if (s.ids[c] < 0) z = kNegInfMask;
        s.zs[t * (kTV + 1) + c] = z;
      }
    }
    __syncthreads();
    if (tid < n_tok) {
      const int nc = min(kTV, v_hi - v0);
      float* tv = s.top_v + tid * k;
      int* ti = s.top_i + tid * k;
      for (int c = 0; c < nc; ++c)
        topk_insert(tv, ti, k, s.zs[tid * (kTV + 1) + c], s.ids[c]);
    }
    __syncthreads();
  }
}

// Merge nsplit partial top-k lists (split s covers lower packed positions
// than split s+1) into one: part (nsplit, R, k) -> out (R, k).
__global__ void merge_splits_kernel(const float* __restrict__ part_v,
                                    const int* __restrict__ part_i,
                                    float* __restrict__ out_v,
                                    int* __restrict__ out_i, int R, int k,
                                    int nsplit) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float v[kMaxK];
  int id[kMaxK];
  for (int j = 0; j < k; ++j) {
    v[j] = -CUDART_INF_F;
    id[j] = -1;
  }
  for (int sp = 0; sp < nsplit; ++sp) {
    const size_t base = (static_cast<size_t>(sp) * R + r) * k;
    for (int j = 0; j < k; ++j) topk_insert(v, id, k, part_v[base + j], part_i[base + j]);
  }
  for (int j = 0; j < k; ++j) {
    out_v[static_cast<size_t>(r) * k + j] = v[j];
    out_i[static_cast<size_t>(r) * k + j] = id[j];
  }
}

inline cudaError_t launch_merge(const float* part_v, const int* part_i,
                                float* out_v, int* out_i, int R, int k,
                                int nsplit, cudaStream_t stream) {
  const int threads = 128;
  merge_splits_kernel<<<(R + threads - 1) / threads, threads, 0, stream>>>(
      part_v, part_i, out_v, out_i, R, k, nsplit);
  return cudaGetLastError();
}

// fp32 gate logits of one token against K gate rows, by one warp: lane l
// sums dims l, l+32, ... in order, then a butterfly reduction (every lane
// ends with the same sum). Writes z[0..K) (lane 0).
template <typename T>
__device__ void warp_gate_logits(const T* __restrict__ h_row,
                                 const T* __restrict__ gate_w, int K, int d,
                                 float* z) {
  const int lane = threadIdx.x & 31;
  for (int e = 0; e < K; ++e) {
    const T* u = gate_w + static_cast<size_t>(e) * d;
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) acc = fmaf(to_f32(h_row[i]), to_f32(u[i]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) z[e] = acc;
  }
  __syncwarp();
}

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
