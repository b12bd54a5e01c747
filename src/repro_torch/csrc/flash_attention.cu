// Causal flash attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas, TPU).
// Computes, for every batch row b, query head h and query position i < S,
// as the Pallas kernel does: scores s_j = (q_i . k_j) in fp32 times
// 1/sqrt(dh), masked to -1e9 where j > i; an online softmax over kv tiles
// with fp32 running m (from -1e9), l (0) and acc (0): per tile
// m_new = max(m, max_j s_j), p_j = exp(s_j - m_new), alpha = exp(m - m_new),
// l = l * alpha + sum_j p_j, acc = acc * alpha + sum_j round_T(p_j) v_j
// (p rounded to v's type before the product, fp32 accumulation); then
// o_i = acc / l in q's type. Query head h reads kv head h / (H / H_kv),
// the order jnp.repeat(k, H // H_kv, axis=1) gives, without copying K/V.
//
// Bound on this card: operations at prefill lengths. Each unmasked (i, j)
// pair costs 4*dh flops (two products), S(S+1)/2 pairs per head; the bytes
// are q, k and v read once and o written once (qwen2-1.5b at S 2048: 12.9
// GFLOP against 14.7 MB).
// Design (a first, simple version): one block of 256 threads per (64-row
// query tile, head, batch row), the heaviest (last) query tiles launched
// first. The query tile, then each kv tile's K and, after the scores, its
// V are staged in shared memory as fp32 (rows padded by 4 floats, so the
// float4 reads of 8 lanes hit distinct banks). A thread computes a 4 x 4
// patch of the 64 x 64 score tile with CUDA-core FMAs; each row's m and l
// are replicated over the 16 threads holding that row (shuffle
// reductions), and each thread keeps 4 rows x 4*ceil(dh/64) columns of acc
// in registers. kv tiles strictly above the diagonal are never visited;
// the ragged last tile is masked (rows >= S load as zeros, are masked by
// the causal test or belong to query rows that are never written), so any
// S >= 1 works. Element strides for q, k, v and o; the dh axis must be
// contiguous. No tensor cores, no cp.async/TMA overlap yet.
#include "topk_common.cuh"

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // kv rows per tile
constexpr int kFaThreads = 256;     // 16 x 16 threads over the 64 x 64 tile
constexpr int kPStride = kBK + 4;   // row stride (floats) of the score tile
constexpr int kMaxDh = 256;

struct Strides {
  long long b, h, s;  // element strides of the batch, head and sequence axes
};

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// dst[r * ld + d] = src[(row0 + r) * s_stride + d] widened to fp32, for
// r < 64 and d < dhp; zero where row0 + r >= S or d >= dh.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          long long s_stride, int row0, int S, int dh,
                                          int dhp) {
  for (int idx = threadIdx.x; idx < kBK * dhp; idx += kFaThreads) {
    const int r = idx / dhp, d = idx - r * dhp;
    float x = 0.f;
    if (row0 + r < S && d < dh)
      x = repro::to_f32(src[static_cast<long long>(row0 + r) * s_stride + d]);
    dst[r * ld + d] = x;
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kFaThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
                       Strides vs, Strides os, int group, int S, int dh, float scale) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int dhp = (dh + 3) & ~3;
  const int ld = dhp + 4;
  float* qsm = smem;               // [kBQ][ld] query tile
  float* kvs = qsm + kBQ * ld;     // [kBK][ld] K of the current tile, then its V
  float* ps = kvs + kBK * ld;      // [kBQ][kPStride] p rounded to T

  const int n_q = (S + kBQ - 1) / kBQ;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x);  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  load_tile(qsm, ld, qp, qs.s, q0, S, dh, dhp);

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = repro::kNegInfMask;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's V is no longer read
    load_tile(kvs, ld, kp, ks.s, k0, S, dh, dhp);
    __syncthreads();

    // s = q . k^T over dh, 4 x 4 per thread: rows ty + 16 i, cols tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dhp; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qsm + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(kvs + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, c[j].x, t);
          t = fmaf(a[i].y, c[j].y, t);
          t = fmaf(a[i].z, c[j].z, t);
          t = fmaf(a[i].w, c[j].w, t);
          s[i][j] = t;
        }
    }

    // scale, causal mask, online softmax; p (rounded to T) to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = repro::kNegInfMask;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (k0 + tx + 16 * j > r) x = repro::kNegInfMask;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = round_to(p, T());
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= alpha;
    }
    __syncthreads();  // K is no longer read; p is complete
    load_tile(kvs, ld, vp, vs.s, k0, S, dh, dhp);
    __syncthreads();

    // acc += p . v: thread holds cols 4 tx + 64 jj + e of its 4 rows
    for (int c = 0; c < kBK; c += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPStride + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int d = 4 * tx + 64 * jj;
          if (d >= dhp) continue;
          const float4 vv = *reinterpret_cast<const float4*>(kvs + (c + cc) * ld + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pr[i].x : cc == 1 ? pr[i].y : cc == 2 ? pr[i].z : pr[i].w;
            acc[i][jj][0] = fmaf(p, vv.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(p, vv.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(p, vv.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(p, vv.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    T* orow = o + b * os.b + h * os.h + static_cast<long long>(r) * os.s;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * jj + e;
        if (d < dh) store(orow + d, acc[i][jj][e] / l[i]);
      }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides qs,
                   Strides ks, Strides vs, Strides os, int B, int H, int group, int S, int dh,
                   cudaStream_t stream) {
  const int dhp = (dh + 3) & ~3;
  const int smem = static_cast<int>(sizeof(float)) * (2 * kBQ * (dhp + 4) + kBQ * kPStride);
  auto kern = flash_attention_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kFaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qs, ks, vs, os, group, S, dh, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, Strides qs,
                     Strides ks, Strides vs, Strides os, int B, int H, int group, int S,
                     int dh, cudaStream_t s) {
  if (dh <= 64) return launch<T, 1>(q, k, v, o, qs, ks, vs, os, B, H, group, S, dh, s);
  if (dh <= 128) return launch<T, 2>(q, k, v, o, qs, ks, vs, os, B, H, group, S, dh, s);
  return launch<T, 4>(q, k, v, o, qs, ks, vs, os, B, H, group, S, dh, s);
}

}  // namespace

// q, o (B, H, S, dh) and k, v (B, H_kv, S, dh) in `dtype`, addressed by
// element strides (batch, head, sequence; dh is contiguous). H % H_kv == 0,
// 1 <= dh <= 256. Launches on `stream`, does not synchronize.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               long long q_sb, long long q_sh, long long q_ss,
                               long long k_sb, long long k_sh, long long k_ss,
                               long long v_sb, long long v_sh, long long v_ss,
                               long long o_sb, long long o_sh, long long o_ss, int B, int H,
                               int H_kv, int S, int dh, int dtype, void* stream) {
  if (B < 0 || S < 0 || H < 1 || H_kv < 1 || H % H_kv || dh < 1 || dh > kMaxDh || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = H / H_kv;
  if (dtype == repro::kDtypeF32)
    return dispatch<float>(q, k, v, o, qs, ks, vs, os, B, H, group, S, dh, s);
  if (dtype == repro::kDtypeBF16)
    return dispatch<__nv_bfloat16>(q, k, v, o, qs, ks, vs, os, B, H, group, S, dh, s);
  return cudaErrorInvalidValue;
}
