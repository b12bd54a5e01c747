// Causal flash attention for Hopper (sm_90a): two bodies of one kernel.
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
// GFLOP against 14.7 MB, 0.013 ms at the bf16 tensor-core rate).
//
// The caller (kernels/flash_attention.py::select_body) picks the body by
// dtype, head dim and alignment; each checks again what it takes.
//
// Body "wgmma" (bf16; dh a multiple of 16 up to 128; 16-byte aligned data
// pointers and batch/head/sequence strides), the tensor-core body:
// - One block of 288 threads per (128-row query tile, head, batch row):
//   two consumer warpgroups own 64 query rows each; warp 8 is the producer.
//   Grid order puts the heaviest query tiles (most kv tiles) first across
//   all heads: at qwen2-1.5b's S 2048, 16 x 12 = 192 blocks for 132 SMs,
//   the first wave holds exactly the 132 tiles with 6-16 kv tiles and the
//   60 light ones fill in behind them, so the makespan is the heaviest
//   tile's 16 kv tiles against a mean of 12.4 (77% balance).
// - The producer's lane 0 issues TMA loads (cp.async.bulk.tensor, 4-D
//   tensor maps over (dh, S, heads, B) built on the host from the element
//   strides, passed as __grid_constant__): Q once, then whole 128-row K and
//   V tiles into a ring of 2 stages with full/empty mbarriers, so tile j+1
//   is in flight while tile j's products run. Rows >= S and head-dim
//   columns >= dh arrive as TMA's zero fill (no masked loads).
// - Shared memory holds each tile as 64-column (128-byte) regions with the
//   128-byte swizzle: Q 32 KB + 2 stages x (K 32 KB + V 32 KB) = 160 KB at
//   dh 128 (one block per SM).
// - S = Q K^T is wgmma.mma_async m64n64k16 (bf16 in, fp32 accumulate), Q
//   and K read K-major from shared memory; two n64 halves per k16 slice.
//   The online softmax runs on the accumulator registers (each row's m and
//   l shared by the 4 lanes holding it, quad shuffles), in the log2 domain
//   (ex2 of the scores times log2(e)/sqrt(dh)); the causal mask (-1e9)
//   only on the diagonal tile, kv tiles above it never visited.
// - O += P V is wgmma with P as the A operand in registers: the score
//   accumulator after the softmax, rounded to bf16 (the Pallas kernel's
//   p.astype(v.dtype)), repacked in place (the m64nNk16 accumulator layout
//   of two n8 column blocks is the A fragment of one k16 slice). V is read
//   from the same swizzled tiles through wgmma's transpose bit (MN-major B).
// - Each warpgroup waits on its own products (no ping-pong between the two
//   warpgroups yet); the epilogue stores o / l from registers, 4 bytes per
//   lane, in q's axis order.
//
// Body "simt" (the CUDA-core body: fp32, dh not a multiple of 16 or above
// 128, data TMA cannot address; dh <= 256): one block of 256 threads per
// (64-row query tile, head, batch row), the heaviest query tiles first.
// The query tile, then each kv tile's K and, after the scores, its V are
// staged in shared memory as fp32 (rows padded by 4 floats, so the float4
// reads of 8 lanes hit distinct banks). A thread computes a 4 x 4 patch of
// the 64 x 64 score tile with CUDA-core FMAs; each row's m and l are
// replicated over the 16 threads holding that row (shuffle reductions),
// and each thread keeps 4 rows x 4*ceil(dh/64) columns of acc in
// registers. kv tiles strictly above the diagonal are never visited; the
// ragged last tile is masked (rows >= S load as zeros, are masked by the
// causal test or belong to query rows that are never written), so any
// S >= 1 works. Element strides for q, k, v and o; the dh axis must be
// contiguous.
//
// Both bodies set their shared-memory limit once per device, not per call.
#include "wgmma_common.cuh"

namespace {

using repro::smem_limit_once;

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
  cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(kern), smem);
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

// ---------------------------------------------------------------------------
// Body "wgmma": tensor cores on TMA-staged K/V (bf16)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 128;                // query rows per block (two warpgroups)
constexpr int kBK = 128;                // kv rows per tile
constexpr int kStages = 2;              // K/V ring depth
constexpr int kConsumers = 256;         // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kRegion = 128 * 128;      // bytes of one 64-column region of a 128-row tile
constexpr int kMaxDh = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <int NC>  // 64-column regions over the (zero-padded) head dim
constexpr int smem_bytes() {
  return NC * kRegion + kStages * 2 * NC * kRegion + 8 * (2 * kStages + 1) + 1024;
}

using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_u32;

using repro::fence_regs;
using repro::pack_bf16;
using repro::sw128_desc;
using repro::tma_load_4d;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_rs_tb;
using repro::wgmma_ss;
using repro::wgmma_wait_all;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Block L of the 1-D grid: query tile n_q - 1 - L / (H * B) (heaviest
// first across all heads), head L % H, batch row (L / H) % B.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                Strides os, int H, int B, int group, int S, int dh, int n_q, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                    // Q: NC regions of 128 rows
  const uint32_t skv = sq + NC * kRegion;      // stage s: K, then V, NC regions each
  const uint32_t bars = skv + kStages * 2 * NC * kRegion;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t qbar = bars + 8u * (2 * kStages);

  const int L = blockIdx.x;
  const int hb = L % (H * B);
  const int qt = n_q - 1 - L / (H * B);
  const int h = hb % H, b = hb / H, hk = h / group;
  const int q0 = qt * kBQ;
  const int n_kv = qt + 1;  // kBK == kBQ: the last tile holds the diagonal

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {
    // -- producer: one lane issues every TMA load ------------------------
    if (lane == 0) {
      mbar_expect_tx(qbar, NC * kRegion);
      for (int c = 0; c < NC; ++c) tma_load_4d(sq + c * kRegion, &tq, qbar, 64 * c, q0, h, b);
      for (int kt = 0; kt < n_kv; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty(s), ((kt / kStages) - 1) & 1);
        mbar_expect_tx(full(s), 2 * NC * kRegion);
        const uint32_t sk = skv + s * 2 * NC * kRegion, sv = sk + NC * kRegion;
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(sk + c * kRegion, &tk, full(s), 64 * c, kt * kBK, hk, b);
          tma_load_4d(sv + c * kRegion, &tv, full(s), 64 * c, kt * kBK, hk, b);
        }
      }
    }
    return;
  }

  // -- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----------
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, tq4 = lane % 4;
  // accumulator element i of a 64 x 64 product: row 16 w + g + 8 ((i >> 1) & 1),
  // column 8 (i >> 2) + 2 tq4 + (i & 1)
  const int row0 = q0 + 64 * wg + 16 * w + g;
  const int ks = dh / 16;  // k16 slices that hold head-dim data
  const uint32_t q_wg = sq + wg * 64 * 128;
  float m[2] = {repro::kNegInfMask, repro::kNegInfMask}, l[2] = {0.f, 0.f};
  float oacc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[c][i] = 0.f;

  mbar_wait(qbar, 0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full(s), (kt / kStages) & 1);
    const uint32_t sk = skv + s * 2 * NC * kRegion, sv = sk + NC * kRegion;

    // S = Q K^T: two 64-column halves of the 128 kv rows
    float sacc[2][32];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[nb][i] = 0.f;
    fence_regs(sacc[0]);
    fence_regs(sacc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      if (kk < ks) {
        const uint32_t off = (kk / 4) * kRegion + (kk % 4) * 32;
        const uint64_t da = sw128_desc(q_wg + off);
        wgmma_ss(sacc[0], da, sw128_desc(sk + off), kk > 0);
        wgmma_ss(sacc[1], da, sw128_desc(sk + off + 64 * 128), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc[0]);
    fence_regs(sacc[1]);

    // online softmax on the accumulators (log2 domain), causal mask on the
    // diagonal tile only
    const int k0 = kt * kBK;
    const bool diag = kt == n_kv - 1;
    float mx[2] = {repro::kNegInfMask, repro::kNegInfMask};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int rr = (i >> 1) & 1;
        float x = sacc[nb][i] * scale_log2;
        if (diag && k0 + 64 * nb + 8 * (i >> 2) + 2 * tq4 + (i & 1) > row0 + 8 * rr)
          x = repro::kNegInfMask;
        sacc[nb][i] = x;
        mx[rr] = fmaxf(mx[rr], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      alpha[rr] = ex2(m[rr] - m_new);
      m[rr] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int rr = (i >> 1) & 1;
        const float p = ex2(sacc[nb][i] - m[rr]);
        sacc[nb][i] = p;
        rs[rr] += p;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      rs[rr] += __shfl_xor_sync(0xffffffffu, rs[rr], 1);
      rs[rr] += __shfl_xor_sync(0xffffffffu, rs[rr], 2);
      l[rr] = l[rr] * alpha[rr] + rs[rr];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[c][i] *= alpha[(i >> 1) & 1];

    // P (bf16) as A fragments: slice kk covers kv rows 16 kk .. 16 kk + 15
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int nb = kk / 4, i0 = 8 * (kk % 4);
      pa[kk][0] = pack_bf16(sacc[nb][i0 + 0], sacc[nb][i0 + 1]);  // row g,     k 2 tq4 ..
      pa[kk][1] = pack_bf16(sacc[nb][i0 + 2], sacc[nb][i0 + 3]);  // row g + 8, k 2 tq4 ..
      pa[kk][2] = pack_bf16(sacc[nb][i0 + 4], sacc[nb][i0 + 5]);  // row g,     k 8 + 2 tq4 ..
      pa[kk][3] = pack_bf16(sacc[nb][i0 + 6], sacc[nb][i0 + 7]);  // row g + 8, k 8 + 2 tq4 ..
    }

    // O += P V, V transposed by the descriptor (MN-major B)
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(oacc[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wgmma_rs_tb(oacc[c], pa[kk], sw128_desc(sv + c * kRegion + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(oacc[c]);
    mbar_arrive(empty(s));  // this thread no longer reads stage s
  }

  // epilogue: o = acc / l in bf16, q's axis order
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + 8 * rr;
    if (r >= S) continue;
    __nv_bfloat16* orow = o + b * os.b + h * os.h + static_cast<long long>(r) * os.s;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * tq4;
        if (col < dh) {
          const int i = 4 * j + 2 * rr;
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(oacc[c][i] / l[rr], oacc[c][i + 1] / l[rr]);
        }
      }
  }
}

using repro::encode_fn;
using repro::EncodeTiledFn;

// The 4-D map (dh, S, heads, batch) of one bf16 operand, box (64, 128, 1,
// 1) with the 128-byte swizzle; elements outside the tensor read as zero.
// An axis of length 1 is never stepped, so its stride is replaced by one
// TMA accepts.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int dh, int S, int heads, int B,
                     Strides st) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long long e = sizeof(__nv_bfloat16);
  long long span = 2LL * dh * e;
  for (long long x : {st.s * S, st.h * heads, st.b * B}) span = x * e > span ? x * e : span;
  span = (span + 15) & ~15LL;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(S),
                        static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(S > 1 ? st.s * e : span),
                           static_cast<cuuint64_t>(heads > 1 ? st.h * e : span),
                           static_cast<cuuint64_t>(B > 1 ? st.b * e : span)};
  cuuint32_t box[4] = {64, kBK, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What the body takes: dh a multiple of 16 up to 128, 16-byte aligned data
// and strides (axes of length 1 excepted).
bool takes(const void* p, Strides st, int B, int heads, int S, int dh) {
  const long long e = sizeof(__nv_bfloat16);
  return dh % 16 == 0 && dh <= kMaxDh && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (B == 1 || st.b * e % 16 == 0) && (heads == 1 || st.h * e % 16 == 0) &&
         (S == 1 || st.s * e % 16 == 0);
}

template <int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides qs, Strides ks,
                   Strides vs, Strides os, int B, int H, int H_kv, int S, int dh,
                   cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, dh, S, H, B, qs);
  if (err == cudaSuccess) err = make_map(&mk, k, dh, S, H_kv, B, ks);
  if (err == cudaSuccess) err = make_map(&mv, v, dh, S, H_kv, B, vs);
  if (err != cudaSuccess) return err;
  constexpr int smem = smem_bytes<NC>();
  auto kern = fa_wgmma_kernel<NC>;
  err = smem_limit_once(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return err;
  const int n_q = (S + kBQ - 1) / kBQ;
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(dh));
  kern<<<n_q * H * B, kThreads, smem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o), os,
                                                  H, B, H / H_kv, S, dh, n_q, scale_log2);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, o (B, H, S, dh) and k, v (B, H_kv, S, dh) in `dtype`, addressed by
// element strides (batch, head, sequence; dh is contiguous). H % H_kv == 0,
// 1 <= dh <= 256. `body` 0 runs the CUDA-core body, 1 the tensor-core body
// (bf16 only; cudaErrorInvalidValue for inputs it does not take). Launches
// on `stream`, does not synchronize.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               long long q_sb, long long q_sh, long long q_ss,
                               long long k_sb, long long k_sh, long long k_ss,
                               long long v_sb, long long v_sh, long long v_ss,
                               long long o_sb, long long o_sh, long long o_ss, int B, int H,
                               int H_kv, int S, int dh, int dtype, int body, void* stream) {
  if (B < 0 || S < 0 || H < 1 || H_kv < 1 || H % H_kv || dh < 1 || dh > kMaxDh || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = H / H_kv;
  if (body == 1) {
    if (dtype != repro::kDtypeBF16 || !tc::takes(q, qs, B, H, S, dh) ||
        !tc::takes(k, ks, B, H_kv, S, dh) || !tc::takes(v, vs, B, H_kv, S, dh) ||
        static_cast<long long>((S + tc::kBQ - 1) / tc::kBQ) * H * B > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    if (dh <= 64) return tc::launch<1>(q, k, v, o, qs, ks, vs, os, B, H, H_kv, S, dh, s);
    return tc::launch<2>(q, k, v, o, qs, ks, vs, os, B, H, H_kv, S, dh, s);
  }
  if (body != 0) return cudaErrorInvalidValue;
  if (dtype == repro::kDtypeF32)
    return dispatch<float>(q, k, v, o, qs, ks, vs, os, B, H, group, S, dh, s);
  if (dtype == repro::kDtypeBF16)
    return dispatch<__nv_bfloat16>(q, k, v, o, qs, ks, vs, os, B, H, group, S, dh, s);
  return cudaErrorInvalidValue;
}
