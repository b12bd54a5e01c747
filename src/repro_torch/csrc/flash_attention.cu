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
// 128, data TMA cannot address; dh <= 256), bound by the fp32 FMAs of the
// two products. Templated on the head-dim class DH (64, 128, 256: dh
// rounded up). One block per (64-row query tile, head, batch row), the
// heaviest query tiles first across all heads (the 1-D grid of the wgmma
// body); 128 threads for DH 64 and 128 (two blocks per SM), 256
// for DH 256. Thread (ty, tx) of a 16-wide grid owns query rows
// ty + RT i (RT = threads / 16) and, of each 64-row kv tile, score columns
// tx + 16 j (j < 4) and head-dim columns 4 tx + 64 jj + e of acc, so a
// DH-128 thread holds an 8 x 4 score micro-tile and an 8 x 8 acc
// micro-tile in registers: each 16-byte operand load from shared memory
// feeds 8 or 16 FMAs (8 x 4 x 4 per 12 loads on the scores, 8 x 8 x 4 per
// 16 on P V). The 16 threads of a row replicate its m (a shuffle
// reduction per kv tile) and each keeps l over its own columns, summed
// over the row once at the end. Staging: Q once, then K0, V0, K1, V1, ...
// through a ring of two tile slots in shared memory, each tile copied by
// 16-byte cp.async (a thread copies one 16-byte column of rows t / NCH +
// RSTEP m, so its addresses step by a constant; rows >= S and columns >=
// dh zero-filled by the copy's source size) one tile ahead of the product
// that reads it, so tile u + 1 is in flight while tile u is multiplied;
// where a base pointer or a stride is not a multiple of 16 bytes the tile
// is copied one element at a time through registers.
// Tiles keep the input type (bf16 is widened as it is read). K tiles are
// stored with the 16-byte chunks of row r XOR-swizzled by r & 7, so the 8
// kv rows a quarter-warp reads lie in distinct banks; Q, V and P need no
// swizzle (a quarter-warp reads one Q or P row, and 128 contiguous bytes
// of a V row). p is written to shared memory rounded to T for P V. kv tiles
// above the diagonal are never visited and only the diagonal tile is
// masked, so any S >= 1 works. Element strides for q, k, v and o; the dh
// axis must be contiguous.
//
// Both bodies set their shared-memory limit once per device, not per call.
#include "wgmma_common.cuh"

namespace {

using repro::smem_limit_once;

constexpr int kMaxDh = 256;

struct Strides {
  long long b, h, s;  // element strides of the batch, head and sequence axes
};

// Both bodies' softmax runs in the log2 domain: scores times log2(e) / sqrt(dh).
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

namespace simt {

constexpr int kB = 64;  // query rows per block and kv rows per tile

// Threads, blocks per SM and shared memory of the head-dim class DH.
template <int DH>
struct Cfg {
  static constexpr int kThreads = DH <= 128 ? 128 : 256;
  static constexpr int kMinBlocks = DH <= 128 ? 2 : 1;
  static constexpr int RT = kThreads / 16;  // row groups
  static constexpr int TR = kB / RT;        // query rows per thread
  static constexpr int TS = kB / 16;        // score columns per thread
  static constexpr int TO = DH / 64;        // float4 groups of acc columns per thread
  template <typename T>
  __host__ __device__ static constexpr int tile_bytes() {
    return kB * DH * static_cast<int>(sizeof(T));
  }
  // Q, a ring of two K/V tile slots, P (fp32)
  template <typename T>
  __host__ __device__ static constexpr int smem_bytes() {
    return 3 * tile_bytes<T>() + kB * kB * 4;
  }
};

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 4 consecutive elements from shared memory, widened to fp32.
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// 16 bytes global -> shared, the last 16 - bytes of them zero.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one of this thread's committed copy groups is pending.
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows row0 .. row0 + 63 (row r at src + r * s_stride, dh contiguous
// elements) into a tile of kB rows of DH elements at dst, zero where a row
// is >= S or a column >= dh. swz: chunk c of row r lands at chunk c ^ (r & 7).
// vec: 16-byte cp.async (every row 16-byte aligned), else one element at a
// time, synchronously. All threads of the block call it.
template <typename T, int DH, int NT>
__device__ __forceinline__ void stage(char* dst, const T* __restrict__ src, long long s_stride,
                                      int row0, int S, int dh, bool swz, bool vec) {
  constexpr int E = sizeof(T), RB = DH * E, NCH = RB / 16;
  if (vec) {  // thread t copies chunk t % NCH of rows t / NCH + RSTEP m
    constexpr int RSTEP = NT / NCH, PER = kB / RSTEP;
    static_assert(NT % NCH == 0 && kB % RSTEP == 0, "whole chunks per thread");
    const int c = threadIdx.x % NCH, r0 = threadIdx.x / NCH;
    const int left = dh * E - c * 16;
    const int bytes = left >= 16 ? 16 : max(left, 0);
    const char* base = reinterpret_cast<const char*>(src);
    const char* g = base + static_cast<long long>(row0 + r0) * s_stride * E + c * 16;
    const long long step = static_cast<long long>(RSTEP) * s_stride * E;
    const uint32_t d0 = repro::smem_u32(dst) + r0 * RB;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int r = r0 + RSTEP * m;
      const bool in = row0 + r < S && bytes > 0;
      cp_async16(d0 + m * RSTEP * RB + (swz ? c ^ (r & 7) : c) * 16, in ? g + m * step : base,
                 in ? bytes : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kB * DH; i += NT) {
      const int r = i / DH, d = i - r * DH;
      T x = T(0.f);
      if (row0 + r < S && d < dh) x = src[static_cast<long long>(row0 + r) * s_stride + d];
      const int c = d * E / 16;
      *reinterpret_cast<T*>(dst + r * RB + (swz ? c ^ (r & 7) : c) * 16 + d * E % 16) = x;
    }
  }
}

// Block L of the 1-D grid: query tile n_q - 1 - L / (H * B) (heaviest
// first across all heads), head L % H, batch row (L / H) % B.
template <typename T, int DH>
__global__ void __launch_bounds__(Cfg<DH>::kThreads, Cfg<DH>::kMinBlocks)
fa_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int H, int B,
               int group, int S, int dh, int n_q, float scale_log2, int vec) {
  using C = Cfg<DH>;
  constexpr int NT = C::kThreads, RT = C::RT, TR = C::TR, TS = C::TS, TO = C::TO;
  constexpr int E = sizeof(T), RB = DH * E, TILE = C::template tile_bytes<T>();
  extern __shared__ __align__(128) char smem[];
  char* qsm = smem;              // [kB][DH] Q
  char* ring = smem + TILE;      // 2 slots of [kB][DH]: K0, V0, K1, V1, ...
  float* ps = reinterpret_cast<float*>(smem + 3 * TILE);  // [kB][kB] p rounded to T

  const int L = blockIdx.x;
  const int hb = L % (H * B);
  const int qt = n_q - 1 - L / (H * B);
  const int h = hb % H, b = hb / H, hk = h / group;
  const int q0 = qt * kB;
  const int n_units = 2 * (qt + 1);  // K and V of kv tiles 0 .. qt
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  auto issue = [&](int u) {  // unit u: K (even) or V (odd) of kv tile u / 2
    if (u >= n_units) return;
    char* dst = ring + (u & 1) * TILE;
    if (u & 1)
      stage<T, DH, NT>(dst, vp, vs.s, (u / 2) * kB, S, dh, false, vec);
    else
      stage<T, DH, NT>(dst, kp, ks.s, (u / 2) * kB, S, dh, true, vec);
  };
  stage<T, DH, NT>(qsm, qp, qs.s, q0, S, dh, false, vec);
  issue(0);
  cp_async_commit();

  float m[TR], l[TR], acc[TR][TO][4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = repro::kNegInfMask;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < TO; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
  }
  const int nd = (dh + 3) & ~3;  // head-dim columns read (zero past dh)
  const T* qrow = reinterpret_cast<const T*>(qsm) + ty * DH;
  const int kkey = tx & 7;       // swizzle of kv rows tx + 16 j

  for (int u = 0; u < n_units; ++u) {
    __syncthreads();  // every thread is done with unit u - 1's slot
    issue(u + 1);
    cp_async_commit();
    cp_async_wait_1();  // this thread's copies of Q and unit u have landed
    __syncthreads();    // and every other thread's
    const char* slot = ring + (u & 1) * TILE;
    const int kt = u / 2;
    if ((u & 1) == 0) {
      // s = q . k^T over dh: rows ty + RT i, columns tx + 16 j
      float s[TR][TS];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TS; ++j) s[i][j] = 0.f;
      const char* krow = slot + tx * RB;
#pragma unroll 2
      for (int d = 0; d < nd; d += 4) {
        const int byte = d * E;
        const int koff = (((byte >> 4) ^ kkey) << 4) | (byte & 15);
        float4 a[TR], c[TS];
#pragma unroll
        for (int i = 0; i < TR; ++i) a[i] = ld4(qrow + i * RT * DH + d);
#pragma unroll
        for (int j = 0; j < TS; ++j)
          c[j] = ld4(reinterpret_cast<const T*>(krow + j * 16 * RB + koff));
        // one d at a time over all TR x TS sums, so consecutive FMAs never
        // wait on each other
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TS; ++j) s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TS; ++j) s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TS; ++j) s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TS; ++j) s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
      }
      // scale (log2 domain), causal mask on the diagonal tile, online
      // softmax; p rounded to T into shared memory
      const bool diag = kt == qt;
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int r = ty + RT * i;
        float mx = repro::kNegInfMask;
#pragma unroll
        for (int j = 0; j < TS; ++j) {
          float x = s[i][j] * scale_log2;
          if (diag && tx + 16 * j > r) x = repro::kNegInfMask;
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int off = 8; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = ex2(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < TS; ++j) {
          const float p = ex2(s[i][j] - m_new);
          sum += p;
          ps[r * kB + tx + 16 * j] = round_to(p, T());
        }
        l[i] = l[i] * alpha + sum;  // this thread's columns; summed over the row at the end
        m[i] = m_new;
#pragma unroll
        for (int jj = 0; jj < TO; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][jj][e] *= alpha;
      }
    } else {
      // acc += p . v: rows ty + RT i, columns 4 tx + 64 jj + e
      const T* vt = reinterpret_cast<const T*>(slot) + 4 * tx;
      const float* prow = ps + ty * kB;
#pragma unroll 2
      for (int c = 0; c < kB; c += 4) {
        float4 pr[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i) pr[i] = *reinterpret_cast<const float4*>(prow + i * RT * kB + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int jj = 0; jj < TO; ++jj) {
            const float4 vv = ld4(vt + (c + cc) * DH + 64 * jj);
#pragma unroll
            for (int i = 0; i < TR; ++i) {
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
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off /= 2) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ty + RT * i;
    if (r >= S) continue;
    T* orow = o + b * os.b + h * os.h + static_cast<long long>(r) * os.s;
#pragma unroll
    for (int jj = 0; jj < TO; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * jj + e;
        if (d < dh) store(orow + d, acc[i][jj][e] / l[i]);
      }
  }
}

// Whether a tensor's rows can be copied 16 bytes at a time: its base
// pointer and every batch, head and sequence stride (of an axis longer
// than 1) on a 16-byte boundary.
template <typename T>
bool rows_16b(const void* p, Strides st, int B, int heads, int S) {
  const long long e = sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (B == 1 || st.b * e % 16 == 0) &&
         (heads == 1 || st.h * e % 16 == 0) && (S == 1 || st.s * e % 16 == 0);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides qs,
                   Strides ks, Strides vs, Strides os, int B, int H, int H_kv, int S, int dh,
                   cudaStream_t stream) {
  constexpr int smem = Cfg<DH>::template smem_bytes<T>();
  auto kern = fa_simt_kernel<T, DH>;
  cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory, so kMinBlocks fit
  static const cudaError_t carve = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return carve;
  const int vec = rows_16b<T>(q, qs, B, H, S) && rows_16b<T>(k, ks, B, H_kv, S) &&
                  rows_16b<T>(v, vs, B, H_kv, S);
  const int n_q = (S + kB - 1) / kB;
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(dh));
  kern<<<n_q * H * B, Cfg<DH>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qs, ks, vs, os, H, B, H / H_kv, S, dh, n_q, scale_log2, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, Strides qs,
                     Strides ks, Strides vs, Strides os, int B, int H, int H_kv, int S, int dh,
                     cudaStream_t s) {
  if (static_cast<long long>((S + kB - 1) / kB) * H * B > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (dh <= 64) return launch<T, 64>(q, k, v, o, qs, ks, vs, os, B, H, H_kv, S, dh, s);
  if (dh <= 128) return launch<T, 128>(q, k, v, o, qs, ks, vs, os, B, H, H_kv, S, dh, s);
  return launch<T, 256>(q, k, v, o, qs, ks, vs, os, B, H, H_kv, S, dh, s);
}

}  // namespace simt

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
    return simt::dispatch<float>(q, k, v, o, qs, ks, vs, os, B, H, H_kv, S, dh, s);
  if (dtype == repro::kDtypeBF16)
    return simt::dispatch<__nv_bfloat16>(q, k, v, o, qs, ks, vs, os, B, H, H_kv, S, dh, s);
  return cudaErrorInvalidValue;
}
