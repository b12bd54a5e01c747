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
// pointers and batch/head/sequence strides), the tensor-core body, in the
// pattern of FlashAttention-3:
// - Work items of (128-row query tile, head, batch row), heaviest first
//   (most kv tiles), dealt over a persistent grid of min(SMs, items) blocks
//   of 384 threads, one per SM, in rows of the grid size, every other row
//   backwards (tc::item_at; kernels/flash_attention.py::wgmma_schedule
//   mirrors it): at qwen2-1.5b's S 2048, 192 items on 132 SMs, the makespan
//   the heaviest item's 16 kv tiles against a mean of 12.4.
// - A producer warpgroup that gives its registers up (setmaxnreg: 40 per
//   thread, 232 for each consumer thread) and two consumer warpgroups that
//   own 64 query rows each. The producer's lane 0 issues TMA loads
//   (cp.async.bulk.tensor, 4-D tensor maps over (dh, S, heads, B) built on
//   the host from the element strides, passed as __grid_constant__): an
//   item's Q once the consumers have read the previous item's Q for the
//   last time (so the next Q lands while the current item finishes), then
//   whole 128-row K and V tiles into two rings (2 stages at dh 128, 4 at dh
//   64) with full/empty mbarriers of their own. Rows >= S and head-dim
//   columns >= dh arrive as TMA's zero fill (no masked loads).
// - Shared memory holds each tile as 64-column (128-byte) regions with the
//   128-byte swizzle: Q, the K ring, the V ring and an O staging tile, 192
//   KB at dh 128 (161 KB at dh 64).
// - S = Q K^T is wgmma.mma_async m64n128k16 (bf16 in, fp32 accumulate), Q
//   and K read K-major from shared memory, one product per k16 slice over
//   all 128 kv rows (two n64 halves would read Q from shared memory twice).
//   The online softmax runs on the accumulator registers (each row's m and
//   l shared by the 4 lanes holding it, quad shuffles), in the log2 domain
//   (ex2 of the scores times log2(e)/sqrt(dh)); the causal mask (-1e9)
//   only on the diagonal tile, kv tiles above it never visited.
// - O += P V is wgmma with P as the A operand in registers: the score
//   accumulator after the softmax, rounded to bf16 (the Pallas kernel's
//   p.astype(v.dtype)), repacked in place (the m64nNk16 accumulator layout
//   of two n8 column blocks is the A fragment of one k16 slice). V is read
//   from the same swizzled tiles through wgmma's transpose bit (MN-major B),
//   all dh columns in one product per k16 slice.
// - Pipelined inside each warpgroup: S of kv tile j and P V of tile j - 1
//   issue together; the softmax of tile j runs while P V is in flight, and
//   O is rescaled once it has landed. Across the two warpgroups, named
//   barriers make them take turns to issue (ping-pong), so one warpgroup's
//   softmax runs under the other's products.
// - Each output element sees the same products, roundings and rescales in
//   the same order as in a body that waits on every product (the pipeline
//   moves only when they issue), so the output is bit for bit that body's,
//   whichever block or turn computes an item.
// - The epilogue writes o / l in bf16 into the staging tile (16-byte chunks
//   XOR-swizzled by row) and stores it with 16-byte coalesced stores, in
//   q's axis order.
//
// Body "simt" (the CUDA-core body: fp32, dh not a multiple of 16 or above
// 128, data TMA cannot address; dh <= 256), bound by the fp32 FMAs of the
// two products. Templated on the head-dim class DH (64, 128, 256: dh
// rounded up). One block per (64-row query tile, head, batch row), the
// heaviest query tiles first across all heads (the item order of the wgmma
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
// Body "wgmma": tensor cores on TMA-staged Q/K/V (bf16)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 128;                   // query rows per work item (two warpgroups)
constexpr int kBK = 128;                   // kv rows per tile
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 128; // + the producer warpgroup
constexpr int kRegion = 128 * 128;         // bytes of one 64-column region of a 128-row tile
constexpr int kMaxDh = 128;
// Registers per thread after setmaxnreg: the producer warpgroup gives its
// registers up to the consumers, which hold O (NC x 32 fp32), S (64 fp32)
// and the P fragments of the product in flight (32): 128 x 40 + 256 x 232
// <= 65,536.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// Named barriers: 1 and 2 order the two warpgroups' products (warpgroup
// w issues on 1 + w), 3 and 4 are each warpgroup's own.
constexpr int kTurnBar = 1, kOwnBar = 3;

// K and V ring depth of the head-dim class (NC 64-column regions): 2 at
// dh 128, 4 at dh 64.
template <int NC>
__host__ __device__ constexpr int stages() {
  return NC == 1 ? 4 : 2;
}

// Q, the K ring, the V ring and the O staging tile (a 128-row tile each
// slot), 4 barriers per stage and 2 for Q, 1 KB to align the base:
// 197,712 bytes at dh 128, 165,008 at dh 64.
template <int NC>
constexpr int smem_bytes() {
  return (2 + 2 * stages<NC>()) * NC * kRegion + 8 * (4 * stages<NC>() + 2) + 1024;
}

// Work item r of block `blk` in a grid of G blocks: the items, heaviest
// first (item L is query tile n_q - 1 - L / (H * B), head L % H, batch row
// (L / H) % B), are dealt in rows of G, every other row backwards, so a
// block that took a heavy item in one row takes a light one in the next
// (kernels/flash_attention.py::wgmma_schedule mirrors it).
__device__ __forceinline__ int item_at(int r, int blk, int G) {
  return r * G + ((r & 1) ? G - 1 - blk : blk);
}

using repro::bar_arrive;
using repro::bar_sync;
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
using repro::wgmma_wait;

// S = Q K^T for this warpgroup's 64 query rows over the 128 kv rows, one
// m64n128k16 product per k16 slice of the NC regions (columns past dh are
// TMA's zero fill and add exact zeros; a product under a branch would make
// ptxas serialize them).
template <int NC>
__device__ __forceinline__ void issue_qk(float (&sacc)[64], uint32_t q_wg, uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < 4 * NC; ++kk) {
    const uint32_t off = (kk / 4) * kRegion + (kk % 4) * 32;
    repro::Mma<128>::ss(sacc, sw128_desc(q_wg + off), sw128_desc(kt + off), kk > 0);
  }
}

// O += P V: P the bf16 A fragments in registers, V transposed by the
// descriptor (MN-major B). At NC 2 one m64n128k16 product per k16 slice
// reads both 64-column regions of V (the descriptor's leading byte offset
// is the region stride), each region's accumulators the halves of O.
template <int NC>
__device__ __forceinline__ void issue_pv(float (&oacc)[NC][32], const uint32_t (&pa)[8][4],
                                         uint32_t vt) {
  if constexpr (NC == 2) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs_tb(oacc[0], oacc[1], pa[kk], sw128_desc(vt + kk * 16 * 128, kRegion));
  } else {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs_tb(oacc[0], pa[kk], sw128_desc(vt + kk * 16 * 128));
  }
}

// The online softmax of one kv tile on this thread's score accumulators
// (log2 domain; the causal mask on the diagonal tile only, DIAG): the new
// row maxima m, alpha = exp2(m_old - m_new), p in place of s, l = l alpha +
// sum p (each row's m and l shared by the 4 lanes holding it).
template <bool DIAG>
__device__ __forceinline__ void softmax_tile(float (&sacc)[64], float scale_log2, int k0,
                                             int row0, int tq4, float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {repro::kNegInfMask, repro::kNegInfMask};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int rr = (i >> 1) & 1;
    float x = sacc[i] * scale_log2;
    if (DIAG && k0 + 8 * (i >> 2) + 2 * tq4 + (i & 1) > row0 + 8 * rr) x = repro::kNegInfMask;
    sacc[i] = x;
    mx[rr] = fmaxf(mx[rr], x);
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    const float m_new = fmaxf(m[rr], mx[rr]);
    alpha[rr] = ex2(m[rr] - m_new);
    m[rr] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int rr = (i >> 1) & 1;
    const float p = ex2(sacc[i] - m[rr]);
    sacc[i] = p;
    rs[rr] += p;
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    rs[rr] += __shfl_xor_sync(0xffffffffu, rs[rr], 1);
    rs[rr] += __shfl_xor_sync(0xffffffffu, rs[rr], 2);
    l[rr] = l[rr] * alpha[rr] + rs[rr];
  }
}

// O *= alpha, then P (bf16) as A fragments: slice kk covers kv rows
// 16 kk .. 16 kk + 15 (the m64nNk16 accumulator layout of two n8 column
// blocks is the A fragment of one k16 slice).
template <int NC>
__device__ __forceinline__ void rescale_and_pack(float (&oacc)[NC][32], const float (&sacc)[64],
                                                 uint32_t (&pa)[8][4], const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[c][i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int i0 = 8 * kk;
    pa[kk][0] = pack_bf16(sacc[i0 + 0], sacc[i0 + 1]);  // row g,     k 2 tq4 ..
    pa[kk][1] = pack_bf16(sacc[i0 + 2], sacc[i0 + 3]);  // row g + 8, k 2 tq4 ..
    pa[kk][2] = pack_bf16(sacc[i0 + 4], sacc[i0 + 5]);  // row g,     k 8 + 2 tq4 ..
    pa[kk][3] = pack_bf16(sacc[i0 + 6], sacc[i0 + 7]);  // row g + 8, k 8 + 2 tq4 ..
  }
}

// One block of 384 threads per SM (at most one per work item) walks its
// work items (item_at); per item, warpgroup wg of the two consumers owns
// query rows q0 + 64 wg .. + 63.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                Strides os, int H, int B, int group, int S, int dh, int n_q, float scale_log2) {
  constexpr int ST = stages<NC>();
  constexpr int TILE = NC * kRegion;  // one 128-row tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;               // Q: NC regions of 128 rows
  const uint32_t sk = sq + TILE;          // K ring, ST tiles
  const uint32_t sv = sk + ST * TILE;     // V ring, ST tiles
  const uint32_t so = sv + ST * TILE;     // O staging: 128 rows of dh bf16
  const uint32_t bars = so + TILE;
  unsigned char* so_ptr = smem_raw + (so - raw);
  auto full_k = [&](int s) { return bars + 8u * s; };
  auto full_v = [&](int s) { return bars + 8u * (ST + s); };
  auto empty_k = [&](int s) { return bars + 8u * (2 * ST + s); };
  auto empty_v = [&](int s) { return bars + 8u * (3 * ST + s); };
  const uint32_t q_full = bars + 8u * (4 * ST), q_empty = q_full + 8u;
  const int n_items = n_q * H * B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumers);
      mbar_init(empty_v(s), kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers / 32) {
    // -- producer warpgroup: one lane issues every TMA load. Per item: Q
    // once the consumers are done with the previous item's Q (q_empty),
    // then K and V of each kv tile into the rings. ----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      int kv = 0;  // kv tiles loaded so far by this block (ring position)
      for (int r = 0;; ++r) {
        const int L = item_at(r, blockIdx.x, gridDim.x);
        if (L >= n_items) break;
        const int hb = L % (H * B), qt = n_q - 1 - L / (H * B);
        const int h = hb % H, b = hb / H, hk = h / group;
        if (r > 0) mbar_wait(q_empty, (r - 1) & 1);
        mbar_expect_tx(q_full, TILE);
        for (int c = 0; c < NC; ++c)
          tma_load_4d(sq + c * kRegion, &tq, q_full, 64 * c, qt * kBQ, h, b);
        for (int kt = 0; kt <= qt; ++kt, ++kv) {
          const int s = kv % ST;
          const uint32_t ph = ((kv / ST) - 1) & 1;
          if (kv >= ST) mbar_wait(empty_k(s), ph);
          mbar_expect_tx(full_k(s), TILE);
          for (int c = 0; c < NC; ++c)
            tma_load_4d(sk + s * TILE + c * kRegion, &tk, full_k(s), 64 * c, kt * kBK, hk, b);
          if (kv >= ST) mbar_wait(empty_v(s), ph);
          mbar_expect_tx(full_v(s), TILE);
          for (int c = 0; c < NC; ++c)
            tma_load_4d(sv + s * TILE + c * kRegion, &tv, full_v(s), 64 * c, kt * kBK, hk, b);
        }
      }
    }
    return;
  }

  // -- consumers --------------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, tq4 = lane % 4;
  const int my_turn = kTurnBar + wg, other_turn = kTurnBar + 1 - wg;
  const uint32_t q_wg = sq + wg * 64 * 128;
  // accumulator element i of a 64 x N product: row 16 w + g + 8 ((i >> 1) & 1),
  // column 8 (i >> 2) + 2 tq4 + (i & 1)
  float sacc[64], oacc[NC][32];
  uint32_t pa[8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
  // Ping-pong: the warpgroups take turns to issue their products, so one
  // softmax runs under the other warpgroup's products. Warpgroup 0 goes
  // first.
  if (wg == 1) bar_arrive(kTurnBar, kConsumers);

  int kv = 0;  // kv tiles consumed by this block, as the producer counts them
  for (int r = 0;; ++r) {
    const int L = item_at(r, blockIdx.x, gridDim.x);
    if (L >= n_items) break;
    const int hb = L % (H * B), qt = n_q - 1 - L / (H * B);
    const int h = hb % H, b = hb / H;
    const int q0 = qt * kBQ, n_kv = qt + 1;  // kBK == kBQ: the last tile holds the diagonal
    const int row0 = q0 + 64 * wg + 16 * w + g;
    float m[2] = {repro::kNegInfMask, repro::kNegInfMask}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[c][i] = 0.f;
    mbar_wait(q_full, r & 1);

    // kv tile 0: S alone
    {
      const int s = kv % ST;
      mbar_wait(full_k(s), (kv / ST) & 1);
      bar_sync(my_turn, kConsumers);
      fence_regs(sacc);
      wgmma_fence();
      issue_qk<NC>(sacc, q_wg, sk + s * TILE);
      wgmma_commit();
      bar_arrive(other_turn, kConsumers);
      wgmma_wait<0>();
      fence_regs(sacc);
      mbar_arrive(empty_k(s));
      if (n_kv == 1) mbar_arrive(q_empty);
      if (n_kv == 1)
        softmax_tile<true>(sacc, scale_log2, 0, row0, tq4, m, l, alpha);
      else
        softmax_tile<false>(sacc, scale_log2, 0, row0, tq4, m, l, alpha);
      rescale_and_pack<NC>(oacc, sacc, pa, alpha);
    }
    // kv tile kt: S of tile kt and O += P V of tile kt - 1 issued together;
    // the softmax of tile kt runs while P V is in flight, and O is rescaled
    // once P V has landed.
    for (int kt = 1; kt < n_kv; ++kt) {
      const int sp = kv % ST;
      const uint32_t php = (kv / ST) & 1;
      ++kv;
      const int s = kv % ST;
      mbar_wait(full_k(s), (kv / ST) & 1);
      mbar_wait(full_v(sp), php);
      bar_sync(my_turn, kConsumers);
      fence_regs(sacc);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(oacc[c]);
      wgmma_fence();
      issue_qk<NC>(sacc, q_wg, sk + s * TILE);
      wgmma_commit();
      issue_pv<NC>(oacc, pa, sv + sp * TILE);
      wgmma_commit();
      bar_arrive(other_turn, kConsumers);
      wgmma_wait<1>();  // S has landed; P V may still run
      fence_regs(sacc);
      mbar_arrive(empty_k(s));
      if (kt == n_kv - 1) mbar_arrive(q_empty);  // the item's last read of Q
      if (kt == n_kv - 1)
        softmax_tile<true>(sacc, scale_log2, kt * kBK, row0, tq4, m, l, alpha);
      else
        softmax_tile<false>(sacc, scale_log2, kt * kBK, row0, tq4, m, l, alpha);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(oacc[c]);
      mbar_arrive(empty_v(sp));
      rescale_and_pack<NC>(oacc, sacc, pa, alpha);
    }
    // the last tile's P V
    {
      const int sp = kv % ST;
      mbar_wait(full_v(sp), (kv / ST) & 1);
      ++kv;
      bar_sync(my_turn, kConsumers);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(oacc[c]);
      wgmma_fence();
      issue_pv<NC>(oacc, pa, sv + sp * TILE);
      wgmma_commit();
      bar_arrive(other_turn, kConsumers);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(oacc[c]);
      mbar_arrive(empty_v(sp));
    }

    // epilogue: o = acc / l in bf16 into this warpgroup's 64 rows of the
    // staging tile (row pitch NC x 128 bytes, 16-byte chunk c of row rw at
    // c ^ (rw & 7): a warp's 4-byte writes and a quarter-warp's 16-byte
    // reads hit distinct banks), then 16-byte coalesced stores in q's axis
    // order.
    constexpr int CH = NC * 8;  // 16-byte chunks per staged row
    unsigned char* so_wg = so_ptr + wg * 64 * CH * 16;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int rw = 16 * w + g + 8 * rr;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * rr;
          *reinterpret_cast<uint32_t*>(so_wg + rw * CH * 16 + (((8 * c + j) ^ (rw & 7)) << 4) +
                                       4 * tq4) =
              pack_bf16(oacc[c][i] / l[rr], oacc[c][i + 1] / l[rr]);
        }
    }
    bar_sync(kOwnBar + wg, 128);
    __nv_bfloat16* ob = o + b * os.b + h * os.h;
    const int ct = threadIdx.x % 128;
#pragma unroll
    for (int p = 0; p < 64 * CH / 128; ++p) {
      const int idx = 128 * p + ct, rw = idx / CH, c16 = idx % CH;
      const int row = q0 + 64 * wg + rw;
      if (row < S && c16 * 8 < dh)
        *reinterpret_cast<uint4*>(ob + static_cast<long long>(row) * os.s + c16 * 8) =
            *reinterpret_cast<const uint4*>(so_wg + rw * CH * 16 + ((c16 ^ (rw & 7)) << 4));
    }
    // The staging tile is written again only after this warpgroup's next
    // turn barrier, which every one of its threads reaches after these reads.
  }
  // warpgroup 1's last turn signal, so no barrier is left half arrived
  if (wg == 0) bar_sync(kTurnBar, kConsumers);
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

// Streaming multiprocessors of the current device, read once per device.
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
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
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const int n_q = (S + kBQ - 1) / kBQ;
  const long long items = static_cast<long long>(n_q) * H * B;
  const int grid = static_cast<int>(items < sms ? items : sms);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(dh));
  kern<<<grid, kThreads, smem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o), os, H, B,
                                         H / H_kv, S, dh, n_q, scale_log2);
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
        !tc::takes(o, os, B, H, S, dh) ||
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
