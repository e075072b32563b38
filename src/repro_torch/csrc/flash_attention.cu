// Kernel K9: causal (or full) GQA flash-attention forward for Hopper
// (sm_90a), the attention of the LM training forward.  q [B, S, H, D] and
// k, v [B, S, K, D] in the model's layout (H % K == 0, query head h reads
// KV head h / G, G = H / K), out [B, S, H, D] in q's dtype; fp32 or bf16.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd (_flash_kernel), and computes what it computes: an
// online softmax over 64-key tiles with the running max m, the normalizer l
// and the accumulator acc in fp32; fp32 scores (q . k) * scale; the
// fully-masked-row guards (a row whose running max is still -inf takes p =
// 0 and alpha = 0); p kept in fp32 in value for PV (never rounded to the
// value dtype); out = acc / max(l, 1e-20) cast once.  Tiles strictly above
// every row's diagonal are skipped under the causal mask.  The TPU kernel
// asserts S % block == 0; here the ragged tail is masked instead (keys at
// or past S score -inf, queries past S are not written), so any S runs.
//
// What bounds it: operations.  Causal at qwen2-0.5b's training shape (B 8,
// S 1024, 14 query / 2 KV heads of 64) the function is 4 * B * H * D *
// S(S + 1) / 2 = 15.05 GFLOP on 33.6 MB of q, k, v and out: 0.0152 ms at
// the H100's bf16 tensor-core rate (989 TFLOP/s) against 0.010 ms of memory
// at 3.35 TB/s (NVIDIA's data sheet).  Keeping p fp32 on the bf16 tensor
// cores costs a second PV product (below), 6 * D flops a pair: 0.0228 ms.
//
// Two bodies, chosen by (dtype, D) and nothing else:
//
// * bf16 at D = 64 and 128 (qwen2-0.5b's 14 / 2 heads of 64, minitron-4b's
//   24 / 8 of 128): the tensor-core body, `flash_wgmma_kernel`.  One
//   warpgroup (128 threads) per 64-row tile of a (KV head, request); a row
//   is a (token, group head) pair, token-major, so the G query heads of a
//   token are neighbouring rows and every K/V tile serves all of them (each
//   KV head's tiles are read once per 64 rows, not once per query head).
//   The tiles run heaviest first across the whole grid (the last causal
//   tiles sweep the most keys).  Q is staged once; K and V go in 64-key
//   tiles anchored at key 0, by 16-byte cp.async copies, two stages deep,
//   into 128-byte-swizzled bf16 halves, so the next tile's K and V land
//   while this tile's products and softmax run.  QK^T is
//   `wgmma.m64n64k16` with Q and K from shared memory (fp32 scores, the
//   scale after the dot); the row max and sum come from quad shuffles of
//   the accumulator layout; the O accumulator (D / 64 m64n64 tiles) is
//   rescaled by alpha; then p is split into two bf16 terms, h1 = bf16(p)
//   and h2 = bf16(p - h1) (|p - h1 - h2| <= 2^-17 p), each the A operand of
//   `wgmma.m64n64k16` from registers against the V tile (MN-major), h1's
//   four k16 steps before h2's, into the fp32 accumulator.  Each product of
//   a term and a bf16 V value is exact, so PV sums p's 16 significant bits
//   where the TPU kernel sums its 24: ~2^-17 of sum |p v|, far below an
//   output's bf16 ulp.  A tile in which a row sees no key leaves its m, l
//   and acc unchanged bit for bit (m_new = m, alpha = 1, p = 0).  The
//   softmax's scalar work and the waits on each product, not the tensor
//   cores, set the pace, so blocks resident on an SM are what count: at
//   two stages a D = 64 block takes 41 KB and 128 registers (four an SM),
//   a D = 128 block 81 KB and 184 (two).  Three stages, two warpgroups a
//   block sharing each K/V tile, and the next tile's QK^T and softmax run
//   under this tile's PV were each slower on the card (PERF.md, K9).
// * fp32, and bf16 at D = 32 (reduced configurations only): the FFMA body,
//   `flash_ffma_kernel`, unchanged in arithmetic since it was first
//   written.  fp32 is held to 1e-5 of the plain version, which bf16 terms
//   of q, k and v cannot meet without a split of the operands that is
//   still untried.  This body scales q before the dot, (q * scale) . k in
//   fp32: at D = 64 the scale is 1/8 and the two orders give the same
//   number; otherwise they differ by the fp32 rounding of s.
//
// A row's result depends only on its own q, its position and the keys it
// sees: key tiles are anchored at 0, a row's sums run over its own tiles
// in key order (each thread's 16 columns in order, then a fixed shuffle
// tree over the row's 4 threads), and the tensor cores' sum for one output
// element reads only its own row.  So a request alone gives its rows in a
// batch bit for bit, and the causal rows 0..S'-1 of a call at S are those
// of a call at S' < S on the same inputs.
//
// The tensor-core machinery (copies, descriptors, swizzle, `wgmma` calls)
// is K2's, in ragged_prefill.cuh, and so is this body's online-softmax
// step (`online_step`, which K5/K7 share: mla_attention.cuh); every name
// there and here sits in an
// anonymous namespace, the shared-memory opt-in flags too (a static of a
// template with external linkage is one GNU-unique object across every
// library that holds it: the second library to launch would skip its own
// opt-in, CUDA error 1).
//
// Numerics: IEEE expf and division (build without --use_fast_math).

#include "ragged_prefill.cuh"

namespace {

// ---------------------------------------------------------------------------
// The tensor-core body: bf16, D = 64 and 128.

// Shared-memory layout, in bytes from a 1024-aligned base: the Q tile, then
// two stages of (K tile, V tile), each [64][D] bf16 in 128-byte-swizzled
// 64-column halves.  Key tile i sits in stage i % 2.
template <int D>
struct FlashLayout {
  static constexpr int kTile = (D / 64) * kHalf;
  static constexpr int kQ = 0;
  static constexpr int kStage = 2 * kTile;         // K, then V
  static constexpr int kKV = kTile;                // + stage * kStage
  static constexpr int kBytes = kKV + 2 * kStage;
};

// O += P V with p as two bf16 terms in the accumulator's row layout, h1 =
// bf16(p) and h2 = bf16(p - h1): h1's 4 k16 steps of 16 keys, then h2's,
// each one 64-column half of V (MN-major) per instruction.
template <int D>
__device__ __forceinline__ void pv_two_terms(float (&o)[D / 64][32],
                                             const float (&p)[32],
                                             uint32_t v) {
  uint32_t a[2][4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 8 * kk + 2 * r;
      const __nv_bfloat162 h = __floats2bfloat162_rn(p[j], p[j + 1]);
      a[0][kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      a[1][kk][r] = pack_bf16(p[j] - __low2float(h),
                              p[j + 1] - __high2float(h));
    }
  wg_fence();
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        wgmma_rs(o[h], a[t][kk], desc(v + h * kHalf + kk * 2048, 1024, 1024));
  wg_commit_wait();
#pragma unroll
  for (int h = 0; h < D / 64; ++h) pin(o[h]);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,   // [B, S, H, D]
                   const __nv_bfloat16* __restrict__ k,   // [B, S, K, D]
                   const __nv_bfloat16* __restrict__ v,   // [B, S, K, D]
                   __nv_bfloat16* __restrict__ out,       // [B, S, H, D]
                   int S, int H, int K, float scale) {
  using L = FlashLayout<D>;
  constexpr int kH = D / 64;
  constexpr int kC = D / 8;                  // 16-byte chunks a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);

  // heaviest tiles first, over the whole grid: tiles are the slowest index
  const int kh = blockIdx.x, b = blockIdx.y,
            tile = gridDim.z - 1 - blockIdx.z;
  const int G = H / K, n_rows = S * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = tile * kRows, t_first = r0 / G;
  // key tiles the block computes: causal rows stop at their own token
  const int n = kCausal ? (min(r0 + kRows, n_rows) - 1) / G / kSlots + 1
                        : (S + kSlots - 1) / kSlots;

  // this thread's two accumulator rows' tokens
  int t_row[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    t_row[e] = (r0 + 16 * warp + (lane >> 2) + 8 * e) / G;

  // the block's 64 query rows (zeros past S) into the swizzled Q tile
#pragma unroll
  for (int it = 0; it < kRows * kC / kThreads; ++it) {
    const int e = tid + it * kThreads, r = e / kC, c = e % kC;
    const int row = r0 + r, t = row / G;
    const bool ok = t < S;
    cp_async16(base + L::kQ + swz(r, c),
               q + (((size_t)b * S + (ok ? t : 0)) * H + kh * G + row % G)
                   * D + c * 8,
               ok ? 16 : 0);
  }
  // K and V of key tile i into stage i % 2 (zeros past S)
  auto issue = [&](int i) {
    const uint32_t kd = base + L::kKV + (i & 1) * L::kStage;
#pragma unroll
    for (int it = 0; it < kSlots * kC / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e / kC, c = e % kC;
      const int key = i * kSlots + r;
      const bool ok = key < S;
      const size_t at = (((size_t)b * S + (ok ? key : 0)) * K + kh) * D
                        + c * 8;
      cp_async16(kd + swz(r, c), k + at, ok ? 16 : 0);
      cp_async16(kd + L::kTile + swz(r, c), v + at, ok ? 16 : 0);
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[kH][32];
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[h][j] = 0.f;
  float s[32];

  issue(0);
  cp_async_commit();                         // Q and tile 0
  for (int i = 0; i < n; ++i) {
    cp_async_wait_all();                     // tile i (and Q) landed
    fence_async_smem();
    __syncthreads();                         // ... for every thread; and the
                                             // stage of tile i - 1 is free
    if (i + 1 < n) issue(i + 1);             // lands during this tile
    cp_async_commit();

    const uint32_t kt = base + L::kKV + (i & 1) * L::kStage;
    qk<D>(s, base + L::kQ, kt);
    // fp32 scores times the scale, then the mask where the tile reaches
    // past S or, causal, past the block's first token
    const bool masked = (i + 1) * kSlots > S
                        || (kCausal && (i + 1) * kSlots - 1 > t_first);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float x = s[j] * scale;
      if (masked) {
        const int key = i * kSlots + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        if (key >= S || (kCausal && key > t_row[(j >> 1) & 1]))
          x = -INFINITY;
      }
      s[j] = x;
    }
    float alpha[2];                          // o is rescaled in place
    online_step<kH>(s, m, l, o, alpha);
    pv_two_terms<D>(o, s, kt + L::kTile);
  }

  // out = acc / max(l, 1e-20), one bf16 cast; rows past S are not written
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = r0 + 16 * warp + (lane >> 2) + 8 * e;
    if (t_row[e] >= S) continue;
    const float den = fmaxf(l[e], 1e-20f);
    __nv_bfloat16* dst =
        out + (((size_t)b * S + t_row[e]) * H + kh * G + row % G) * D;
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(
            dst + 64 * h + 8 * c + 2 * (lane & 3)) =
            __floats2bfloat162_rn(o[h][4 * c + 2 * e] / den,
                                  o[h][4 * c + 2 * e + 1] / den);
  }
}

template <int D, bool kCausal>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int H, int K, float scale, cudaStream_t st) {
  const int tiles = (S * (H / K) + kRows - 1) / kRows;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  return launch_kernel<flash_wgmma_kernel<D, kCausal>>(
      dim3(K, B, tiles), FlashLayout<D>::kBytes + 1024, st,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), S, H, K, scale);
}

// ---------------------------------------------------------------------------
// The FFMA body: fp32 at D = 32, 64 and 128, and bf16 at D = 32.
//
// One block of 256 threads per (64-query tile, query head, request); the
// tiles run heaviest first (the last causal tile sweeps the most keys).
// The block stages its 64 queries (times scale, fp32) once, then sweeps
// 64-key tiles of its KV head: K and V staged in shared memory as fp32 (a
// zero-filled tail past S), scores of a 4 x 4 register tile per thread
// (rows 4 ty .. 4 ty + 3, keys tx + 16 j, so a quarter-warp reads 8
// different key rows through a 4-float pad without bank conflicts), the
// row max and sum by shuffles across the 16 threads of a row group, p
// staged in shared memory, then PV into each thread's 4 rows x D / 16
// columns (columns tx + 16 c: consecutive threads, consecutive banks).
// Each thread keeps m and l of its own 4 rows, so the alpha rescale needs
// no exchange.  GQA reads each KV head's tiles once per query head.
// Shared memory is 45, 68 and 116 KB a block at D = 32, 64 and 128
// (dynamic, opted in above 48 KB).  Its dot products sum d in ascending
// order with fmaf, on the fp32 CUDA cores (67 TFLOP/s peak).

constexpr int kFfmaBQ = 64, kFfmaBK = 64;
constexpr int kFfmaThreads = 256;        // 16 row groups x 16 threads
constexpr int kFfmaLp = kFfmaBK + 4;     // padded row of the p tile
static_assert(kFfmaBQ == kFfmaBK,
              "ffma_stage() moves 64-row tiles of q, k and v alike");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage rows [r0, r0 + 64) of one head of a [B, S, heads, D] tensor as
// fp32 into dst[64][D + 4], times mul; rows at or past S as zeros.
template <typename T, int D>
__device__ __forceinline__ void ffma_stage(float* __restrict__ dst,
                                           const T* __restrict__ src, int b,
                                           int head, int heads, int S,
                                           int r0, float mul) {
  constexpr int kLd = D + 4;
  for (int e = threadIdx.x * 4; e < kFfmaBK * D; e += kFfmaThreads * 4) {
    const int r = e / D, d = e % D;
    const int s = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) {
      v = load4(src + (((size_t)b * S + s) * heads + head) * D + d);
      v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * kLd + d) = v;
  }
}

template <int D>
struct FfmaSmem {
  float q[kFfmaBQ * (D + 4)];
  float k[kFfmaBK * (D + 4)];
  float v[kFfmaBK * (D + 4)];
  float p[kFfmaBQ * kFfmaLp];
};

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kFfmaThreads)
flash_ffma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int S, int H,
                  int K, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kC = D / 16;                  // output columns a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FfmaSmem<D>& sm = *reinterpret_cast<FfmaSmem<D>*>(smem_raw);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * kFfmaBQ;

  ffma_stage<T, D>(sm.q, q, b, h, H, S, q0, scale);   // q * scale in fp32

  float m[4], l[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  // keys a tile of queries can see: causal rows stop at their own position
  const int k_end = kCausal ? min(S, q0 + kFfmaBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kFfmaBK) {
    __syncthreads();                    // the last tile's k, v and p are done
    ffma_stage<T, D>(sm.k, k, b, kh, K, S, k0, 1.f);
    ffma_stage<T, D>(sm.v, v, b, kh, K, S, k0, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(sm.q + (ty * 4 + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = load4(sm.k + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float m_cur = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S || (kCausal && kpos > qpos)) s[i][j] = -INFINITY;
        m_cur = fmaxf(m_cur, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_new = fmaxf(m[i], m_cur);
      const bool live = m_new > -INFINITY;        // guard fully-masked rows
      const float safe = live ? m_new : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live ? expf(s[i][j] - safe) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = m[i] > -INFINITY ? expf(m[i] - safe) : 0.f;
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sm.p[(ty * 4 + i) * kFfmaLp + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int n = 0; n < kFfmaBK; n += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = load4(sm.p + (ty * 4 + i) * kFfmaLp + n);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) vv[c] = sm.v[(n + u) * kLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? pr[i].x : u == 1 ? pr[i].y
                         : u == 2 ? pr[i].z : pr[i].w;
#pragma unroll
          for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* row = out + (((size_t)b * S + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) store(row + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int D, bool kCausal>
int launch_ffma(const void* q, const void* k, const void* v, void* out,
                int B, int S, int H, int K, float scale, cudaStream_t st) {
  auto* kernel = flash_ffma_kernel<T, D, kCausal>;
  constexpr size_t kSmem = sizeof(FfmaSmem<D>);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((S + kFfmaBQ - 1) / kFfmaBQ, H, B);
  kernel<<<grid, kFfmaThreads, kSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, K, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out [B, S, H, D] and k, v [B, S, K, D], contiguous, 16-byte aligned;
// H % K == 0; D in {32, 64, 128}; bf16 != 0: every tensor bf16, else fp32.
// Scores are (q . k) * scale (the FFMA body: (q * scale) . k).  bf16 at D
// = 64 and 128 runs the tensor-core body, everything else the FFMA body.
// Returns 0 on success, else the cudaError_t of the refused or failed
// launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int K, int D,
                               int causal, float scale, int bf16,
                               void* stream) {
  if (B < 1 || S < 1 || K < 1 || H < 1 || H % K || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_LAUNCH(FN, ...)                                               \
  return causal ? FN<__VA_ARGS__, true>(q, k, v, out, B, S, H, K, scale, st) \
                : FN<__VA_ARGS__, false>(q, k, v, out, B, S, H, K, scale, st)
  if (bf16 && D == 64) FLASH_LAUNCH(launch_wgmma, 64);
  if (bf16 && D == 128) FLASH_LAUNCH(launch_wgmma, 128);
  if (bf16 && D == 32) FLASH_LAUNCH(launch_ffma, __nv_bfloat16, 32);
  if (!bf16 && D == 32) FLASH_LAUNCH(launch_ffma, float, 32);
  if (!bf16 && D == 64) FLASH_LAUNCH(launch_ffma, float, 64);
  if (!bf16 && D == 128) FLASH_LAUNCH(launch_ffma, float, 128);
#undef FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}
