// Kernel K4: sliding-window ragged chunk prefill for Hopper (sm_90a).  A
// batch of prompt chunks, row b holding T queries at absolute positions
// start[b] + t (the first n_live[b] real, the rest padding), each attending
// two key sources at once: the row's page ring as it stood *before* the
// chunk's writes, and the chunk's own fresh K/V.
//
// Replaces the Pallas TPU kernel repro/kernels/ragged_prefill/kernel.py::
// windowed_ragged_prefill_fwd (_windowed_ragged_prefill_kernel), bf16 ring
// pages or int8 ring pages with bf16 per-token-per-head scales; the fresh
// K/V are bf16 in both modes (never quantized).  Contract:
// repro/kernels/README.md "The ragged-prefill contract" (pre-write pool,
// window > 0) and "Scale-operand layout".  Masks (kernel.py:236-262):
//   ring slot i (ring = n_ring * ps slots) holds k_abs = last - ((last % ring
//     - i) mod ring) with last = start - 1, the last position written before
//     the chunk; at start == 0 every slot is negative.  Seen iff k_abs >= 0
//     and k_abs > q_abs - window;
//   fresh token f (k_abs = start + f) is seen iff f <= t, f < n_live and
//     k_abs > q_abs - window.
// Rows t >= n_live (chunk padding, discarded by the caller) are written as
// exact zeros; the plain version zeroes them too.
//
// What bounds it: the TPU body banks a [q_blk * G, (n_ring + n_fresh) * ps]
// fp32 score matrix in VMEM (kernel.py:327) -- 128 * 9 * 4368 * 4 bytes =
// 20 MB at q_blk 128, G 9 and a 258-page ring plus 16 fresh pages, far
// above the 227 KB of shared memory a Hopper block can hold (NVIDIA's data
// sheet).  The work is 4 * keys * H * D flops per query row against a few
// MB of ring and chunk: compute-bound, and this first version runs the dot
// products on the fp32 CUDA cores, not the tensor cores (PERF.md has its
// time against its bound).
//
// Design: K2's (csrc/ragged_prefill.cu).  One block per (q-tile, KV head,
// request), one thread per query row of the tile (a row is a (token, query
// head) pair of the GQA group, so each staged key page serves all G
// heads).  The row's query lives in registers as bf16 pairs (exact: q is
// bf16) and its fp32 accumulator in registers.  Instead of banking the
// scores the block sweeps the key pages three times -- the ring's pages,
// then the chunk's fresh pages -- recomputing every fp32 score with the
// same instruction sequence each time:
//   pass 1: the row's true max m over every key it sees;
//   pass 2: l = sum(exp(s - m));
//   pass 3: p = exp(s - m) / l, rounded to bf16 and back with bf16 pages
//           (the reference's a.astype(v.dtype)), kept fp32 with int8 pages
//           (the reference promotes the fresh K/V to fp32 next to the
//           dequantized ring, attn_backend.py:391-396); acc += p * v in
//           fp32.
// The two sources are two tile types staged into one fp32 tile: a ring page
// through the page table (int8 dequantized to f32(q) * f32(s) as it is
// staged), or ps rows of the fresh chunk.  The ring's pages are swept in
// the order of their absolute positions, oldest first, then the fresh
// pages, so the ring's length does not change the order of any sum (a ring
// with the speculative pool's slack page equals the plain ring bit for
// bit).  Before a page is staged the block computes its slots' absolute
// positions once (threads < ps) and skips the page when no row of the tile
// sees any of them -- ring pages that aged out of every row's window, fresh
// pages past the tile's last live row.  This is the single softmax at the
// row's true max that keeps the kernel exact against the reference -- it
// must not become an online softmax.  Unseen keys take no part (the
// reference's -1e30 entries add exp(-1e30 - m) = 0).  One bf16 cast at the
// output.
//
// Numerics: IEEE expf and division (build without --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // query rows per block
constexpr int kMaxPs = 32;      // tokens per page

// Stage one key page for KV head kh as fp32 rows of ``dst``: ring page
// ``kp`` (< n_ring) through the row's table, bf16 or int8 dequantized with
// the token's scale; or fresh page kp - n_ring, rows [f0, f0 + ps) of the
// chunk's K or V (rows at or past n_live are not read and stage zeros).
template <int D, bool kInt8>
__device__ __forceinline__ void stage_page(
    float (*dst)[D], const void* __restrict__ pages,
    const __nv_bfloat16* __restrict__ scales,
    const __nv_bfloat16* __restrict__ fresh, const int32_t* __restrict__ tb,
    int b, int kp, int n_ring, int kh, int ps, int K, int T, int nl) {
  if (kp < n_ring) {
    const int page = tb[kp];
    const size_t base = ((size_t)page * ps * K + kh) * D;
    for (int e = threadIdx.x; e < ps * D; e += blockDim.x) {
      const int t = e / D, d = e % D;
      const size_t at = base + (size_t)t * K * D + d;
      if constexpr (kInt8) {
        const float s =
            __bfloat162float(scales[((size_t)page * ps + t) * K + kh]);
        dst[t][d] = __fmul_rn((float)static_cast<const int8_t*>(pages)[at], s);
      } else {
        dst[t][d] =
            __bfloat162float(static_cast<const __nv_bfloat16*>(pages)[at]);
      }
    }
  } else {
    const int f0 = (kp - n_ring) * ps;
    for (int e = threadIdx.x; e < ps * D; e += blockDim.x) {
      const int t = e / D, d = e % D;
      const int f = f0 + t;
      dst[t][d] = f < nl ? __bfloat162float(
                               fresh[(((size_t)b * T + f) * K + kh) * D + d])
                         : 0.f;
    }
  }
}

// fp32 dot product of a bf16 query row (as pairs) with an fp32 key row, in
// ascending d, scaled after the dot as the reference does.
template <int D>
__device__ __forceinline__ float score(const __nv_bfloat162 (&qr)[D / 2],
                                       const float* __restrict__ k_row,
                                       float scale) {
  float s = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 k = reinterpret_cast<const float4*>(k_row)[d4];
    const float2 q01 = __bfloat1622float2(qr[2 * d4]);
    const float2 q23 = __bfloat1622float2(qr[2 * d4 + 1]);
    s = fmaf(q01.x, k.x, s);
    s = fmaf(q01.y, k.y, s);
    s = fmaf(q23.x, k.z, s);
    s = fmaf(q23.y, k.w, s);
  }
  return s * scale;
}

template <int D, bool kInt8>
__global__ void __launch_bounds__(kThreads)
windowed_prefill_kernel(const __nv_bfloat16* __restrict__ q,      // [B, T, H, D]
                        const __nv_bfloat16* __restrict__ k_new,  // [B, T, K, D]
                        const __nv_bfloat16* __restrict__ v_new,  // [B, T, K, D]
                        const void* __restrict__ k_pages,         // [P, ps, K, D]
                        const void* __restrict__ v_pages,         // [P, ps, K, D]
                        const __nv_bfloat16* __restrict__ k_scale,  // [P, ps, K]
                        const __nv_bfloat16* __restrict__ v_scale,  // [P, ps, K]
                        const int32_t* __restrict__ tables,       // [B, n_ring]
                        const int32_t* __restrict__ start,        // [B]
                        const int32_t* __restrict__ n_live,       // [B]
                        __nv_bfloat16* __restrict__ out,          // [B, T, H, D]
                        int T, int H, int K, int ps, int n_ring, int window,
                        int qt, float scale) {
  __shared__ __align__(16) float k_s[kMaxPs][D];
  __shared__ __align__(16) float v_s[kMaxPs][D];
  __shared__ int kabs_s[kMaxPs];      // the staged page's slot positions
  const int tile = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int tt = threadIdx.x / G, g = threadIdx.x % G;
  const int t0 = tile * qt;
  const int t = t0 + tt;
  const bool active = tt < qt && t < T;
  const int st = start[b];
  const int nl = min(n_live[b], T);
  const size_t q_off =
      (((size_t)b * T + (active ? t : 0)) * H + kh * G + g) * D;
  __nv_bfloat16* o = out + q_off;
  if (t0 >= nl) {                        // the whole tile is chunk padding
    if (active)
      for (int d = 0; d < D; ++d) o[d] = __float2bfloat16(0.f);
    return;
  }
  const bool live = active && t < nl;
  const int q_abs = st + t;
  const int q_lo = st + t0;                            // tile's first row
  const int q_hi = st + min(min(t0 + qt, T), nl) - 1;  // last live row
  const int ring = n_ring * ps;
  const int last = st - 1;
  // Key pages in the order of their absolute positions, oldest first: the
  // ring's absolute pages a_lo..a_hi (page a at ring slot a % n_ring; none
  // at start == 0), then the fresh pages.  Iterating by absolute page, not
  // by ring slot, makes the sums independent of the ring's length: a ring
  // of n_ring + 1 pages holding the same window adds only its oldest page,
  // which no row sees.
  const int a_hi = last >= 0 ? last / ps : -1;
  const int a_lo = max(0, a_hi - n_ring + 1);
  const int n_ring_kp = a_hi - a_lo + 1;               // 0 at start == 0
  const int n_kp = n_ring_kp + (nl + ps - 1) / ps;     // ring + fresh pages
  auto kp_of = [&](int it) {                           // sweep step -> page
    return it < n_ring_kp ? (a_lo + it) % n_ring : n_ring + it - n_ring_kp;
  };
  const int32_t* tb = tables + (size_t)b * n_ring;

  __nv_bfloat162 qr[D / 2];
  {
    const auto* src = reinterpret_cast<const __nv_bfloat162*>(q + q_off);
#pragma unroll
    for (int d = 0; d < D / 2; ++d)
      qr[d] = live ? src[d] : __floats2bfloat162_rn(0.f, 0.f);
  }

  // Slot positions of key page kp, then whether any row of the tile sees
  // one (uniform across the block: every thread reads the same kabs_s).
  auto positions = [&](int it) -> bool {
    const int kp = kp_of(it);
    __syncthreads();                     // earlier readers of the tiles
    for (int j = threadIdx.x; j < ps; j += blockDim.x) {
      int ka = -1;
      if (kp < n_ring) {
        if (last >= 0) {
          int back = (last % ring - (kp * ps + j)) % ring;
          if (back < 0) back += ring;
          ka = last - back;
        }
      } else {
        const int f = (kp - n_ring) * ps + j;
        if (f < nl) ka = st + f;
      }
      kabs_s[j] = ka;
    }
    __syncthreads();
    bool needed = false;
    for (int j = 0; j < ps; ++j) {
      const int ka = kabs_s[j];
      needed |= ka >= 0 && ka <= q_hi && ka > q_lo - window;
    }
    return needed;
  };
  auto sees = [&](int j) {
    const int ka = kabs_s[j];
    return ka >= 0 && ka <= q_abs && ka > q_abs - window;
  };

  // pass 1: the row's max over every key it sees
  float m = -INFINITY;
  for (int it = 0; it < n_kp; ++it) {
    if (!positions(it)) continue;
    const int kp = kp_of(it);
    stage_page<D, kInt8>(k_s, k_pages, k_scale, k_new, tb, b, kp, n_ring, kh,
                         ps, K, T, nl);
    __syncthreads();
    for (int j = 0; j < ps; ++j)
      if (sees(j)) m = fmaxf(m, score<D>(qr, k_s[j], scale));
  }
  // pass 2: the normalizer at the true max
  float l = 0.f;
  for (int it = 0; it < n_kp; ++it) {
    if (!positions(it)) continue;
    const int kp = kp_of(it);
    stage_page<D, kInt8>(k_s, k_pages, k_scale, k_new, tb, b, kp, n_ring, kh,
                         ps, K, T, nl);
    __syncthreads();
    for (int j = 0; j < ps; ++j)
      if (sees(j)) l += expf(score<D>(qr, k_s[j], scale) - m);
  }
  // pass 3: probabilities (bf16-rounded with bf16 pages) times V, in fp32
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int it = 0; it < n_kp; ++it) {
    if (!positions(it)) continue;
    const int kp = kp_of(it);
    stage_page<D, kInt8>(k_s, k_pages, k_scale, k_new, tb, b, kp, n_ring, kh,
                         ps, K, T, nl);
    stage_page<D, kInt8>(v_s, v_pages, v_scale, v_new, tb, b, kp, n_ring, kh,
                         ps, K, T, nl);
    __syncthreads();
    for (int j = 0; j < ps; ++j) {
      if (!sees(j)) continue;
      float p = expf(score<D>(qr, k_s[j], scale) - m) / l;
      if (!kInt8) p = __bfloat162float(__float2bfloat16(p));
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 v = reinterpret_cast<const float4*>(v_s[j])[d4];
        acc[4 * d4] = fmaf(p, v.x, acc[4 * d4]);
        acc[4 * d4 + 1] = fmaf(p, v.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, v.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, v.w, acc[4 * d4 + 3]);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      o[d] = __float2bfloat16(live ? acc[d] : 0.f);
  }
}

}  // namespace

// q/out [B, T, H, D] bf16; k_new/v_new [B, T, K, D] bf16 (the chunk's
// fresh roped K/V); k_pages/v_pages [P, ps, K, D] bf16, or int8 with
// k_scale/v_scale [P, ps, K] bf16 (both null for bf16 pages), the
// pre-write pool; tables [B, n_ring], start [B] and n_live [B] int32;
// window > 0.  Returns 0 on success, else the cudaError_t of the refused
// or failed launch.
extern "C" int windowed_ragged_prefill(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* tables, const void* start, const void* n_live, void* out,
    int B, int T, int H, int K, int D, int ps, int n_ring, int window,
    float scale, void* stream) {
  if (B < 1 || T < 1 || K < 1 || H % K != 0 || H / K > kThreads || ps < 1 ||
      ps > kMaxPs || n_ring < 1 || window < 1 ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  const int qt = kThreads / G;                   // query tokens per block
  const dim3 grid((T + qt - 1) / qt, K, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* knp = static_cast<const __nv_bfloat16*>(k_new);
  const auto* vnp = static_cast<const __nv_bfloat16*>(v_new);
  const auto* ksp = static_cast<const __nv_bfloat16*>(k_scale);
  const auto* vsp = static_cast<const __nv_bfloat16*>(v_scale);
  const auto* tp = static_cast<const int32_t*>(tables);
  const auto* sp = static_cast<const int32_t*>(start);
  const auto* np = static_cast<const int32_t*>(n_live);
  auto* op = static_cast<__nv_bfloat16*>(out);
#define WINDOWED_LAUNCH(DIM, INT8)                                            \
  windowed_prefill_kernel<DIM, INT8><<<grid, kThreads, 0, st>>>(              \
      qp, knp, vnp, k_pages, v_pages, ksp, vsp, tp, sp, np, op, T, H, K, ps,  \
      n_ring, window, qt, scale)
  const bool int8 = k_scale != nullptr;
  if (D == 32 && !int8) WINDOWED_LAUNCH(32, false);
  else if (D == 32) WINDOWED_LAUNCH(32, true);
  else if (D == 64 && !int8) WINDOWED_LAUNCH(64, false);
  else if (D == 64) WINDOWED_LAUNCH(64, true);
  else if (D == 128 && !int8) WINDOWED_LAUNCH(128, false);
  else if (D == 128) WINDOWED_LAUNCH(128, true);
  else return (int)cudaErrorInvalidValue;
#undef WINDOWED_LAUNCH
  return (int)cudaGetLastError();
}
