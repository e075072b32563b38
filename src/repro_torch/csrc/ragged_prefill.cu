// Ragged paged prefill for Hopper (sm_90a): a batch of prompt chunks, row b
// holding T queries at absolute positions start[b] + t, each attending the
// row's *post-write* pages (radix-cache prefix, earlier chunks and the
// chunk itself) through the page table with the causal rule k_abs <= q_abs.
//
// Replaces the Pallas TPU kernel repro/kernels/ragged_prefill/kernel.py::
// ragged_prefill_fwd (_ragged_prefill_kernel), bf16 pages or int8 pages with
// bf16 per-token-per-head scales.  Contract: repro/kernels/README.md "The
// ragged-prefill contract" and "Scale-operand layout".
//
// What bounds it: the TPU body banks a [q_blk * G, n_pages * ps] fp32 score
// matrix in VMEM (kernel.py:189) -- 128 * 7 * 2048 * 4 bytes = 7.3 MB at
// q_blk 128, G 7 and 2048 keys, far above the 227 KB of shared memory a
// Hopper block can hold (NVIDIA's data sheet).  Here the
// work is 4 * T * keys * H * D flops against (keys * K * D * 2 + 2 * T * H
// * D) * 2 bytes: compute-bound for chunks of a few hundred tokens, and
// this first version runs the dot products on the fp32 CUDA cores, not the
// tensor cores (see PERF.md for its time against its bound).
//
// Design.  One block per (q-tile, KV head, request), one thread per query
// row of the tile (a row is a (token, query head) pair of the GQA group, so
// each K/V page is read once per block for all G heads), the row's query
// (as bf16 pairs, exact: q is bf16) and fp32 accumulator in registers.
// Head dims 32, 64 and 128: at 128 the query pairs and the accumulator take
// 192 registers a thread, the treatment K4 (windowed_ragged_prefill.cu)
// gives the same row at D = 128; ptxas's registers and spills per
// instantiation are kept beside the built library and printed by
// chip_smoke.py.  Instead of banking the scores, the
// block sweeps the row's live pages three times, recomputing every fp32
// score with the same instruction sequence each time:
//   pass 1: the row's true max m over all keys;
//   pass 2: l = sum(exp(s - m));
//   pass 3: p = exp(s - m) / l, rounded to bf16 and back (the reference's
//           a.astype(v.dtype)), acc += p * v in fp32.  With int8 pages the
//           values are dequantized to fp32, so p stays fp32 (the Pallas
//           body's v_dtype=float32, kernel.py:156-161).
// int8 pages are dequantized to f32(q) * f32(s) as each page is staged in
// shared memory, before the dot and before PV, as the Pallas body and the
// plain gather do.
// This is the single softmax at the row's true max that keeps the kernel
// exact against the reference (kernel.py:30-36) -- it must not become an
// online softmax.  Masked keys take the finite -1e30 of the reference
// (kernel.py:52): they add exp(-1e30 - m) = 0 to l and nothing to acc, so
// pages past the tile's last query are skipped outright.  Queries past
// n_live (chunk padding) are computed like any other and discarded by the
// caller; queries past T are not computed.  One bf16 cast at the output.
//
// Numerics: IEEE expf and division (build without --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // query rows per block
constexpr int kMaxPs = 32;      // tokens per page
constexpr float kMaskValue = -1e30f;

// fp32 dot product of a bf16 query row (kept as bf16 pairs: exact, and half
// the registers of an fp32 copy, which D = 128 needs beside its fp32
// accumulator) with an fp32 key row, in ascending d, scaled after the dot
// as the reference does.  The same instruction sequence as K4's score.
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

// Stage token rows of one page for one KV head in shared memory as fp32:
// bf16 values as they are, int8 values as f32(q) * f32(s) with the token's
// scale.  ``page`` is the physical page id, ``kh`` the KV head.
template <int D, bool kInt8>
__device__ __forceinline__ void load_page(float (*dst)[D],
                                          const void* __restrict__ pages,
                                          const __nv_bfloat16* __restrict__ scales,
                                          int page, int kh, int ps, int K) {
  const size_t base = ((size_t)page * ps * K + kh) * D;
  for (int e = threadIdx.x; e < ps * D; e += blockDim.x) {
    const int t = e / D, d = e % D;
    const size_t at = base + (size_t)t * K * D + d;
    if constexpr (kInt8) {
      const float s = __bfloat162float(scales[((size_t)page * ps + t) * K + kh]);
      dst[t][d] = __fmul_rn((float)static_cast<const int8_t*>(pages)[at], s);
    } else {
      dst[t][d] = __bfloat162float(static_cast<const __nv_bfloat16*>(pages)[at]);
    }
  }
}

template <int D, bool kInt8>
__global__ void __launch_bounds__(kThreads)
ragged_prefill_kernel(const __nv_bfloat16* __restrict__ q,        // [B, T, H, D]
                      const void* __restrict__ k_pages,           // [P, ps, K, D]
                      const void* __restrict__ v_pages,           // [P, ps, K, D]
                      const __nv_bfloat16* __restrict__ k_scale,  // [P, ps, K]
                      const __nv_bfloat16* __restrict__ v_scale,  // [P, ps, K]
                      const int32_t* __restrict__ tables,         // [B, n_pages]
                      const int32_t* __restrict__ start,          // [B]
                      __nv_bfloat16* __restrict__ out,            // [B, T, H, D]
                      int T, int H, int K, int ps, int n_pages, int qt,
                      float scale) {
  __shared__ __align__(16) float kv_s[kMaxPs][D];   // K page (passes 1-3)
  __shared__ __align__(16) float v_s[kMaxPs][D];    // V page (pass 3)
  const int tile = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int r = threadIdx.x;
  const int tt = r / G, g = r % G;
  const int t = tile * qt + tt;
  const bool active = tt < qt && t < T;
  const int st = start[b];
  const int q_abs = st + t;
  const int t_last = min(tile * qt + qt, T) - 1;
  int n_live = (st + t_last) / ps + 1;           // pages with i*ps <= last q
  if (n_live > n_pages) n_live = n_pages;
  const int32_t* tb = tables + (size_t)b * n_pages;

  __nv_bfloat162 qr[D / 2];
  const size_t q_off = (((size_t)b * T + (active ? t : 0)) * H + kh * G + g) * D;
  {
    const auto* src = reinterpret_cast<const __nv_bfloat162*>(q + q_off);
#pragma unroll
    for (int d = 0; d < D / 2; ++d)
      qr[d] = active ? src[d] : __floats2bfloat162_rn(0.f, 0.f);
  }

  // pass 1: row max over every key (masked keys hold -1e30)
  float m = kMaskValue;
  for (int i = 0; i < n_live; ++i) {
    __syncthreads();
    load_page<D, kInt8>(kv_s, k_pages, k_scale, tb[i], kh, ps, K);
    __syncthreads();
    for (int j = 0; j < ps; ++j)
      if (i * ps + j <= q_abs) m = fmaxf(m, score<D>(qr, kv_s[j], scale));
  }
  // pass 2: the normalizer at the true max
  float l = 0.f;
  for (int i = 0; i < n_live; ++i) {
    __syncthreads();
    load_page<D, kInt8>(kv_s, k_pages, k_scale, tb[i], kh, ps, K);
    __syncthreads();
    for (int j = 0; j < ps; ++j)
      if (i * ps + j <= q_abs) l += expf(score<D>(qr, kv_s[j], scale) - m);
  }
  // pass 3: bf16-rounded probabilities times V, accumulated in fp32
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int i = 0; i < n_live; ++i) {
    __syncthreads();
    load_page<D, kInt8>(kv_s, k_pages, k_scale, tb[i], kh, ps, K);
    load_page<D, kInt8>(v_s, v_pages, v_scale, tb[i], kh, ps, K);
    __syncthreads();
    for (int j = 0; j < ps; ++j) {
      float p = 0.f;
      if (i * ps + j <= q_abs) {
        p = expf(score<D>(qr, kv_s[j], scale) - m) / l;
        if (!kInt8) p = __bfloat162float(__float2bfloat16(p));
      }
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
    __nv_bfloat16* o = out + q_off;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = __float2bfloat16(acc[d]);
  }
}

}  // namespace

// q/out [B, T, H, D] bf16; k_pages/v_pages [P, ps, K, D] bf16, or int8
// with k_scale/v_scale [P, ps, K] bf16 (both null for bf16 pages); tables
// [B, n_pages] and start [B] int32.  Returns 0 on success, else the
// cudaError_t of the refused or failed launch.
extern "C" int ragged_prefill(const void* q, const void* k_pages,
                              const void* v_pages, const void* k_scale,
                              const void* v_scale, const void* tables,
                              const void* start, void* out, int B, int T,
                              int H, int K, int D, int ps, int n_pages,
                              float scale, void* stream) {
  if (B < 1 || T < 1 || K < 1 || H % K != 0 || H / K > kThreads || ps < 1 ||
      ps > kMaxPs || n_pages < 1 ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  const int qt = kThreads / G;                   // query tokens per block
  const dim3 grid((T + qt - 1) / qt, K, B);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* ksp = static_cast<const __nv_bfloat16*>(k_scale);
  const auto* vsp = static_cast<const __nv_bfloat16*>(v_scale);
  const auto* tp = static_cast<const int32_t*>(tables);
  const auto* sp = static_cast<const int32_t*>(start);
  auto* op = static_cast<__nv_bfloat16*>(out);
#define PREFILL_LAUNCH(DIM, INT8)                                           \
  ragged_prefill_kernel<DIM, INT8><<<grid, block, 0, st>>>(                 \
      qp, k_pages, v_pages, ksp, vsp, tp, sp, op, T, H, K, ps, n_pages, qt, \
      scale)
  const bool int8 = k_scale != nullptr;
  if (D == 32 && !int8) PREFILL_LAUNCH(32, false);
  else if (D == 32) PREFILL_LAUNCH(32, true);
  else if (D == 64 && !int8) PREFILL_LAUNCH(64, false);
  else if (D == 64) PREFILL_LAUNCH(64, true);
  else if (D == 128 && !int8) PREFILL_LAUNCH(128, false);
  else if (D == 128) PREFILL_LAUNCH(128, true);
  else return (int)cudaErrorInvalidValue;
#undef PREFILL_LAUNCH
  return (int)cudaGetLastError();
}
