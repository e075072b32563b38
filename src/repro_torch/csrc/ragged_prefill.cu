// Ragged paged prefill for Hopper (sm_90a): a batch of prompt chunks, row b
// holding T queries at absolute positions start[b] + t, each attending the
// row's *post-write* pages (radix-cache prefix, earlier chunks and the
// chunk itself) through the page table with the causal rule k_abs <= q_abs.
//
// Replaces the Pallas TPU kernel repro/kernels/ragged_prefill/kernel.py::
// ragged_prefill_fwd (_ragged_prefill_kernel), bf16 mode.  Contract:
// repro/kernels/README.md "The ragged-prefill contract".
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
// and fp32 accumulator in registers.  Instead of banking the scores, the
// block sweeps the row's live pages three times, recomputing every fp32
// score with the same instruction sequence each time:
//   pass 1: the row's true max m over all keys;
//   pass 2: l = sum(exp(s - m));
//   pass 3: p = exp(s - m) / l, rounded to bf16 and back (the reference's
//           a.astype(v.dtype)), acc += p * v in fp32.
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

template <int D>
__device__ __forceinline__ float score(const float (&qr)[D],
                                       const float* __restrict__ k_row,
                                       float scale) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(qr[d], k_row[d], s);
  return s * scale;
}

template <int D>
__device__ __forceinline__ void load_page(float (*dst)[D],
                                          const __nv_bfloat16* __restrict__ src,
                                          int ps, int row_stride) {
  for (int e = threadIdx.x; e < ps * D; e += blockDim.x) {
    const int t = e / D, d = e % D;
    dst[t][d] = __bfloat162float(src[(size_t)t * row_stride + d]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
ragged_prefill_kernel(const __nv_bfloat16* __restrict__ q,        // [B, T, H, D]
                      const __nv_bfloat16* __restrict__ k_pages,  // [P, ps, K, D]
                      const __nv_bfloat16* __restrict__ v_pages,  // [P, ps, K, D]
                      const int32_t* __restrict__ tables,         // [B, n_pages]
                      const int32_t* __restrict__ start,          // [B]
                      __nv_bfloat16* __restrict__ out,            // [B, T, H, D]
                      int T, int H, int K, int ps, int n_pages, int qt,
                      float scale) {
  __shared__ float kv_s[kMaxPs][D];   // K page (passes 1-3)
  __shared__ float v_s[kMaxPs][D];    // V page (pass 3)
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
  const int row_stride = K * D;                  // token stride inside a page
  const int32_t* tb = tables + (size_t)b * n_pages;

  float qr[D];
  const size_t q_off = (((size_t)b * T + (active ? t : 0)) * H + kh * G + g) * D;
#pragma unroll
  for (int d = 0; d < D; ++d)
    qr[d] = active ? __bfloat162float(q[q_off + d]) : 0.f;

  // pass 1: row max over every key (masked keys hold -1e30)
  float m = kMaskValue;
  for (int i = 0; i < n_live; ++i) {
    __syncthreads();
    load_page<D>(kv_s, k_pages + ((size_t)tb[i] * ps * K + kh) * D, ps,
                 row_stride);
    __syncthreads();
    for (int j = 0; j < ps; ++j)
      if (i * ps + j <= q_abs) m = fmaxf(m, score<D>(qr, kv_s[j], scale));
  }
  // pass 2: the normalizer at the true max
  float l = 0.f;
  for (int i = 0; i < n_live; ++i) {
    __syncthreads();
    load_page<D>(kv_s, k_pages + ((size_t)tb[i] * ps * K + kh) * D, ps,
                 row_stride);
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
    const size_t page = ((size_t)tb[i] * ps * K + kh) * D;
    load_page<D>(kv_s, k_pages + page, ps, row_stride);
    load_page<D>(v_s, v_pages + page, ps, row_stride);
    __syncthreads();
    for (int j = 0; j < ps; ++j) {
      float p = 0.f;
      if (i * ps + j <= q_abs) {
        p = expf(score<D>(qr, kv_s[j], scale) - m) / l;
        p = __bfloat162float(__float2bfloat16(p));
      }
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_s[j][d], acc[d]);
    }
  }
  if (active) {
    __nv_bfloat16* o = out + q_off;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = __float2bfloat16(acc[d]);
  }
}

}  // namespace

// Returns 0 on success, else the cudaError_t of the refused or failed launch.
extern "C" int ragged_prefill(const void* q, const void* k_pages,
                              const void* v_pages, const void* tables,
                              const void* start, void* out, int B, int T,
                              int H, int K, int D, int ps, int n_pages,
                              float scale, void* stream) {
  if (B < 1 || T < 1 || K < 1 || H % K != 0 || H / K > kThreads || ps < 1 ||
      ps > kMaxPs || n_pages < 1)
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  const int qt = kThreads / G;                   // query tokens per block
  const dim3 grid((T + qt - 1) / qt, K, B);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* tp = static_cast<const int32_t*>(tables);
  const auto* sp = static_cast<const int32_t*>(start);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (D) {
    case 32:
      ragged_prefill_kernel<32><<<grid, block, 0, st>>>(
          qp, kp, vp, tp, sp, op, T, H, K, ps, n_pages, qt, scale);
      break;
    case 64:
      ragged_prefill_kernel<64><<<grid, block, 0, st>>>(
          qp, kp, vp, tp, sp, op, T, H, K, ps, n_pages, qt, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
