// Paged-attention decode for Hopper (sm_90a): one query token per request,
// GQA, read straight out of the paged KV pool through the page table.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/kernel.py::
// paged_decode_fwd (_paged_decode_kernel), vanilla mode (window = 0, no
// softcap, bf16 pages).  Contract: repro/kernels/README.md "Inputs (decode
// cores)" and "Page-table layout" -- page 0 is the null page, which may be
// read but is always masked (token index > pos).
//
// What bounds it: the bytes of K/V pages read.  One step reads every live
// token's K and V of every KV head once, (pos + 1) * K * D * 2 * 2 bytes per
// request, and does 4 * (pos + 1) * H * D flops on them -- about 1 flop per
// byte, far below the ~295 flops/byte at which the H100's bf16 tensor
// cores, not its memory, become the limit (989 TFLOP/s over 3.35 TB/s,
// NVIDIA's data sheet).
//
// Design.  The TPU grid (B, K, n_pages) carries (m, l, acc) in VMEM from one
// grid step to the next; Hopper blocks run in no order, so one block owns a
// (request, KV head) pair and loops over the request's live pages itself,
// reading tables[b, i] and pos[b] on its own.  The G = H / K query rows of
// the GQA group are shared by the block, so every K/V byte is read once for
// all G heads.  The block's four warps split the pages round-robin, each
// with its own fp32 online-softmax state updated exactly as
// _online_softmax_update (kernel.py:53): -inf masking, the isfinite guards,
// the alpha rescale.  The four states merge at the end, and the output is
// cast to bf16 once, after acc / max(l, 1e-20) (kernel.py:70).  Pages past
// pos are never read.  At B = 8 and K = 2 that is 16 blocks on 132 SMs: the
// page sweep is not split across blocks yet, so the kernel is latency-bound
// at long contexts (see PERF.md).
//
// Numerics: IEEE expf and division (build without --use_fast_math); scores
// are fp32 dot products of the bf16 operands, scaled after the dot as in the
// reference.  Against the plain single-softmax version the online softmax
// rounds at other points, so outputs agree to an output ulp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 16;    // query heads per KV head
constexpr int kMaxPs = 16;   // tokens per page

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,        // [B, K, G, D]
                    const __nv_bfloat16* __restrict__ k_pages,  // [P, ps, K, D]
                    const __nv_bfloat16* __restrict__ v_pages,  // [P, ps, K, D]
                    const int32_t* __restrict__ tables,         // [B, n_pages]
                    const int32_t* __restrict__ pos,            // [B]
                    __nv_bfloat16* __restrict__ out,            // [B, K, G, D]
                    int K, int G, int ps, int n_pages, float scale) {
  constexpr int kDpl = D / 32;          // output dims owned by each lane
  constexpr int kVec = D / 8;           // 16-byte vectors per token row
  constexpr int kRow = D + 8;           // padded smem row (keeps 16B alignment)
  __shared__ float q_s[kMaxG][D];
  __shared__ __align__(16) __nv_bfloat16 k_s[kWarps][kMaxPs][kRow];
  __shared__ __align__(16) __nv_bfloat16 v_s[kWarps][kMaxPs][kRow];
  __shared__ float p_s[kWarps][kMaxG][kMaxPs];
  __shared__ float alpha_s[kWarps][kMaxG];
  __shared__ float m_w[kWarps][kMaxG];
  __shared__ float l_w[kWarps][kMaxG];
  __shared__ float acc_w[kWarps][kMaxG][D];

  const int b = blockIdx.x, kh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const __nv_bfloat16* qb = q + (size_t)(b * K + kh) * G * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x)
    q_s[e / D][e % D] = __bfloat162float(qb[e]);
  const int p_b = pos[b];
  int n_live = p_b < 0 ? 0 : p_b / ps + 1;       // pages with i * ps <= pos
  if (n_live > n_pages) n_live = n_pages;
  __syncthreads();

  float m_r = -INFINITY, l_r = 0.f;              // row `lane` (lanes < G)
  float acc[kMaxG][kDpl];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < kDpl; ++j) acc[g][j] = 0.f;

  for (int i = warp; i < n_live; i += kWarps) {
    const int page = tables[(size_t)b * n_pages + i];
    const size_t base = ((size_t)page * ps * K + kh) * D;
    for (int e = lane; e < ps * kVec; e += 32) {
      const int t = e / kVec, c = e % kVec;
      const size_t off = base + (size_t)t * K * D;
      reinterpret_cast<uint4*>(&k_s[warp][t][0])[c] =
          reinterpret_cast<const uint4*>(k_pages + off)[c];
      reinterpret_cast<uint4*>(&v_s[warp][t][0])[c] =
          reinterpret_cast<const uint4*>(v_pages + off)[c];
    }
    __syncwarp();
    for (int e = lane; e < G * ps; e += 32) {
      const int g = e / ps, t = e % ps;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d)
        s = fmaf(q_s[g][d], __bfloat162float(k_s[warp][t][d]), s);
      s *= scale;
      p_s[warp][g][t] = (i * ps + t <= p_b) ? s : -INFINITY;
    }
    __syncwarp();
    if (lane < G) {                              // online-softmax update
      float mx = -INFINITY;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, p_s[warp][lane][t]);
      const float m_new = fmaxf(m_r, mx);
      const bool fin = isfinite(m_new);
      const float safe = fin ? m_new : 0.f;
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = fin ? expf(p_s[warp][lane][t] - safe) : 0.f;
        p_s[warp][lane][t] = p;
        sum += p;
      }
      const float alpha = isfinite(m_r) ? expf(m_r - safe) : 0.f;
      l_r = l_r * alpha + sum;
      alpha_s[warp][lane] = alpha;
      m_r = m_new;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float a = alpha_s[warp][g];
#pragma unroll
        for (int j = 0; j < kDpl; ++j) {
          const int d = lane + 32 * j;
          float pv = 0.f;
          for (int t = 0; t < ps; ++t)
            pv = fmaf(p_s[warp][g][t], __bfloat162float(v_s[warp][t][d]), pv);
          acc[g][j] = acc[g][j] * a + pv;
        }
      }
    }
    __syncwarp();
  }

  // merge the warps' (m, l, acc) states; one bf16 cast at the end
  if (lane < G) {
    m_w[warp][lane] = m_r;
    l_w[warp][lane] = l_r;
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G) {
#pragma unroll
      for (int j = 0; j < kDpl; ++j) acc_w[warp][g][lane + 32 * j] = acc[g][j];
    }
  __syncthreads();
  __nv_bfloat16* ob = out + (size_t)(b * K + kh) * G * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_w[w][g]);
    const float safe = isfinite(m) ? m : 0.f;
    float l = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = isfinite(m_w[w][g]) ? expf(m_w[w][g] - safe) : 0.f;
      l += l_w[w][g] * f;
      a += acc_w[w][g][d] * f;
    }
    ob[e] = __float2bfloat16(a / fmaxf(l, 1e-20f));
  }
}

}  // namespace

// Returns 0 on success, else the cudaError_t of the refused or failed launch.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* tables,
                            const void* pos, void* out, int B, int K, int G,
                            int D, int ps, int n_pages, float scale,
                            void* stream) {
  if (G < 1 || G > kMaxG || ps < 1 || ps > kMaxPs || B < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, K);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* tp = static_cast<const int32_t*>(tables);
  const auto* pp = static_cast<const int32_t*>(pos);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (D) {
    case 32:
      paged_decode_kernel<32><<<grid, block, 0, st>>>(qp, kp, vp, tp, pp, op,
                                                      K, G, ps, n_pages, scale);
      break;
    case 64:
      paged_decode_kernel<64><<<grid, block, 0, st>>>(qp, kp, vp, tp, pp, op,
                                                      K, G, ps, n_pages, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
