// Kernel K5: absorbed-latent MLA paged decode for Hopper (sm_90a).  One query
// token per request, every head of it attending the request's latent pages
// through the page table: scores q_eff . ckv + q_rope . krope (times the
// scale), an online softmax over the pages, and the context accumulated in
// latent space (acc += p * ckv), cast to bf16 once at the end.  The caller
// up-projects the context with w_uv.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/kernel.py::
// mla_paged_decode_fwd (_mla_paged_decode_kernel), bf16 latent pages (the
// int8 latent mode is not ported: ROADMAP queue 1 item 12b).  Contract:
// repro/kernels/README.md "Inputs (decode cores)" and "Page-table layout":
// page 0 is the null page, which may be read but is masked like any slot;
// slot idx is seen iff idx <= pos[b] (kernel.py:_page_mask, window 0).
//
// What bounds it: all H heads share one latent "KV head", so one call reads
// every live token's latent once, (pos + 1) * (L + R) * 2 bytes per request
// (1152 bytes a token at deepseek-v2's L = 512, R = 64), and does 2 * H *
// (2 L + R) flops a token on it: about 240 flops a byte at H = 128, near
// the ~295 flops a byte at which the H100's bf16 tensor cores, not its
// memory, become the limit (989 TFLOP/s over 3.35 TB/s, NVIDIA's data
// sheet).  This first version runs the dot products on the fp32 CUDA cores,
// so its arithmetic bounds it (PERF.md has its time against its bound).
//
// Design.  The TPU grid (B, n_pages) carries an [H, L] fp32 accumulator in
// VMEM from page to page: 256 KB per request at H = 128, more than the 227
// KB of shared memory a Hopper block can hold.  So the heads are split over
// blocks: grid (B, H / 8), one warp per head -- a query row -- and each
// block loops over the request's live pages itself, staging every page
// (ckv ++ krope as fp32, one copy for the block's 8 rows) in shared memory.
// Every block of a request stages the same pages, since every head reads
// the same latent.  A warp owns its row's whole online-softmax state (m, l
// in every lane, the L / 32 context dims lane + 32 j in registers) and
// updates it page by page in ascending page order exactly as
// _online_softmax_update (kernel.py:53) does: -inf masking, the isfinite
// guards, the alpha rescale, l = l * alpha + sum(p), acc = acc * alpha +
// p @ ckv.  A page's 16 scores are 32 lanes' work: lane (t, half) sums one
// half of the 576 products of token t in ascending order, and the two
// halves add lower half first.  The page's p sum runs over t in order.
// Pages past pos are never read.  One row a warp keeps the kernel ready for
// the small-q verify twin (kernel K7, ROADMAP item 12b): its rows are (query
// token j, head) pairs at position pos + j, and a row's instruction sequence
// does not depend on how many rows a block holds, so at one live query it
// can reproduce this kernel bit for bit, as K3 does K1.
//
// Numerics: IEEE expf and division (build without --use_fast_math); fp32
// scores, scaled after the dot as in the reference; against the plain
// single-softmax version the online softmax rounds at other points, so
// outputs agree to an output ulp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;                 // heads per block, one warp each
constexpr int kThreads = kRows * 32;
constexpr int kMaxPs = 16;               // tokens per page

// Shared memory of one block.  A row of E = L + R values is stored in two
// halves of E / 2, the second shifted by 16 words, in rows of an odd
// length: the 32 lanes of a score step (16 tokens x 2 halves) then hit 32
// different banks.
template <int L, int R>
struct Smem {
  static constexpr int kE = L + R;
  static constexpr int kHalf = kE / 2;
  static constexpr int kLd = kE + 17;
  float kv[kMaxPs][kLd];        // the staged page: ckv ++ krope
  float q[kRows][kLd];          // the block's rows: q_eff ++ q_rope
  float p[kRows][kMaxPs];       // the page's probabilities, per row
  __device__ static __forceinline__ int at(int d) {
    return d < kHalf ? d : d + 16;
  }
};

// Eight bf16 values from a 16-byte vector into shared fp32 slots at(d0 + k)
// of ``row`` (d0 is a multiple of 8, so a vector never straddles the
// halves).
template <class S>
__device__ __forceinline__ void put8(float* row, int d0, uint4 raw) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float* dst = row + S::at(d0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    dst[2 * k] = f.x;
    dst[2 * k + 1] = f.y;
  }
}

template <int L, int R>
__global__ void __launch_bounds__(kThreads)
mla_decode_kernel(const __nv_bfloat16* __restrict__ q_eff,   // [B, H, L]
                  const __nv_bfloat16* __restrict__ q_rope,  // [B, H, R]
                  const __nv_bfloat16* __restrict__ ckv,     // [P, ps, L]
                  const __nv_bfloat16* __restrict__ krope,   // [P, ps, R]
                  const int32_t* __restrict__ tables,        // [B, n_pages]
                  const int32_t* __restrict__ pos,           // [B]
                  __nv_bfloat16* __restrict__ out,           // [B, H, L]
                  int H, int ps, int n_pages, float scale) {
  using S = Smem<L, R>;
  constexpr int kE = S::kE, kHalf = S::kHalf;
  constexpr int kDpl = L / 32;            // context dims owned by each lane
  constexpr int kLv = L / 8, kRv = R / 8; // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int b = blockIdx.x, h0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int e = threadIdx.x; e < kRows * (kLv + kRv); e += kThreads) {
    const int r = e / (kLv + kRv), c = e % (kLv + kRv);
    const size_t row = (size_t)b * H + h0 + r;
    const uint4 raw = c < kLv
        ? reinterpret_cast<const uint4*>(q_eff + row * L)[c]
        : reinterpret_cast<const uint4*>(q_rope + row * R)[c - kLv];
    put8<S>(sm.q[r], 8 * c, raw);
  }
  const int p_b = pos[b];
  int n_live = p_b < 0 ? 0 : p_b / ps + 1;      // pages with i * ps <= pos
  if (n_live > n_pages) n_live = n_pages;

  float m = -INFINITY, l = 0.f;                  // the warp's row state
  float acc[kDpl];
#pragma unroll
  for (int j = 0; j < kDpl; ++j) acc[j] = 0.f;
  const int t = lane % kMaxPs, half = lane / kMaxPs;

  for (int i = 0; i < n_live; ++i) {
    const int page = tables[(size_t)b * n_pages + i];
    __syncthreads();                             // readers of the last page
    for (int e = threadIdx.x; e < ps * (kLv + kRv); e += kThreads) {
      const int tt = e / (kLv + kRv), c = e % (kLv + kRv);
      const size_t slot = (size_t)page * ps + tt;
      const uint4 raw = c < kLv
          ? reinterpret_cast<const uint4*>(ckv + slot * L)[c]
          : reinterpret_cast<const uint4*>(krope + slot * R)[c - kLv];
      put8<S>(sm.kv[tt], 8 * c, raw);
    }
    __syncthreads();

    // the row's score of token t: two half dots, lower half first
    float part = 0.f;
    if (t < ps) {
      const float* qr = &sm.q[warp][half * (kHalf + 16)];
      const float* kr = &sm.kv[t][half * (kHalf + 16)];
#pragma unroll 8
      for (int x = 0; x < kHalf; ++x) part = fmaf(qr[x], kr[x], part);
    }
    const float other = __shfl_xor_sync(0xffffffffu, part, kMaxPs);
    float s = (half == 0 ? part + other : other + part) * scale;
    if (!(t < ps && i * ps + t <= p_b)) s = -INFINITY;

    // online-softmax update, the same in every lane of the warp
    float mx = s;
#pragma unroll
    for (int o = kMaxPs / 2; o >= 1; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const bool fin = isfinite(m_new);
    const float safe = fin ? m_new : 0.f;
    if (half == 0 && t < ps) sm.p[warp][t] = fin ? expf(s - safe) : 0.f;
    __syncwarp();
    float sum = 0.f;
    for (int x = 0; x < ps; ++x) sum += sm.p[warp][x];
    const float alpha = isfinite(m) ? expf(m - safe) : 0.f;
    l = fmaf(l, alpha, sum);
    m = m_new;
#pragma unroll
    for (int j = 0; j < kDpl; ++j) {
      const int d = S::at(lane + 32 * j);
      float pv = 0.f;
      for (int x = 0; x < ps; ++x) pv = fmaf(sm.p[warp][x], sm.kv[x][d], pv);
      acc[j] = fmaf(acc[j], alpha, pv);
    }
  }

  __nv_bfloat16* o = out + ((size_t)b * H + h0 + warp) * L;
  const float denom = fmaxf(l, 1e-20f);
#pragma unroll
  for (int j = 0; j < kDpl; ++j)
    o[lane + 32 * j] = __float2bfloat16(acc[j] / denom);
}

template <int L, int R>
int launch(dim3 grid, cudaStream_t st, const __nv_bfloat16* q_eff,
           const __nv_bfloat16* q_rope, const __nv_bfloat16* ckv,
           const __nv_bfloat16* krope, const int32_t* tables,
           const int32_t* pos, __nv_bfloat16* out, int H, int ps,
           int n_pages, float scale) {
  constexpr size_t kSmem = sizeof(Smem<L, R>);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_kernel<L, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  mla_decode_kernel<L, R><<<grid, kThreads, kSmem, st>>>(
      q_eff, q_rope, ckv, krope, tables, pos, out, H, ps, n_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_eff/out [B, H, L] and q_rope [B, H, R] bf16; ckv [P, ps, L] and krope
// [P, ps, R] bf16 latent pages; tables [B, n_pages] and pos [B] int32.
// L = 512, R = 64 (deepseek-v2), H a multiple of 8, ps <= 16.  Returns 0 on
// success, else the cudaError_t of the refused or failed launch.
extern "C" int mla_paged_decode(const void* q_eff, const void* q_rope,
                                const void* ckv, const void* krope,
                                const void* tables, const void* pos,
                                void* out, int B, int H, int L, int R,
                                int ps, int n_pages, float scale,
                                void* stream) {
  if (B < 1 || H < kRows || H % kRows != 0 || ps < 1 || ps > kMaxPs ||
      n_pages < 1 || L != 512 || R != 64)
    return (int)cudaErrorInvalidValue;
  return launch<512, 64>(
      dim3(B, H / kRows), static_cast<cudaStream_t>(stream),
      static_cast<const __nv_bfloat16*>(q_eff),
      static_cast<const __nv_bfloat16*>(q_rope),
      static_cast<const __nv_bfloat16*>(ckv),
      static_cast<const __nv_bfloat16*>(krope),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(pos),
      static_cast<__nv_bfloat16*>(out), H, ps, n_pages, scale);
}
