// Kernel K6: MLA ragged chunk prefill for Hopper (sm_90a).  A batch of
// prompt chunks, row b holding T queries at absolute positions start[b] + t,
// every head attending the row's *post-write* latent pages (radix-cache
// prefix, earlier chunks and the chunk itself) through the page table with
// the causal rule k_abs <= q_abs.  Each head's keys and values are rebuilt
// from the latent inside the kernel, page by page:
//   k = bf16(ckv @ w_uk) ++ krope,   v = bf16(ckv @ w_uv),
// rounded to bf16 where the reference's ``ckv @ wkv_b`` einsum rounds
// (repro/kernels/ragged_prefill/kernel.py:399-401, 427-429), so the [B, S,
// H, 256] K/V tensors the plain version builds in memory never exist.
//
// Replaces the Pallas TPU kernel repro/kernels/ragged_prefill/kernel.py::
// mla_ragged_prefill_fwd (_mla_ragged_prefill_kernel), bf16 latent pages
// (the int8 latent mode is not ported: ROADMAP queue 1 item 12b).
// Contract: repro/kernels/README.md "The ragged-prefill contract"
// (post-write pool).  Every query row is computed, padding rows of a chunk
// too (the model routes them through the MoE like any token); rows past T
// are not.
//
// What bounds it: the operations.  Per (request, head) the keys' K/V are
// materialized once per q-tile, 2 * keys * L * (nope + v) flops, and the
// attend does 2 * T * keys * (nope + R + v) flops, against a few MB of
// latent pages, queries and w_uk/w_uv: far above the ~295 flops a byte at
// which the H100's bf16 tensor cores, not its memory, become the limit
// (989 TFLOP/s over 3.35 TB/s, NVIDIA's data sheet).
//
// Design: K2's (csrc/ragged_prefill.cu), one block per (q-tile of 128
// tokens, head, request), with the K/V materialization added.  The head's
// w_uk [L, nope] (128 KB in bf16) stays in shared memory for the whole
// block; w_uv is too large to keep beside it and is read from global
// memory (L2) per page.  Per page the block stages the page's latent as
// bf16 and runs the two products on the tensor cores (wmma 16x16x16 bf16
// tiles, fp32 sums; a page is one 16-row tile, the 8 warps take 16 output
// dims each), then rounds them to bf16 into fp32 K and V rows.  A thread
// pair owns each query row: one half of the row's 192 query dims (bf16
// pairs in registers, exact) and one half of its 128 output dims (fp32
// accumulator in registers); a score is the two half dots added lower half
// first.  Instead of banking scores the block sweeps the row's live pages
// three times, recomputing K and every fp32 score with the same
// instruction sequence each time:
//   pass 1: the row's true max m over all keys;
//   pass 2: l = sum(exp(s - m));
//   pass 3: p = exp(s - m) / l, rounded to bf16 (the reference's
//           a.astype(v.dtype)); acc += p * v in fp32.
// This is the single softmax at the row's true max of K2, the rounding
// points of the reference (kernel.py:30-36).  Masked keys take the finite
// -1e30 of the reference: they add exp(-1e30 - m) = 0 to l and nothing to
// acc, so pages past the tile's last query are skipped outright.  One bf16
// cast at the output.
//
// Numerics: the materialized K/V come from tensor-core products, whose fp32
// sums round in another order than the plain version's einsum; a product
// that lands next to a bf16 rounding boundary can round the other way (one
// bf16 ulp of that K/V element).  IEEE expf and division (build without
// --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kRows = 128;               // query tokens per block
constexpr int kThreads = 2 * kRows;      // a thread pair per query row
constexpr int kWarps = kThreads / 32;
constexpr int kPs = 16;                  // tokens per page: one wmma tile
constexpr float kMaskValue = -1e30f;

// Shared memory of one block.  K and V rows store their two halves (the
// halves the thread pair splits) 16 words apart, so the pair's two
// addresses fall in different banks.
template <int L, int NOPE, int R, int VD>
struct Smem {
  static constexpr int kE = NOPE + R;             // query / key width
  static constexpr int kLdW = NOPE + 8;
  static constexpr int kLdC = L + 8;
  __align__(32) __nv_bfloat16 w_uk[L][kLdW];      // the head's w_uk
  __align__(32) __nv_bfloat16 c[kPs][kLdC];       // the page's latent
  __align__(32) float mat[kPs][NOPE > VD ? NOPE : VD];  // product tile
  float k[kPs][kE + 16];                          // K rows (fp32)
  float v[kPs][VD + 16];                          // V rows (fp32)
  __device__ static __forceinline__ int kat(int d) {
    return d < kE / 2 ? d : d + 16;
  }
  __device__ static __forceinline__ int vat(int d) {
    return d < VD / 2 ? d : d + 16;
  }
};

// mat[0:16, 0:N] = c[0:16, 0:L] @ w[0:L, 0:N] on the tensor cores: warp w
// computes the 16 columns 16 w .. 16 w + 15 (N = 16 * kWarps).
template <int L, class S>
__device__ __forceinline__ void latent_product(S& sm,
                                               const __nv_bfloat16* w,
                                               int ldw, int warp) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      bm;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
  for (int k0 = 0; k0 < L; k0 += 16) {
    wmma::load_matrix_sync(a, &sm.c[0][k0], S::kLdC);
    wmma::load_matrix_sync(bm, w + (size_t)k0 * ldw + 16 * warp, ldw);
    wmma::mma_sync(acc, a, bm, acc);
  }
  constexpr int kLdM = sizeof(sm.mat[0]) / sizeof(float);
  wmma::store_matrix_sync(&sm.mat[0][16 * warp], acc, kLdM,
                          wmma::mem_row_major);
}

template <int L, int NOPE, int R, int VD>
__global__ void __launch_bounds__(kThreads, 1)
mla_prefill_kernel(const __nv_bfloat16* __restrict__ q,      // [B, H, Tp, E]
                   const __nv_bfloat16* __restrict__ ckv,    // [P, ps, L]
                   const __nv_bfloat16* __restrict__ krope,  // [P, ps, R]
                   const __nv_bfloat16* __restrict__ wkv_b,  // [L, H, NOPE+VD]
                   const int32_t* __restrict__ tables,       // [B, n_pages]
                   const int32_t* __restrict__ start,        // [B]
                   __nv_bfloat16* __restrict__ out,          // [B, H, Tp, VD]
                   int H, int Tp, int n_pages, float scale) {
  using S = Smem<L, NOPE, R, VD>;
  constexpr int kE = S::kE, kQh = kE / 2, kVh = VD / 2;
  static_assert(NOPE == 16 * kWarps && VD == 16 * kWarps,
                "one 16-column tile of K and of V per warp");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int row = threadIdx.x / 2, half = threadIdx.x % 2;
  const int t = tile * kRows + row;
  const bool active = t < Tp;
  const int st = start[b];
  const int q_abs = st + t;
  const int t_last = min(tile * kRows + kRows, Tp) - 1;
  int n_live = (st + t_last) / kPs + 1;          // pages with i*ps <= last q
  if (n_live > n_pages) n_live = n_pages;
  const int32_t* tb = tables + (size_t)b * n_pages;
  const size_t ldb = (size_t)H * (NOPE + VD);     // wkv_b's row stride
  const __nv_bfloat16* w_uv = wkv_b + (size_t)h * (NOPE + VD) + NOPE;

  // the head's w_uk into shared memory, once
  for (int e = threadIdx.x; e < L * (NOPE / 8); e += kThreads) {
    const int l = e / (NOPE / 8), c = e % (NOPE / 8);
    reinterpret_cast<uint4*>(&sm.w_uk[l][0])[c] = reinterpret_cast<
        const uint4*>(wkv_b + (size_t)l * ldb + (size_t)h * (NOPE + VD))[c];
  }
  // the row's half of its query, as bf16 pairs
  __nv_bfloat162 qr[kQh / 2];
  {
    const auto* src = reinterpret_cast<const __nv_bfloat162*>(
        q + (((size_t)b * H + h) * Tp + (active ? t : 0)) * kE + half * kQh);
#pragma unroll
    for (int d = 0; d < kQh / 2; ++d)
      qr[d] = active ? src[d] : __floats2bfloat162_rn(0.f, 0.f);
  }

  // Stage page i and rebuild its K rows (and with ``with_v`` its V rows).
  auto build = [&](int i, bool with_v) {
    const int page = tb[i];
    __syncthreads();                     // earlier readers of the tiles
    for (int e = threadIdx.x; e < kPs * (L / 8); e += kThreads) {
      const int tt = e / (L / 8), c = e % (L / 8);
      reinterpret_cast<uint4*>(&sm.c[tt][0])[c] = reinterpret_cast<
          const uint4*>(ckv + ((size_t)page * kPs + tt) * L)[c];
    }
    for (int e = threadIdx.x; e < kPs * R; e += kThreads) {
      const int tt = e / R, r = e % R;
      sm.k[tt][S::kat(NOPE + r)] = __bfloat162float(
          krope[((size_t)page * kPs + tt) * R + r]);
    }
    __syncthreads();
    latent_product<L>(sm, &sm.w_uk[0][0], S::kLdW, warp);
    __syncthreads();
    for (int e = threadIdx.x; e < kPs * NOPE; e += kThreads) {
      const int tt = e / NOPE, d = e % NOPE;
      sm.k[tt][S::kat(d)] = __bfloat162float(__float2bfloat16(sm.mat[tt][d]));
    }
    if (with_v) {
      __syncthreads();
      latent_product<L>(sm, w_uv, (int)ldb, warp);
      __syncthreads();
      for (int e = threadIdx.x; e < kPs * VD; e += kThreads) {
        const int tt = e / VD, d = e % VD;
        sm.v[tt][S::vat(d)] =
            __bfloat162float(__float2bfloat16(sm.mat[tt][d]));
      }
    }
    __syncthreads();
  };
  // The row's score against key j of the staged page: the two half dots,
  // lower half first, scaled after the dot.
  auto score = [&](int j) {
    const float* kr = &sm.k[j][half * (kQh + 16)];
    float part = 0.f;
#pragma unroll
    for (int d = 0; d < kQh / 2; ++d) {
      const float2 qf = __bfloat1622float2(qr[d]);
      part = fmaf(qf.x, kr[2 * d], part);
      part = fmaf(qf.y, kr[2 * d + 1], part);
    }
    const float other = __shfl_xor_sync(0xffffffffu, part, 1);
    return (half == 0 ? part + other : other + part) * scale;
  };

  // pass 1: row max over every key (masked keys hold -1e30)
  float m = kMaskValue;
  for (int i = 0; i < n_live; ++i) {
    build(i, false);
    for (int j = 0; j < kPs; ++j) {
      const float s = score(j);
      if (i * kPs + j <= q_abs) m = fmaxf(m, s);
    }
  }
  // pass 2: the normalizer at the true max
  float l = 0.f;
  for (int i = 0; i < n_live; ++i) {
    build(i, false);
    for (int j = 0; j < kPs; ++j) {
      const float s = score(j);
      if (i * kPs + j <= q_abs) l += expf(s - m);
    }
  }
  // pass 3: bf16-rounded probabilities times V, accumulated in fp32
  float acc[kVh];
#pragma unroll
  for (int d = 0; d < kVh; ++d) acc[d] = 0.f;
  for (int i = 0; i < n_live; ++i) {
    build(i, true);
    for (int j = 0; j < kPs; ++j) {
      const float s = score(j);
      if (i * kPs + j > q_abs) continue;
      const float p = __bfloat162float(__float2bfloat16(expf(s - m) / l));
      const float* vr = &sm.v[j][half * (kVh + 16)];
#pragma unroll
      for (int d = 0; d < kVh; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
    }
  }
  if (active) {
    __nv_bfloat16* o =
        out + (((size_t)b * H + h) * Tp + t) * VD + half * kVh;
#pragma unroll
    for (int d = 0; d < kVh; ++d) o[d] = __float2bfloat16(acc[d]);
  }
}

}  // namespace

// q [B, H, Tp, nope + R] bf16 (rope part roped; head-major, the token axis
// padded to Tp); ckv [P, 16, L] and krope [P, 16, R] bf16 post-write latent
// pages; wkv_b [L, H, nope + vd] bf16; tables [B, n_pages] and start [B]
// int32; out [B, H, Tp, vd] bf16.  L = 512, nope = 128, R = 64, vd = 128
// (deepseek-v2) and 16-token pages.  Returns 0 on success, else the
// cudaError_t of the refused or failed launch.
extern "C" int mla_ragged_prefill(const void* q, const void* ckv,
                                  const void* krope, const void* wkv_b,
                                  const void* tables, const void* start,
                                  void* out, int B, int H, int Tp, int L,
                                  int nope, int R, int vd, int ps,
                                  int n_pages, float scale, void* stream) {
  if (B < 1 || H < 1 || Tp < 1 || n_pages < 1 || L != 512 || nope != 128 ||
      R != 64 || vd != 128 || ps != kPs)
    return (int)cudaErrorInvalidValue;
  using S = Smem<512, 128, 64, 128>;
  auto* kernel = mla_prefill_kernel<512, 128, 64, 128>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(S));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((Tp + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, sizeof(S), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(ckv),
      static_cast<const __nv_bfloat16*>(krope),
      static_cast<const __nv_bfloat16*>(wkv_b),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(start), static_cast<__nv_bfloat16*>(out),
      H, Tp, n_pages, scale);
  return (int)cudaGetLastError();
}
