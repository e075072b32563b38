// Kernel K6: MLA ragged chunk prefill for Hopper (sm_90a).  A batch of
// prompt chunks, row b holding T queries at absolute positions start[b] + t,
// every head attending the row's *post-write* latent pages (radix-cache
// prefix, earlier chunks and the chunk itself) through the page table with
// the causal rule k_abs <= q_abs.  Each head's keys and values are rebuilt
// from the latent inside the kernel, page by page:
//   bf16 pages:  k = bf16(ckv @ w_uk) ++ krope,   v = bf16(ckv @ w_uv),
// rounded to bf16 where the reference's ``ckv @ wkv_b`` einsum rounds
// (repro/kernels/ragged_prefill/kernel.py:399-401, 427-429), from fp64
// sums of the products rounded once to fp32;
//   int8 pages:  k = s * (q8 @ w_uk) ++ sr * qr8,   v = s * (q8 @ w_uv),
// kept in fp32 as the reference keeps the dequantized latent's products
// (kv_dtype = f32 there), with q8 / qr8 the int8 latent and rope key of a
// token slot and s / sr their bf16 scales; so the [B, S, H, 256] K/V
// tensors the plain version builds in memory never exist.
//
// Replaces the Pallas TPU kernel repro/kernels/ragged_prefill/kernel.py::
// mla_ragged_prefill_fwd (_mla_ragged_prefill_kernel), bf16 or int8 latent
// pages.  Contract: repro/kernels/README.md "The ragged-prefill contract"
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
// bf16 and runs the two products on the fp64 tensor cores (mma m8n8k4
// f64; a page is 16 rows, the 8 warps take 16 output dims each): a
// product of two bf16 values is exact in fp64, and a sum of 512 of them
// rounds, if at all, some 29 bits below fp32's last bit, so each K/V
// element is rounded once to fp32, then to bf16 into fp32 K and V rows --
// the values the plain version's fp64 einsum gives, but for a sum within
// that distance of an fp32 rounding boundary.  (With fp32 sums, as the bf16
// tensor cores take them, two orders of summation round a K/V element
// next to a bf16 boundary to different sides; a flipped K element moves a
// score, which flips a probability's bf16 rounding, and on the rows of a
// chunk's first tokens, with few keys, that moved outputs by more than an
// ulp of the row.)  int8 pages take the bf16 tensor cores instead (wmma
// 16x16x16 tiles, fp32 sums): an int8 value is exact in bf16 and the
// scale is one per token slot (one row of the page), so the page's int8
// latent is staged as bf16, multiplied by w_uk / w_uv on the same wmma
// tiles with fp32 sums, and each product row is scaled by its slot's fp32
// scale afterwards and kept in fp32.  Each product of an int8 value and a
// bf16 weight is exact in fp32, as is the reference's f32(q) * f32(s) *
// w, so the two differ only in the order of fp32 sums and the one rounding
// of the scale product, far below an output ulp.  A thread
// pair owns each query row: one half of the row's 192 query dims (bf16
// pairs in registers, exact) and one half of its 128 output dims (fp32
// accumulator in registers); a score is the two half dots added lower half
// first.  Instead of banking scores the block sweeps the row's live pages
// three times, recomputing K and every fp32 score with the same
// instruction sequence each time:
//   pass 1: the row's true max m over all keys;
//   pass 2: l = sum(exp(s - m));
//   pass 3: p = exp(s - m) / l, rounded to bf16 (the reference's
//           a.astype(v.dtype); kept fp32 for int8 pages, whose v is
//           fp32); acc += p * v in fp32.
// This is the single softmax at the row's true max of K2, the rounding
// points of the reference (kernel.py:30-36).  Masked keys take the finite
// -1e30 of the reference: they add exp(-1e30 - m) = 0 to l and nothing to
// acc, so pages past the tile's last query are skipped outright.  One bf16
// cast at the output.
//
// Numerics: with bf16 pages the materialized K/V equal the plain
// version's; with int8 pages they differ from it in the order of fp32
// sums, and no K/V element or probability is rounded to bf16.  Scores and
// the PV sums are fp32 in another order than the plain version's.  IEEE
// expf and division (build without --use_fast_math).

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
  float cs[kPs];                                  // int8: the page's ckv
                                                  // scales
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

// mat[0:16, 16 w : 16 w + 16) = c[0:16, 0:L] @ w[0:L, 16 w : 16 w + 16) for
// warp w, fp64 sums rounded once to fp32: fp64 tensor-core products (mma
// m8n8k4 f64, two 8-row by two 8-column tiles a warp) of the bf16 operands
// widened to fp64: every product is exact, and the sums are fp64.
template <int L, class S>
__device__ __forceinline__ void latent_product_exact(S& sm,
                                                     const __nv_bfloat16* w,
                                                     int ldw, int warp) {
  const int lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
  const int c0 = 16 * warp;
  double acc[2][2][2] = {};                     // [row tile][col tile][2]
#pragma unroll 4
  for (int k0 = 0; k0 < L; k0 += 4) {
    const int k = k0 + tg;                      // A: row g, col tg
    const double a0 = __bfloat162float(sm.c[g][k]);
    const double a1 = __bfloat162float(sm.c[g + 8][k]);
    const __nv_bfloat16* wk = w + (size_t)k * ldw + c0;  // B: row tg, col g
    const double b0 = __bfloat162float(wk[g]);
    const double b1 = __bfloat162float(wk[g + 8]);
#define MLA_DMMA(A, B, C)                                                   \
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "        \
                 "{%0, %1}, {%2}, {%3}, {%0, %1};"                         \
                 : "+d"(C[0]), "+d"(C[1]) : "d"(A), "d"(B))
    MLA_DMMA(a0, b0, acc[0][0]);
    MLA_DMMA(a0, b1, acc[0][1]);
    MLA_DMMA(a1, b0, acc[1][0]);
    MLA_DMMA(a1, b1, acc[1][1]);
#undef MLA_DMMA
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)                   // C: row g, cols 2 tg, +1
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sm.mat[8 * i + g][c0 + 8 * j + 2 * tg + e] = (float)acc[i][j][e];
}

template <int L, int NOPE, int R, int VD, bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
mla_prefill_kernel(const __nv_bfloat16* __restrict__ q,      // [B, H, Tp, E]
                   const void* __restrict__ ckv_v,           // [P, ps, L]
                   const void* __restrict__ krope_v,         // [P, ps, R]
                   const __nv_bfloat16* __restrict__ ckv_scale,    // [P, ps]
                   const __nv_bfloat16* __restrict__ krope_scale,  // [P, ps]
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
    if constexpr (kInt8) {
      // the int8 latent as bf16 (exact), 8 values a thread; the rope key
      // dequantized f32(q) * f32(s); the ckv scales for the products
      const auto* ckv = static_cast<const int8_t*>(ckv_v);
      const auto* krope = static_cast<const int8_t*>(krope_v);
      for (int e = threadIdx.x; e < kPs * (L / 8); e += kThreads) {
        const int tt = e / (L / 8), c = e % (L / 8);
        const uint2 raw = reinterpret_cast<const uint2*>(
            ckv + ((size_t)page * kPs + tt) * L)[c];
        const auto* v8 = reinterpret_cast<const int8_t*>(&raw);
        __nv_bfloat162 h[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          h[k] = __floats2bfloat162_rn((float)v8[2 * k],
                                       (float)v8[2 * k + 1]);
        reinterpret_cast<uint4*>(&sm.c[tt][0])[c] =
            *reinterpret_cast<const uint4*>(h);
      }
      for (int e = threadIdx.x; e < kPs * R; e += kThreads) {
        const int tt = e / R, r = e % R;
        const size_t slot = (size_t)page * kPs + tt;
        sm.k[tt][S::kat(NOPE + r)] = (float)krope[slot * R + r]
            * __bfloat162float(krope_scale[slot]);
      }
      if (threadIdx.x < kPs)
        sm.cs[threadIdx.x] = __bfloat162float(
            ckv_scale[(size_t)page * kPs + threadIdx.x]);
    } else {
      const auto* ckv = static_cast<const __nv_bfloat16*>(ckv_v);
      const auto* krope = static_cast<const __nv_bfloat16*>(krope_v);
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
    }
    __syncthreads();
    // a product row as K/V holds it: bf16-rounded, or (int8) times its
    // slot's scale in fp32
    auto product = [&](int tt, int d) {
      if constexpr (kInt8) return sm.mat[tt][d] * sm.cs[tt];
      else return __bfloat162float(__float2bfloat16(sm.mat[tt][d]));
    };
    // the products: bf16 tensor cores for int8 pages (scaled after), the
    // exact fp64 ones for bf16 pages (rounded to bf16 after)
    auto latent = [&](const __nv_bfloat16* w, int ldw) {
      if constexpr (kInt8) latent_product<L>(sm, w, ldw, warp);
      else latent_product_exact<L>(sm, w, ldw, warp);
    };
    latent(&sm.w_uk[0][0], S::kLdW);
    __syncthreads();
    for (int e = threadIdx.x; e < kPs * NOPE; e += kThreads) {
      const int tt = e / NOPE, d = e % NOPE;
      sm.k[tt][S::kat(d)] = product(tt, d);
    }
    if (with_v) {
      __syncthreads();
      latent(w_uv, (int)ldb);
      __syncthreads();
      for (int e = threadIdx.x; e < kPs * VD; e += kThreads) {
        const int tt = e / VD, d = e % VD;
        sm.v[tt][S::vat(d)] = product(tt, d);
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
  // pass 3: bf16-rounded (int8: fp32) probabilities times V, accumulated
  // in fp32
  float acc[kVh];
#pragma unroll
  for (int d = 0; d < kVh; ++d) acc[d] = 0.f;
  for (int i = 0; i < n_live; ++i) {
    build(i, true);
    for (int j = 0; j < kPs; ++j) {
      const float s = score(j);
      if (i * kPs + j > q_abs) continue;
      float p = expf(s - m) / l;
      if constexpr (!kInt8) p = __bfloat162float(__float2bfloat16(p));
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

template <bool kInt8>
int launch(dim3 grid, cudaStream_t st, const void* q, const void* ckv,
           const void* krope, const void* ckv_scale, const void* krope_scale,
           const void* wkv_b, const void* tables, const void* start,
           void* out, int H, int Tp, int n_pages, float scale) {
  using S = Smem<512, 128, 64, 128>;
  auto* kernel = mla_prefill_kernel<512, 128, 64, 128, kInt8>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(S));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  kernel<<<grid, kThreads, sizeof(S), st>>>(
      static_cast<const __nv_bfloat16*>(q), ckv, krope,
      static_cast<const __nv_bfloat16*>(ckv_scale),
      static_cast<const __nv_bfloat16*>(krope_scale),
      static_cast<const __nv_bfloat16*>(wkv_b),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(start), static_cast<__nv_bfloat16*>(out),
      H, Tp, n_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, Tp, nope + R] bf16 (rope part roped; head-major, the token axis
// padded to Tp); ckv [P, 16, L] and krope [P, 16, R] post-write latent
// pages, bf16 (scales null) or int8 (ckv_scale and krope_scale [P, 16]
// bf16); wkv_b [L, H, nope + vd] bf16; tables [B, n_pages] and start [B]
// int32; out [B, H, Tp, vd] bf16.  L = 512, nope = 128, R = 64, vd = 128
// (deepseek-v2) and 16-token pages.  Returns 0 on success, else the
// cudaError_t of the refused or failed launch.
extern "C" int mla_ragged_prefill(const void* q, const void* ckv,
                                  const void* krope, const void* ckv_scale,
                                  const void* krope_scale, const void* wkv_b,
                                  const void* tables, const void* start,
                                  void* out, int B, int H, int Tp, int L,
                                  int nope, int R, int vd, int ps,
                                  int n_pages, float scale, void* stream) {
  if (B < 1 || H < 1 || Tp < 1 || n_pages < 1 || L != 512 || nope != 128 ||
      R != 64 || vd != 128 || ps != kPs ||
      (ckv_scale == nullptr) != (krope_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Tp + kRows - 1) / kRows, H, B);
  const auto st = static_cast<cudaStream_t>(stream);
  if (ckv_scale != nullptr)
    return launch<true>(grid, st, q, ckv, krope, ckv_scale, krope_scale,
                        wkv_b, tables, start, out, H, Tp, n_pages, scale);
  return launch<false>(grid, st, q, ckv, krope, ckv_scale, krope_scale,
                       wkv_b, tables, start, out, H, Tp, n_pages, scale);
}
