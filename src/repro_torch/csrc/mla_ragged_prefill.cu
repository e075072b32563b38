// Kernel K6: MLA ragged chunk prefill for Hopper (sm_90a).  A batch of
// prompt chunks, row b holding T queries at absolute positions start[b] + t,
// every head attending the row's *post-write* latent pages (radix-cache
// prefix, earlier chunks and the chunk itself) through the page table with
// the causal rule k_abs <= q_abs, each head's keys and values materialized
// from the latent with wkv_b:
//   bf16 pages:  k = bf16(ckv @ w_uk) ++ krope,   v = bf16(ckv @ w_uv),
// rounded to bf16 where the reference's ``ckv @ wkv_b`` einsum rounds, from
// fp64 sums of the exact products rounded once to fp32;
//   int8 pages:  k = s * (q8 @ w_uk) ++ sr * qr8,   v = s * (q8 @ w_uv),
// kept in fp32 as the reference keeps the dequantized latent's products,
// with q8 / qr8 the int8 latent and rope key of a token slot and s / sr
// their bf16 scales.
//
// Replaces the Pallas TPU kernel repro/kernels/ragged_prefill/kernel.py::
// mla_ragged_prefill_fwd (_mla_ragged_prefill_kernel), bf16 or int8 latent
// pages.  Contract: repro/kernels/README.md "The ragged-prefill contract"
// (post-write pool).  Every query row is computed, padding rows of a chunk
// too (the model routes them through the MoE like any token); rows past T
// are not.
//
// Two kernels behind one wrapper (kernels/ragged_prefill/ops.py::
// mla_ragged_prefill), launched one after the other on the stream:
//   stage A (mla_build_kv.cu): every key's K (nope part) and V of every
//     head, built once a call into a workspace ws [B, H, S, W] that the
//     wrapper allocates: bf16, or int8's fp32 values as hi / lo bf16 planes
//     (its note has the design);
//   stage B (this file): the causal attend over the workspace, the rope key
//     read from the latent pages (all heads share it).
// The TPU kernel rebuilt a page's K and V inside the attend; here the
// attend's two sweeps would rebuild K twice, 1.5x the fp64 products (>= 6.9
// ms at the smoke's shape), so K/V go through device memory once instead
// (~0.6 GB written and read at that shape, 1.2 GB in int8 mode).
//
// What bounds it: operations, with two bounds for the two contracts.  The
// work is 2 * keys * L * H * (nope + vd) flops to build K/V (309 GFLOP at
// the smoke's 8 chunks of 256 over 9216 keys, 128 heads) and 2 * pairs * H
// * (nope + R + vd) for the causal (query, key) pairs (172 GFLOP) against a
// few hundred MB of latent, queries and weights.  On the bf16 tensor cores
// (989 TFLOP/s, NVIDIA's data sheet) that is 0.49 ms; but bf16 pages' K/V
// must be fp64 sums (a bf16 K/V element next to a rounding boundary goes
// the other way under fp32 sums, which moved rows by more than an ulp), so
// stage A runs on the fp64 tensor cores, 67 TFLOP/s: 4.6 ms, plus the
// attend's 0.17.  int8 pages' K/V are fp32 sums of exact products, which
// the bf16 tensor cores give: their bound is the 0.49 ms.
//
// Stage B is K2's design (csrc/ragged_prefill.cu; its helpers in
// ragged_prefill.cuh), a row a token: a warpgroup owns 64 query rows of a
// (head, request).  With bf16 pages a block is one warpgroup, two blocks
// an SM.  int8 pages' hi and lo planes fill the shared memory of one block
// an SM, so there a block holds two warpgroups (128 query rows) that read
// every staged K/V tile, which also halves the tiles' traffic from the
// workspace (the smoke's shape reads ~4 GB of bf16 tiles from L2 at 64
// rows a block, twice that in int8).  Keys go in 64-key tiles anchored at
// key 0, staged by 16-byte cp.async copies two stages deep into 128-byte-
// swizzled bf16 halves: K as three 64-column halves (nope from the
// workspace, rope from the pages through the table), V as two; QK^T
// `wgmma.m64n64k16` over the 192 query dims with Q and K from shared
// memory, PV with p from registers and V MN-major.  Tiles past the block's
// last query are not staged, and a warpgroup skips those past its own last
// query (fully masked for its rows, they would add exactly 0); only tiles
// that reach past its first query, or past the table, are masked (-1e30).
//   sweep 1: each tile's scores, each row's max m and normalizer l (only l
//            rescaled online when m grows; a fully masked tile adds 0);
//   sweep 2: the scores again (the same bits), p = exp(s - m) / l at the
//            true max, rounded to bf16 (the reference's a.astype(v.dtype)),
//            and PV on the tensor cores.  One bf16 cast at the output.
// int8 pages: K and V are fp32 held as hi + lo bf16 planes, so QK^T is q .
// k_hi + q . k_lo (all 192 dims of k_hi first); the rope key f32(qr8) *
// f32(sr) has at most 15 significant bits and splits exactly into hi + lo.
// p stays fp32 and is split as K2 splits it, p_hi = bf16(p), p_lo = bf16(p
// - p_hi); PV = p_hi . v_hi + p_hi . v_lo + p_lo . v_hi, in that order, each
// product exact into the fp32 accumulator: the dropped p_lo . v_lo and the
// terms' 16 bits are ~2^-16 of sum |p v|, far below an output ulp.
//
// A row's result depends only on its own q, its keys and its position: K/V
// of a key are built in the same 64-key tile at the same place whatever
// the chunk (stage A's tiles are anchored at key 0 too), and a row's sums
// run over its own key tiles in key order (each thread's 16 columns in
// order, then a fixed shuffle tree over the row's 4 threads).  So a row is
// the same, bit for bit, however the prompt was cut into chunks and
// whatever else is in the batch.
//
// Numerics: IEEE expf and division (build without --use_fast_math).

#include "ragged_prefill.cuh"

namespace {

constexpr int kPs = 16;          // tokens per page
constexpr int kE = 192;          // query / key width: nope + R
constexpr int kR = 64;           // rope width
constexpr int kVd = 128;         // value width (= nope)

// Shared-memory layout of one instantiation, in bytes from a 1024-aligned
// base: Q (a tile of three halves a warpgroup), then two stages, each
// holding the K tile (three halves) and the V tile (two) of every plane --
// one for bf16 pages, hi and lo for int8 --; int8 adds two raw rope
// stages [64][64], two stages of scale words (the aligned 32-bit word
// holding a slot's bf16 rope scale) and which half of the word it is, and
// 64 ones (p's V scale in K2's split).
template <bool kInt8>
struct MLayout {
  static constexpr int kWG = kInt8 ? 2 : 1;        // warpgroups a block
  static constexpr int kBRows = kWG * kRows;       // query rows a block
  static constexpr int kBThreads = kWG * kThreads;
  static constexpr int kPlanes = kInt8 ? 2 : 1;
  static constexpr int kKTile = 3 * kHalf;
  static constexpr int kVTile = 2 * kHalf;
  static constexpr int kStage = kPlanes * (kKTile + kVTile);
  static constexpr int kQ = 0;                     // + warpgroup * kKTile
  static constexpr int kStages = kWG * kKTile;     // + stage * kStage
  static constexpr int kRaw = kStages + 2 * kStage;        // + stage * 4096
  static constexpr int kWords = kRaw + 2 * kSlots * kR;    // [2][64] u32
  static constexpr int kSel = kWords + 2 * kSlots * 4;     // [2][64] u8
  static constexpr int kOnes = kSel + 2 * kSlots;          // [64] f32
  static constexpr int kBytes = kInt8 ? kOnes + kSlots * 4 : kRaw;
  __device__ static constexpr int k(int plane) { return plane * kKTile; }
  __device__ static constexpr int v(int plane) {
    return kPlanes * kKTile + plane * kVTile;
  }
};

// S = Q K_hi^T + Q K_lo^T: the 12 k-steps of the hi tile, then the lo
// tile's, into one fp32 accumulator.
__device__ __forceinline__ void qk_split(float (&s)[32], uint32_t q,
                                         uint32_t k_hi, uint32_t k_lo) {
  wg_fence();
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int kk = 0; kk < kE / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kHalf + (kk & 3) * 32;
      wgmma_ss(s, desc(q + off, 16, 1024),
               desc((p ? k_lo : k_hi) + off, 16, 1024), p + kk > 0);
    }
  wg_commit_wait();
  pin(s);
}

template <bool kInt8>
__global__ void __launch_bounds__(MLayout<kInt8>::kBThreads)
mla_prefill_kernel(const __nv_bfloat16* __restrict__ q,    // [B, T, H, 192]
                   const __nv_bfloat16* __restrict__ ws,   // [B, H, S, W]
                   const void* __restrict__ krope_v,       // [P, ps, R]
                   const __nv_bfloat16* __restrict__ krope_scale,  // [P, ps]
                   const int32_t* __restrict__ tables,     // [B, n_pages]
                   const int32_t* __restrict__ start,      // [B]
                   __nv_bfloat16* __restrict__ out,        // [B, T, H, 128]
                   int T, int H, int n_pages, int S, float scale) {
  using L = MLayout<kInt8>;
  constexpr int kW = 256 * L::kPlanes;        // workspace row, bf16 values
  constexpr int kBRows = L::kBRows, kBThreads = L::kBThreads;
  static_assert(!kInt8 || kBThreads == kSlots * 4,
                "int8: a raw rope chunk a thread");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);

  // a request's later query tiles attend more keys: start them first
  const int tile = gridDim.x - 1 - blockIdx.x, h = blockIdx.y,
            b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / kThreads, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int st = start[b];
  const int32_t* tb = tables + (size_t)b * n_pages;
  const int n_keys = n_pages * kPs;
  const int n = min((st + min((tile + 1) * kBRows, T) - 1) / kSlots + 1,
                    (n_keys + kSlots - 1) / kSlots);
  // this warpgroup's 64 rows: its first row, its last row before T (none
  // if it starts at or past T) and the tiles it computes
  const int t0 = tile * kBRows + wg * kRows;
  const int q_first = st + t0;
  const int n_mine = t0 < T
      ? min((st + min(t0 + kRows, T) - 1) / kSlots + 1, n) : 0;
  const __nv_bfloat16* wsb = ws + (size_t)(b * H + h) * S * kW;
  const uint32_t q_tile = base + L::kQ + wg * L::kKTile;

  // this thread's two accumulator rows' positions
  int q_abs[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    q_abs[e] = q_first + 16 * warp + (lane >> 2) + 8 * e;

  float* ones = reinterpret_cast<float*>(sm + L::kOnes);
  if (kInt8 && tid < kSlots) ones[tid] = 1.f;

  // the block's 128 query rows (zeros past T) into the two swizzled Q tiles
  for (int e = tid; e < kBRows * (kE / 8); e += kBThreads) {
    const int r = e / (kE / 8), c = e % (kE / 8), t = tile * kBRows + r;
    const bool ok = t < T;
    cp_async16(base + L::kQ + (r / kRows) * L::kKTile + swz(r % kRows, c),
               q + (((size_t)b * T + (ok ? t : 0)) * H + h) * kE + c * 8,
               ok ? 16 : 0);
  }

  // steps 0 .. n-1 are sweep 1 (K only), n .. 2n-1 sweep 2 (K and V)
  auto issue = [&](int step) {
    const int i = step < n ? step : step - n, stage = step & 1;
    const bool with_v = step >= n;
    const uint32_t sb = base + L::kStages + stage * L::kStage;
    // K's nope columns and V from the workspace: 16 chunks a row a plane
#pragma unroll
    for (int it = 0; it < kSlots * 16 / kBThreads; ++it) {
      const int e = tid + it * kBThreads, r = e / 16, c = e % 16;
      const __nv_bfloat16* src = wsb + (size_t)(i * kSlots + r) * kW + c * 8;
#pragma unroll
      for (int p = 0; p < L::kPlanes; ++p) {
        cp_async16(sb + L::k(p) + swz(r, c), src + 256 * p, 16);
        if (with_v)
          cp_async16(sb + L::v(p) + swz(r, c), src + 256 * p + 128, 16);
      }
    }
    // the rope key from the pages (zeros past the table): bf16 into K's
    // third half; int8 raw, with its scale word
    if constexpr (kInt8) {
      const auto* kr = static_cast<const int8_t*>(krope_v);
      const int r = tid / 4, c = tid % 4;      // 256 chunks: one a thread
      const int pi = (i * kSlots + r) / kPs;
      const bool ok = pi < n_pages;
      cp_async16(base + L::kRaw + stage * kSlots * kR + r * kR + c * 16,
                 kr + ((size_t)(ok ? __ldg(tb + pi) : 0) * kPs + r % kPs)
                     * kR + c * 16,
                 ok ? 16 : 0);
      if (tid < kSlots) {
        const int pj = (i * kSlots + tid) / kPs;
        const bool okj = pj < n_pages;
        const size_t at = (size_t)(okj ? __ldg(tb + pj) : 0) * kPs
                          + tid % kPs;
        cp_async4(smem_addr(reinterpret_cast<uint32_t*>(sm + L::kWords)
                            + stage * kSlots + tid),
                  reinterpret_cast<const uint32_t*>(krope_scale) + at / 2,
                  okj ? 4 : 0);
        sm[L::kSel + stage * kSlots + tid] = static_cast<uint8_t>(at & 1);
      }
    } else {
      const auto* kr = static_cast<const __nv_bfloat16*>(krope_v);
#pragma unroll
      for (int it = 0; it < kSlots * 8 / kBThreads; ++it) {
        const int e = tid + it * kBThreads, r = e / 8, c = e % 8;
        const int pi = (i * kSlots + r) / kPs;
        const bool ok = pi < n_pages;
        cp_async16(sb + L::k(0) + swz(r, 16 + c),
                   kr + ((size_t)(ok ? __ldg(tb + pi) : 0) * kPs + r % kPs)
                       * kR + c * 8,
                   ok ? 16 : 0);
      }
    }
  };

  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  float o[2][32];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[hh][j] = 0.f;
  float s[32];

  issue(0);
  cp_async_commit();
  for (int step = 0; step < 2 * n; ++step) {
    const int i = step < n ? step : step - n, stage = step & 1;
    const bool sweep2 = step >= n;
    if (step + 1 < 2 * n) issue(step + 1);
    cp_async_commit();
    cp_async_wait1();
    fence_async_smem();
    __syncthreads();

    const uint32_t sb = base + L::kStages + stage * L::kStage;
    if constexpr (kInt8) {
      // the rope key f32(qr8) * f32(sr) into K's third half, hi and lo
      uint8_t* sbp = sm + L::kStages + stage * L::kStage;
      const int r = tid / 4, c = tid % 4;
      const int4 x = *reinterpret_cast<const int4*>(
          sm + L::kRaw + stage * kSlots * kR + r * kR + c * 16);
      const int8_t* v8 = reinterpret_cast<const int8_t*>(&x);
      const uint32_t word =
          reinterpret_cast<const uint32_t*>(sm + L::kWords)[stage * kSlots + r];
      const float sr = __bfloat162float(__ushort_as_bfloat16(
          sm[L::kSel + stage * kSlots + r]
              ? static_cast<uint16_t>(word >> 16)
              : static_cast<uint16_t>(word & 0xFFFF)));
      uint32_t hi[8], lo[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x0 = static_cast<float>(v8[2 * j]) * sr;
        const float x1 = static_cast<float>(v8[2 * j + 1]) * sr;
        const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
        hi[j] = *reinterpret_cast<const uint32_t*>(&hb);
        lo[j] = pack_bf16(x0 - __low2float(hb), x1 - __high2float(hb));
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t* w = p ? lo : hi;
        *reinterpret_cast<uint4*>(sbp + L::k(p) + swz(r, 16 + 2 * c)) =
            make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(sbp + L::k(p) + swz(r, 16 + 2 * c + 1)) =
            make_uint4(w[4], w[5], w[6], w[7]);
      }
      fence_async_smem();
      __syncthreads();
    }

    // tiles past this warpgroup's last row are fully masked for it: skip
    if (i < n_mine) {
      if constexpr (kInt8)
        qk_split(s, q_tile, sb + L::k(0), sb + L::k(1));
      else
        qk<kE>(s, q_tile, sb + L::k(0));

      // fp32 scores times the scale, then the mask where the tile reaches
      // past the warpgroup's first query or past the table
      const bool masked = (i + 1) * kSlots - 1 > q_first
                          || (i + 1) * kSlots > n_keys;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        float x = s[j] * scale;
        if (masked) {
          const int key = i * kSlots + col;
          if (key > q_abs[(j >> 1) & 1] || key >= n_keys) x = kMaskValue;
        }
        s[j] = x;
      }

      if (!sweep2) {
        row_max_sum<false>(s, m, l);
      } else {
        uint32_t a[4][4];
        uint32_t a2[4][4];
        probs<kInt8>(s, m, l, ones, lane, a, a2);
        pv<kVd>(o, a, sb + L::v(0));
        if constexpr (kInt8) {
          pv<kVd>(o, a, sb + L::v(1));
          pv<kVd>(o, a2, sb + L::v(0));
        }
      }
    }
    __syncthreads();     // the stage is refilled by the next step's copies
  }

  // one bf16 cast; rows past T are not written
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = t0 + 16 * warp + (lane >> 2) + 8 * e;
    if (t >= T) continue;
    __nv_bfloat16* dst = out + (((size_t)b * T + t) * H + h) * kVd;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(
            dst + 64 * hh + 8 * c + 2 * (lane & 3)) =
            __floats2bfloat162_rn(o[hh][4 * c + 2 * e],
                                  o[hh][4 * c + 2 * e + 1]);
  }
}

template <bool kInt8>
int launch(int B, cudaStream_t st, const __nv_bfloat16* q,
           const __nv_bfloat16* ws, const void* krope,
           const __nv_bfloat16* krope_scale, const int32_t* tables,
           const int32_t* start, __nv_bfloat16* out, int T, int H,
           int n_pages, int S, float scale) {
  using L = MLayout<kInt8>;
  auto* kernel = mla_prefill_kernel<kInt8>;
  constexpr int kSmem = L::kBytes + 1024;
  static bool opted_in = false;       // internal linkage: one per library
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  kernel<<<dim3((T + L::kBRows - 1) / L::kBRows, H, B), L::kBThreads, kSmem,
           st>>>(q, ws, krope, krope_scale, tables, start, out, T, H,
                 n_pages, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, H, nope + R] bf16 (rope part roped); ws [B, H, S, W] bf16, stage
// A's K/V (mla_build_kv.cu); krope [P, 16, R] post-write rope-key pages,
// bf16 (krope_scale null) or int8 with krope_scale [P, 16] bf16; tables [B,
// n_pages] and start [B] int32; out [B, T, H, vd] bf16.  nope = vd = 128, R
// = 64 (deepseek-v2) and 16-token pages.  Returns 0 on success, else the
// cudaError_t of the refused or failed launch.
extern "C" int mla_ragged_prefill(const void* q, const void* ws,
                                  const void* krope, const void* krope_scale,
                                  const void* tables, const void* start,
                                  void* out, int B, int T, int H, int E,
                                  int R, int vd, int ps, int n_pages, int S,
                                  float scale, void* stream) {
  if (B < 1 || T < 1 || H < 1 || n_pages < 1 || E != kE || R != kR ||
      vd != kVd || ps != kPs || S % kSlots != 0 || S < n_pages * kPs)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* wp = static_cast<const __nv_bfloat16*>(ws);
  const auto* sp = static_cast<const __nv_bfloat16*>(krope_scale);
  const auto* tp = static_cast<const int32_t*>(tables);
  const auto* stp = static_cast<const int32_t*>(start);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (krope_scale != nullptr)
    return launch<true>(B, st, qp, wp, krope, sp, tp, stp, op, T, H,
                        n_pages, S, scale);
  return launch<false>(B, st, qp, wp, krope, sp, tp, stp, op, T, H, n_pages,
                       S, scale);
}
