// Stage A of kernel K6 (the MLA ragged chunk prefill, mla_ragged_prefill.cu
// holds stage B and the kernel's full note): build every head's K and V of
// every key a chunk's rows see, once a call, into a workspace that the
// wrapper allocates, ws [B, H, S, W] bf16 (S a multiple of 64).  Row key of
// request b, head h, is the latent c [L] of that key times the head's
// columns of wkv_b [L, H, nope + vd]:
//   bf16 pages:  ws = bf16(f32(c @ wkv_b[:, h])), W = 256 (k_nope | v),
// from fp64 sums of the exact products of the bf16 operands, rounded once
// to fp32 and then to bf16: the values of the plain version's einsum
// (models/mla.py::materialized_attend), bit for bit but for a sum within
// ~2^-44 of its value from a rounding boundary;
//   int8 pages:  x = (q8 @ wkv_b[:, h]) * f32(s) in fp32 (q8 the key slot's
// int8 latent, s its bf16 ckv scale), stored as two bf16 planes, W = 512
// (k_hi | v_hi | k_lo | v_lo): hi = bf16(x), lo = bf16(x - hi), so hi + lo
// carries 16 significant bits of x.
// The keys built for request b are its pages 0 .. min((start + T - 1) /
// 16, n_pages - 1) through the table: every key a row of the chunk sees,
// chunk padding rows too.  They go in 64-key tiles anchored at key 0; a
// tile's keys past the last built page read zeros and are stored as zeros.
// Tiles wholly past it are not written.
//
// These products are the body of the TPU kernel repro/kernels/
// ragged_prefill/kernel.py::mla_ragged_prefill_fwd (kernel.py:399-401 and
// 427-429), which rebuilt them page by page inside the attend.
//
// What bounds it: operations.  2 * keys * L * H * (nope + vd) flops (309
// GFLOP at the smoke's 9216 keys, 128 heads) against keys * L * 2 + L * H *
// 256 * 2 bytes read and keys * H * W * 2 written.
// - bf16 pages: the fp64 tensor cores, 67 TFLOP/s (H100 SXM, NVIDIA's data
//   sheet): 4.6 ms at that shape.  A block of 8 warps owns a (64-key tile,
//   the k_nope or the v columns of a head, request) and its 64 x 128
//   outputs; each warp a 32 x 32 corner, 2 x 4 fragments of 16 x 8 x 16 on
//   `mma.sync.m16n8k4.f64` (sm_90's shapes), so each A fragment feeds 4
//   products and each B fragment 2; at 128 registers two blocks share an
//   SM, and one's widening and barrier overlap the other's products (a
//   block of all 256 columns, 190 registers and one an SM, was slower).
//   k goes in steps of 16: the latent and wkv_b tiles are staged as bf16
//   by 16-byte cp.async copies four steps ahead, each thread widens the
//   chunks it copied itself to fp64 into one of two fp64 tiles (so one
//   barrier a step: a tile is rewritten two steps after it was read), and
//   the warps read their fragments from those with 64-bit loads that hit
//   32 distinct banks a half-warp (row pitches 32 bytes past a multiple
//   of 128).
// - int8 pages: the bf16 tensor cores, 989 TFLOP/s: one warpgroup owns a
//   (64-key tile, head, request); the int8 latent lands raw (cp.async, two
//   stages) and is widened to bf16 (exact: |q8| <= 127) in a 128-byte-
//   swizzled tile, wkv_b's 64 x 256 tile lands swizzled in four 64-column
//   halves, and `wgmma.m64n64k16` takes both from shared memory, wkv_b as
//   an MN-major B (K2's V layout, csrc/ragged_prefill.cuh), fp32 sums; each
//   product row is scaled by its slot's ckv scale in fp32.
//
// Numerics: no fast math.

#include "ragged_prefill.cuh"

namespace {

constexpr int kPs = 16;          // tokens per page
constexpr int kKeys = 64;        // keys a block: a stage-B key tile
constexpr int kL = 512;          // latent width
constexpr int kN = 256;          // a head's columns: nope + vd

// The keys built for one request: its pages up to the one holding the
// chunk's last row, within the table.
__device__ __forceinline__ int built_keys(int st, int T, int n_pages) {
  return min((st + T - 1) / kPs + 1, n_pages) * kPs;
}

// ------------------------------------------------------------ bf16: fp64

constexpr int kFThreads = 256;   // 8 warps: 2 (keys) x 4 (columns)
constexpr int kFN = kN / 2;      // columns a block: k_nope or v of a head
constexpr int kFK = 16;          // k a step: one 16 x 8 x 16 fragment
constexpr int kFSteps = kL / kFK;
constexpr int kFStages = 4;      // bf16 cp.async stages
constexpr int kLdA = kFK + 4;    // doubles a latent row: 160 B
constexpr int kLdW = kFN + 4;    // doubles a wkv_b row: 1056 B
constexpr int kWChunks = kFK * kFN / 8;      // 256 16-byte chunks a step
constexpr int kAChunks = kKeys * kFK / 8;    // 128
static_assert(kWChunks == kFThreads, "a wkv_b chunk a thread");

struct Fp64Smem {
  double a[2][kKeys][kLdA];      // the latent tile, [key][k]
  double w[2][kFK][kLdW];        // wkv_b's tile, [k][column]
  uint4 stage[kFStages][kWChunks + kAChunks];  // bf16 chunks, by copier
};

// d += a b over a 16 x 8 x 16 tile, fp64 in and out: a[v0 + 2 v1] is A's
// (g + 8 v0, t + 4 v1), b[v] is B's (t + 4 v, g) and d[v0 + 2 v1] is D's
// (g + 8 v1, 2 t + v0), for g = lane / 4, t = lane % 4 -- the fragments of
// `mma.m16n8k16.f64`, issued as four `mma.m16n8k4.f64`, k = t + 4 v in
// step v: of the f64 shapes (m8n8k4, m16n8k4, m16n8k8, m16n8k16) the
// fastest here, and m8n8k4 the slowest by far.
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8],
                                     const double (&b)[4]) {
#pragma unroll
  for (int v = 0; v < 4; ++v)
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[2 * v]), "d"(a[2 * v + 1]), "d"(b[v]));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 8 bf16 values as fp64 into dst[0..7], four 16-byte stores; with ``rot``
// the pairs are stored in the order 1, 2, 3, 0, which moves this thread's
// store to another bank group than a neighbour's whose chunk starts 64
// bytes apart (modulo 128) from its own.
__device__ __forceinline__ void widen8(double* dst, const uint4& x,
                                       bool rot) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  double2 d[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    d[j] = make_double2(f.x, f.y);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    reinterpret_cast<double2*>(dst)[rot ? (j + 1) & 3 : j] =
        rot ? d[(j + 1) & 3] : d[j];
}

__device__ __forceinline__ void build_fp64(
    const __nv_bfloat16* __restrict__ ckv,
    const __nv_bfloat16* __restrict__ wkv_b, const int32_t* __restrict__ tb,
    __nv_bfloat16* __restrict__ dst, int kt, int h, int half, int H,
    int n_built) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Fp64Smem& sm = *reinterpret_cast<Fp64Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp & 1, wn = warp >> 1;
  const size_t ldw = (size_t)H * kN;

  // This thread's chunks, the same every step: wkv_b chunk tid (row
  // tid % 4 + 4 ((tid / 8) % 4), 8 columns at 8 ((tid / 4) % 2 + 2 (tid /
  // 32)): with the odd column chunks' pairs rotated, a quarter-warp's
  // 16-byte stores of its widened chunks fall on 8 distinct bank groups),
  // and for tid < 128 latent chunk tid (key tid / 2, k half tid % 2, the
  // odd half rotated).
  const int w_row = tid % 4 + 4 * ((tid / 8) % 4);
  const int w_col = 8 * ((tid / 4) % 2 + 2 * (tid / 32));
  const __nv_bfloat16* w_src =
      wkv_b + (size_t)w_row * ldw + (size_t)h * kN + half * kFN + w_col;
  const bool has_a = tid < kAChunks;
  const int a_row = tid / 2, a_col = 8 * (tid % 2);
  const int key = kt * kKeys + a_row;
  const bool a_ok = has_a && key < n_built;
  const __nv_bfloat16* a_src =
      ckv + ((size_t)(a_ok ? __ldg(tb + key / kPs) : 0) * kPs + key % kPs) * kL
      + a_col;

  auto issue = [&](int s) {
    uint4* slot = sm.stage[s % kFStages];
    const int k0 = s * kFK;
    cp_async16(smem_addr(slot + tid), w_src + k0 * ldw, 16);
    if (has_a)
      cp_async16(smem_addr(slot + kWChunks + tid), a_src + k0, a_ok ? 16 : 0);
  };

  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    issue(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < kFSteps; ++s) {
    const int buf = s & 1;
    // this thread's own chunks of step s have landed: widen them
    cp_async_wait<kFStages - 2>();
    const uint4* slot = sm.stage[s % kFStages];
    widen8(&sm.w[buf][w_row][w_col], slot[tid], w_col & 8);
    if (has_a)
      widen8(&sm.a[buf][a_row][a_col], slot[kWChunks + tid], a_col != 0);
    if (s + kFStages - 1 < kFSteps) issue(s + kFStages - 1);
    cp_async_commit();
    __syncthreads();        // the step's fp64 tiles are whole

    double af[2][8];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int v = 0; v < 8; ++v)
        af[mi][v] = sm.a[buf][32 * wm + 16 * mi + g + 8 * (v & 1)]
                         [t4 + 4 * (v >> 1)];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      double bf[4];
#pragma unroll
      for (int v = 0; v < 4; ++v)
        bf[v] = sm.w[buf][t4 + 4 * v][32 * wn + 8 * ni + g];
      dmma(acc[0][ni], af[0], bf);
      dmma(acc[1][ni], af[1], bf);
    }
  }

  // fp64 -> fp32 -> bf16, each rounding to nearest
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      __nv_bfloat16* row = dst + (size_t)(32 * wm + 16 * mi + g + 8 * e) * kN
                           + half * kFN + 32 * wn + 2 * t4;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * ni) =
            __floats2bfloat162_rn((float)acc[mi][ni][2 * e],
                                  (float)acc[mi][ni][2 * e + 1]);
    }
}

// -------------------------------------------------------- int8: wgmma

// Shared-memory layout, bytes from a 1024-aligned base: the widened latent
// tile (one swizzled 64 x 64 half), two stages of wkv_b's 64 x 256 tile
// (four halves each), two raw int8 latent stages [64][64], the tile's ckv
// scales as fp32.
struct I8Layout {
  static constexpr int kA = 0;
  static constexpr int kW = kHalf;                     // + stage * 4 kHalf
  static constexpr int kRaw = kW + 2 * 4 * kHalf;      // + stage * 4096
  static constexpr int kScale = kRaw + 2 * kKeys * 64;
  static constexpr int kBytes = kScale + kKeys * 4;
};

__device__ __forceinline__ void build_int8(
    const int8_t* __restrict__ ckv, const __nv_bfloat16* __restrict__ ckv_scale,
    const __nv_bfloat16* __restrict__ wkv_b, const int32_t* __restrict__ tb,
    __nv_bfloat16* __restrict__ dst, int kt, int h, int H, int n_built) {
  using Ly = I8Layout;
  extern __shared__ uint8_t smem_raw8[];
  uint8_t* sm = smem_raw8 + ((1024 - (smem_addr(smem_raw8) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t ldw = (size_t)H * kN;
  constexpr int kSteps = kL / 64;

  // the raw latent rows this thread copies (keys e / 4, 16 bytes at
  // 16 (e % 4)), the same every step; keys past the built ones read zeros
  const int8_t* a_src[2];
  bool a_ok[2];
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int e = tid + it * kThreads, key = kt * kKeys + e / 4;
    a_ok[it] = key < n_built;
    a_src[it] = ckv + ((size_t)(a_ok[it] ? __ldg(tb + key / kPs) : 0) * kPs
                       + key % kPs) * kL + 16 * (e % 4);
  }
  float* scale_f = reinterpret_cast<float*>(sm + Ly::kScale);
  if (tid < kKeys) {
    const int key = kt * kKeys + tid;
    scale_f[tid] = key < n_built
        ? __bfloat162float(ckv_scale[(size_t)__ldg(tb + key / kPs) * kPs
                                     + key % kPs])
        : 0.f;
  }

  auto issue = [&](int s) {
    const int stage = s & 1, k0 = 64 * s;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int e = tid + it * kThreads;
      cp_async16(base + Ly::kRaw + stage * kKeys * 64 + (e / 4) * 64
                 + 16 * (e % 4), a_src[it] + k0, a_ok[it] ? 16 : 0);
    }
    const uint32_t w = base + Ly::kW + stage * 4 * kHalf;
#pragma unroll
    for (int it = 0; it < 64 * 32 / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e / 32, c = e % 32;
      cp_async16(w + swz(r, c),
                 wkv_b + (size_t)(k0 + r) * ldw + (size_t)h * kN + 8 * c, 16);
    }
  };

  float acc[4][32];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[n][j] = 0.f;

  issue(0);
  cp_async_commit();
#pragma unroll 1
  for (int s = 0; s < kSteps; ++s) {
    const int stage = s & 1;
    if (s + 1 < kSteps) issue(s + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    // the int8 latent as bf16 into the swizzled A tile
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int e = tid + it * kThreads, r = e / 4, c = e % 4;
      const int4 x = *reinterpret_cast<const int4*>(
          sm + Ly::kRaw + stage * kKeys * 64 + r * 64 + 16 * c);
      const int8_t* v = reinterpret_cast<const int8_t*>(&x);
      uint32_t p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        p[j] = pack_bf16(static_cast<float>(v[2 * j]),
                         static_cast<float>(v[2 * j + 1]));
      *reinterpret_cast<uint4*>(sm + Ly::kA + swz(r, 2 * c)) =
          make_uint4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<uint4*>(sm + Ly::kA + swz(r, 2 * c + 1)) =
          make_uint4(p[4], p[5], p[6], p[7]);
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t w = base + Ly::kW + stage * 4 * kHalf;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wgmma_ss_mn(acc[n], desc(base + Ly::kA + kk * 32, 16, 1024),
                    desc(w + n * kHalf + kk * 2048, 1024, 1024));
    wg_commit_wait();
#pragma unroll
    for (int n = 0; n < 4; ++n) pin(acc[n]);
    __syncthreads();        // the stage and the A tile are refilled next
  }

  // x = sum * scale (fp32), stored as hi = bf16(x) and lo = bf16(x - hi)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 16 * warp + (lane >> 2) + 8 * e;
    const float sc = scale_f[r];
    __nv_bfloat16* row = dst + (size_t)r * 2 * kN;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 64 * n + 8 * c + 2 * (lane & 3);
        const float x0 = acc[n][4 * c + 2 * e] * sc;
        const float x1 = acc[n][4 * c + 2 * e + 1] * sc;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        *reinterpret_cast<__nv_bfloat162*>(row + col) = hi;
        *reinterpret_cast<__nv_bfloat162*>(row + kN + col) =
            __floats2bfloat162_rn(x0 - __low2float(hi), x1 - __high2float(hi));
      }
  }
}

template <bool kInt8>
__global__ void __launch_bounds__(kInt8 ? kThreads : kFThreads, kInt8 ? 1 : 2)
mla_build_kv_kernel(const void* __restrict__ ckv,                 // [P, ps, L]
                    const __nv_bfloat16* __restrict__ ckv_scale,  // [P, ps]
                    const __nv_bfloat16* __restrict__ wkv_b,  // [L, H, 256]
                    const int32_t* __restrict__ tables,       // [B, n_pages]
                    const int32_t* __restrict__ start,        // [B]
                    __nv_bfloat16* __restrict__ ws,           // [B, H, S, W]
                    int T, int H, int n_pages, int S) {
  // bf16 pages: two blocks a head, its k_nope columns and its v columns
  const int kt = blockIdx.x, h = kInt8 ? blockIdx.y : blockIdx.y >> 1,
            b = blockIdx.z;
  const int n_built = built_keys(start[b], T, n_pages);
  if (kt * kKeys >= n_built) return;
  const int32_t* tb = tables + (size_t)b * n_pages;
  constexpr int kW = kInt8 ? 2 * kN : kN;
  __nv_bfloat16* dst = ws + ((size_t)(b * H + h) * S + kt * kKeys) * kW;
  if constexpr (kInt8)
    build_int8(static_cast<const int8_t*>(ckv), ckv_scale, wkv_b, tb, dst,
               kt, h, H, n_built);
  else
    build_fp64(static_cast<const __nv_bfloat16*>(ckv), wkv_b, tb, dst, kt, h,
               blockIdx.y & 1, H, n_built);
}

template <bool kInt8>
int launch(const dim3& grid, cudaStream_t st, const void* ckv,
           const void* ckv_scale, const void* wkv_b, const void* tables,
           const void* start, void* ws, int T, int H, int n_pages, int S) {
  auto* kernel = mla_build_kv_kernel<kInt8>;
  const int smem = kInt8 ? I8Layout::kBytes + 1024 : (int)sizeof(Fp64Smem);
  static bool opted_in = false;       // internal linkage: one per library
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  kernel<<<grid, kInt8 ? kThreads : kFThreads, smem, st>>>(
      ckv, static_cast<const __nv_bfloat16*>(ckv_scale),
      static_cast<const __nv_bfloat16*>(wkv_b),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(start),
      static_cast<__nv_bfloat16*>(ws), T, H, n_pages, S);
  return (int)cudaGetLastError();
}

}  // namespace

// ckv [P, 16, L] latent pages, bf16 (ckv_scale null) or int8 with ckv_scale
// [P, 16] bf16; wkv_b [L, H, nope + vd] bf16; tables [B, n_pages] and start
// [B] int32; T the chunk's rows; ws [B, H, S, W] bf16 with W = nope + vd
// (bf16 pages) or 2 (nope + vd) (int8), S >= n_pages * 16 a multiple of 64.
// L = 512, nope = vd = 128 (deepseek-v2) and 16-token pages.  Returns 0 on
// success, else the cudaError_t of the refused or failed launch.
extern "C" int mla_build_kv(const void* ckv, const void* ckv_scale,
                            const void* wkv_b, const void* tables,
                            const void* start, void* ws, int B, int T, int H,
                            int L, int nope, int vd, int ps, int n_pages,
                            int S, void* stream) {
  if (B < 1 || T < 1 || H < 1 || n_pages < 1 || L != kL || nope != 128 ||
      vd != 128 || ps != kPs || S % kKeys != 0 || S < n_pages * kPs)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (ckv_scale != nullptr)
    return launch<true>(dim3(S / kKeys, H, B), st, ckv, ckv_scale, wkv_b,
                        tables, start, ws, T, H, n_pages, S);
  return launch<false>(dim3(S / kKeys, 2 * H, B), st, ckv, ckv_scale, wkv_b,
                       tables, start, ws, T, H, n_pages, S);
}
