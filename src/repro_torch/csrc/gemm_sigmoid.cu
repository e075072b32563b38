// Kernel K8: fused GEMM + bias + sigmoid for Hopper (sm_90a), the RBM's
// hidden and visible probabilities out = sigmoid(x @ w + b) with x [M, K],
// w [K, N] (any positive strides: the negative phase passes W transposed
// as a view and the kernel reads it by index, never materialized), b [N];
// fp32 or bf16 operands, an fp32 sum, the bias and the sigmoid applied
// once after the full sum, the output in x's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/rbm_cd/kernel.py::
// gemm_sigmoid_fwd (_gemm_sigmoid_kernel): there the MXU-tiled product
// accumulates in fp32 VMEM scratch over the K grid axis and the epilogue
// runs on the last K step.
//
// What bounds it.  2 M N K flops on (M K + K N + N + M N) values.  At the
// forward-propagation job's [60000, 784] x [784, 1000], 94 GFLOP on 0.43
// GB: operations.  The paper's path is fp32 and is held to 1e-5 of an fp32
// product, which one TF32 term misses (~5e-4 at layer 0), so the product
// runs on the TF32 tensor cores as three terms: 3 x 94 GFLOP at 495
// TFLOP/s, 0.57 ms, against 1.40 ms for fp32 on the CUDA cores at 67
// TFLOP/s (H100 SXM, NVIDIA's data sheet).  At a CD step's [100, 784] x
// [784, 1000] the work is 0.16 GFLOP on 3.9 MB: the bytes bound it (1.2
// us), and latency sets the pace, so it takes many blocks in flight.
//
// The arithmetic.  The output is computed transposed, out^T = w^T x^T, so
// that 64 of w's output features fill wgmma's rows and 128 batch rows its
// columns (a CD step's 100 rows in one tile).  Each fp32 operand is split
// into two TF32 terms, hi = tf32(a) and lo = tf32(a - hi), tf32() rounding
// to nearest, ties away from zero (half of the 13 dropped bits added to
// the bits, then cleared: what cvt.rna.tf32.f32 computes, in two integer
// operations).  Each k8 step issues `wgmma.m64n128k8.f32.tf32.tf32` for
// w_lo x_hi, w_hi x_lo, then w_hi x_hi (the small terms first); w_lo x_lo
// is dropped.  Products are exact (11-bit significands) and the split
// leaves each within ~3 * 2^-22 of its own size.  Both operands come from
// shared memory as K-major, 128-byte-swizzled planes: TF32 wgmma has no
// transpose, so a row-major w [K, N] is transposed as its planes are
// written; the W.T view is K-major already.  bf16 operands are exact in
// TF32: one term, w_hi x_hi.
//
// The sum in two levels: K is cut into splits of whole 32-wide slices
// (ops.split_plan, a function of N and K only); a split's k8 steps run
// into one fresh wgmma accumulator, and the splits' sums are added in
// split order with IEEE fp32 adds, so the tensor cores' internal rounding
// (not documented as IEEE) acts on one split's sum at a time.  Then z =
// sum + b and sigmoid(z) = 1 / (1 + exp(-z)), as torch.sigmoid computes
// it (IEEE expf and division: no fast math).  No atomics: two calls give
// the same bits, and a row's order does not depend on the batch, so a row
// computed alone equals its row in the batch.
//
// Two kernels carry it.  (1) Where the output tiles alone give fewer
// blocks than the card's 132 SMs (every CD step), each split is a block
// of its own: one warpgroup, a 64-feature x 128-row tile, cp.async copies
// two slices ahead, each slice split into one buffer of planes and then
// its products, two blocks an SM.  The splits of a tile (at most 16) are
// one cluster: each stages its fp32 partial in its shared memory, and
// each adds, for its share of the tile's rows, every block's partial in
// split order over distributed shared memory, then applies the bias and
// the sigmoid: one launch, no workspace.  The same kernel runs whole
// tiles where N fits one tile of 64 features or x's rows are not 16-byte
// aligned.  (2) Else (the forward-propagation job) a first kernel writes
// w's planes once a call into a workspace the wrapper allocates, and a
// warp-specialized kernel runs 128 features x 128 rows a block: two
// warpgroups run the products of 64 features each, and a third loads x's
// [128][32] boxes three slices ahead by TMA, loads w's planes (already
// swizzled) one slice ahead by TMA, and splits x into two buffers of
// planes, handing each over by named barriers.  Both write their tiles
// through shared memory, 16 bytes a thread.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 64;      // output features a warpgroup: wgmma's M
constexpr int kTileM = 128;     // batch rows a block: wgmma's N
constexpr int kSlice = 32;      // k a staged slice: one 128-byte TF32 row
constexpr int kXPlane = kTileM * kSlice * 4;   // bytes of a TF32 plane of x

// The planes of one slice, from a 1024-aligned base: x's hi plane
// [128][32], x's lo plane (fp32), w's hi plane [kFeat][32] and w's lo plane
// (fp32), each K-major and 128-byte swizzled; and a raw stage of one slice
// as copied, x [128][32] then w's tile, [kFeat][32] (k contiguous: the
// W.T view) or [32][kFeat] (n contiguous).  The splits-as-blocks kernel
// (kWgs 1) holds one buffer of planes and two raw stages (kSmem).
template <typename T, int kWgs>
struct Layout {
  static constexpr int kTerms = sizeof(T) == 4 ? 3 : 1;
  static constexpr int kFeat = kTileN * kWgs;  // output features a block
  static constexpr int kPlanes = kTerms == 3 ? 2 : 1;
  static constexpr int kWPlane = kFeat * kSlice * 4;
  static constexpr int kXLo = kXPlane;
  static constexpr int kWHi = kPlanes * kXPlane;
  static constexpr int kWLo = kWHi + kWPlane;
  static constexpr int kBuf = kPlanes * (kXPlane + kWPlane);
  static constexpr int kXRaw = kTileM * kSlice * sizeof(T);
  static constexpr int kStage = kXRaw + kFeat * kSlice * sizeof(T);
  static constexpr int kSmem = kBuf + 2 * kStage + 1024;
};

template <typename T>
struct Args {
  CUtensorMap tx;    // x [M, K], [128][32] boxes (the TMA path)
  CUtensorMap tw_hi, tw_lo;   // w's TF32 planes [N][Kp], swizzled boxes
  const T* x;        // [M, K] row-major
  const T* w;        // w's raw tiles: rows at w_rs, columns at w_cs
  const T* b;        // [N]
  T* out;            // [M, N] row-major
  long long w_rs, w_cs;
  int M, N, K;
  int w_kmajor;      // staged as [n][k] (rows n), else [k][n] (rows k)
  int x_vec, w_vec;  // 16-byte copies
  int per, slices;   // slices a split, slices of K
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}
// named barrier ``id`` over ``n`` threads: wait, or arrive without waiting
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
// mbarrier: init with an arrival count; arrive expecting ``bytes`` of
// bulk copies; wait for the phase of ``parity`` to complete
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One box of a 2-d tensor map at (c0, c1), innermost first, by the TMA
// unit into shared memory at ``dst``, completing on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(bar) : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// fp32 -> TF32 (low 13 bits zero), to nearest, ties away from zero: half
// of the dropped field added to the bits, then the field cleared, a carry
// running into the exponent (what cvt.rna.tf32.f32 computes for finite
// values, in two full-rate integer operations).
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}
// hi and lo TF32 terms of four fp32 values: hi = tf32(v), lo = tf32(v - hi)
__device__ __forceinline__ void split4(const float (&v)[4], uint4& hi,
                                       uint4& lo) {
  hi = make_uint4(tf32(v[0]), tf32(v[1]), tf32(v[2]), tf32(v[3]));
  lo = make_uint4(tf32(v[0] - __uint_as_float(hi.x)),
                  tf32(v[1] - __uint_as_float(hi.y)),
                  tf32(v[2] - __uint_as_float(hi.z)),
                  tf32(v[3] - __uint_as_float(hi.w)));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(16 >> 4) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// waits for this warpgroup's committed products; the asm keeps the
// compiler from moving reads of the accumulator across the wait
__device__ __forceinline__ void wg_wait(float (&d)[64]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define K8_ACC64(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),              \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
  "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),          \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),          \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),          \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),          \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define K8_REGS64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A B, m64n128k8, TF32 in, fp32 out; A and B K-major in shared
// memory.  ``accumulate`` 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " K8_REGS64
      ", %64, %65, p, 1, 1;\n}\n"
      : K8_ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef K8_ACC64
#undef K8_REGS64

// Stage a [rows][cols] tile, element (r, c) from src + r rs + c cs, into
// shared memory at dst (row stride ds elements): thread ``tid`` of kN.
// Elements at r >= vr or c >= vc are not copied (split_x and split_w
// mask them); a 16-byte chunk that crosses vc is zero-filled past it.
// ``vec``: cs == 1 and every row 16-byte aligned.
template <typename T, int kN>
__device__ __forceinline__ void stage(int tid, T* dst, int ds, const T* src,
                                      long long rs, long long cs, int rows,
                                      int cols, int vr, int vc, bool vec) {
  constexpr int kE = 16 / sizeof(T);
  if (vec) {
    const int cpr = cols / kE;
#pragma unroll 4
    for (int e = tid; e < rows * cpr; e += kN) {
      const int r = e / cpr, c = e % cpr * kE;
      const int n = r < vr ? min(kE, vc - c) : 0;
      if (n > 0)
        cp_async16(smem_addr(dst + r * ds + c), src + r * rs + c,
                   n * (int)sizeof(T));
    }
    return;
  }
#pragma unroll 4
  for (int e = tid; e < rows * cols; e += kN) {
    const int r = e / cols, c = e % cols;
    if (r >= vr || c >= vc) continue;
    if constexpr (sizeof(T) == 4)
      cp_async4(smem_addr(dst + r * ds + c), src + r * rs + c * cs, 4);
    else
      dst[r * ds + c] = src[r * rs + c * cs];
  }
}

// Slice first + j's raw copies, x [128][32] then w's tile, into ``st``
template <typename T, int kN, int kFeat>
__device__ __forceinline__ void issue_slice(int tid, const Args<T>& p,
                                            uint8_t* st, int sl, int m0,
                                            int n0) {
  constexpr int kXRaw = kTileM * kSlice * sizeof(T);
  T* xs = reinterpret_cast<T*>(st);
  T* wsm = reinterpret_cast<T*>(st + kXRaw);
  const int k0 = sl * kSlice;
  stage<T, kN>(tid, xs, kSlice, p.x + (size_t)m0 * p.K + k0, p.K, 1, kTileM,
               kSlice, p.M - m0, p.K - k0, p.x_vec);
  if (p.w_kmajor)
    stage<T, kN>(tid, wsm, kSlice, p.w + n0 * p.w_rs + k0 * p.w_cs, p.w_rs,
                 p.w_cs, kFeat, kSlice, p.N - n0, p.K - k0, p.w_vec);
  else
    stage<T, kN>(tid, wsm, kFeat, p.w + k0 * p.w_rs + n0 * p.w_cs, p.w_rs,
                 p.w_cs, kSlice, kFeat, p.K - k0, p.N - n0, p.w_vec);
}

// byte offset of 16-byte chunk c (4 TF32 values) of row r in a K-major
// 128-byte-swizzled plane: rows of 128 bytes, chunk index XOR row % 8
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Four consecutive staged values (16- or 8-byte aligned) as fp32, in one
// vector load: a quarter (bf16: half) warp reads 128 contiguous bytes
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xFFFF0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

// Four values to 16 (fp32) or 8 (bf16) aligned bytes of global memory
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                      const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const uint32_t*>(&a),
      *reinterpret_cast<const uint32_t*>(&b));
}

// Four staged values as fp32, and into the planes: hi (and lo for fp32)
template <typename T>
__device__ __forceinline__ void put4(const float (&v)[4], uint8_t* hi,
                                     uint8_t* lo, uint32_t off) {
  if constexpr (sizeof(T) == 4) {
    uint4 h, l;
    split4(v, h, l);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  } else {       // bf16 values are exact in TF32: one term
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(
        __float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
        __float_as_uint(v[3]));
  }
}

// A staged slice into one buffer's planes ``b``: thread ``tid`` of kN.
// x [128][32] row-wise (split_x); w [kFeat][32] row-wise (``kmajor``) or,
// from [32][kFeat], each chunk gathered down four k rows, the transpose
// TF32 wgmma needs (split_w).  Values at x rows >= xr, w features >= wn
// or k >= kv are taken as 0.
template <typename T, int kN, int kFeat>
__device__ __forceinline__ void split_x(int tid, const T* xs, uint8_t* b,
                                        int xr, int kv) {
  using L = Layout<T, kFeat / kTileN>;
  constexpr int kIt = kTileM * 8 / kN;   // chunks a thread; loads first
  float v[kIt][4];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int e = tid + it * kN;
    load4(xs + (e >> 3) * kSlice + 4 * (e & 7), v[it]);
  }
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int e = tid + it * kN, r = e >> 3, c = e & 7;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (r >= xr || 4 * c + q >= kv) v[it][q] = 0.f;
    put4<T>(v[it], b, b + L::kXLo, swz(r, c));
  }
}
template <typename T, int kN, int kFeat>
__device__ __forceinline__ void split_w(int tid, const T* wsm, bool kmajor,
                                        uint8_t* b, int wn, int kv) {
  using L = Layout<T, kFeat / kTileN>;
  constexpr int kIt = kFeat * 8 / kN;
  float v[kIt][4];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int e = tid + it * kN;
    if (kmajor) {
      load4(wsm + (e >> 3) * kSlice + 4 * (e & 7), v[it]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[it][q] = to_f32(wsm[(4 * (e / kFeat) + q) * kFeat + e % kFeat]);
    }
  }
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int e = tid + it * kN;
    const int n = kmajor ? e >> 3 : e % kFeat;
    const int c = kmajor ? e & 7 : e / kFeat;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (n >= wn || 4 * c + q >= kv) v[it][q] = 0.f;
    put4<T>(v[it], b + L::kWHi, b + L::kWLo, swz(n, c));
  }
}
template <typename T, int kN, int kFeat>
__device__ __forceinline__ void split_slice(int tid, const uint8_t* st,
                                            bool kmajor, uint8_t* b, int xr,
                                            int wn, int kv) {
  using L = Layout<T, kFeat / kTileN>;
  split_x<T, kN, kFeat>(tid, reinterpret_cast<const T*>(st), b, xr, kv);
  split_w<T, kN, kFeat>(tid, reinterpret_cast<const T*>(st + L::kXRaw),
                        kmajor, b, wn, kv);
}

// One slice's products for this warpgroup's 64 features: x's planes at
// ``bx``, its rows of w's planes at ``aw``, 4 k8 steps; ``keep0`` 0 starts
// a fresh accumulator (a split's first slice).
template <typename T, int kWgs>
__device__ __forceinline__ void mma_slice(float (&acc)[64], uint32_t bx,
                                          uint32_t aw, int keep0) {
  using L = Layout<T, kWgs>;
  wg_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t x_hi = desc128(bx + 32 * j), w_hi = desc128(aw + 32 * j);
    if constexpr (L::kTerms == 3) {
      wgmma_tf32(acc, desc128(aw + L::kWPlane + 32 * j), x_hi,
                 j > 0 || keep0);
      wgmma_tf32(acc, w_hi, desc128(bx + L::kXLo + 32 * j), 1);
      wgmma_tf32(acc, w_hi, x_hi, 1);
    } else {
      wgmma_tf32(acc, w_hi, x_hi, j > 0 || keep0);
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  wg_wait(acc);
}

// After slice ``sl``: at a split's end, its sum into the total (the
// block's first split taken as it is).
__device__ __forceinline__ void fold(float (&tot)[64], float (&acc)[64],
                                     const int sl, const int per,
                                     const int slices, const int s_first) {
  if (sl % per == per - 1 || sl == slices - 1) {
    const bool first_split = sl / per == s_first;
#pragma unroll
    for (int e = 0; e < 64; ++e)
      tot[e] = first_split ? acc[e] : tot[e] + acc[e];
  }
}

// The warpgroup's 64 x 128 tile of sums ``tot`` into shared memory ``st``
// ([128 rows][kPitch] fp32; ``wtid`` the thread's index in the
// warpgroup, named barrier ``bar`` over it).
constexpr int kPitch = kTileN + 4;
__device__ __forceinline__ void stage_tile(const float (&tot)[64], float* st,
                                           int wtid, int bar) {
  const int lane = wtid & 31, n_lo = (wtid >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 64; ++j)
    st[(8 * (j >> 2) + 2 * (lane & 3) + (j & 1)) * kPitch + n_lo
       + 8 * ((j >> 1) & 1)] = tot[j];
  bar_sync(bar, 128);
}

// sigmoid(z + b) of four sums z at out[m][n..n + 3] (those below N), in
// one 16-byte (bf16: 8-byte) store where N allows
template <typename T>
__device__ __forceinline__ void write_out(const Args<T>& p, int m, int n,
                                          float (&z)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    z[q] = sigmoid(z[q] + to_f32(p.b[min(n + q, p.N - 1)]));
  T* const o = p.out + (size_t)m * p.N + n;
  if (p.N % 4 == 0) {
    store4(o, z);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (n + q < p.N) o[q] = from_f32<T>(z[q]);
}

// The staged tile (features n_w.., rows m0..) row by row into out
template <typename T>
__device__ __forceinline__ void write_tile(const Args<T>& p, const float* st,
                                           int wtid, int n_w, int m0) {
  for (int e = wtid; e < kTileM * kTileN / 4; e += 128) {
    const int r = e >> 4, n = n_w + 4 * (e & 15), m = m0 + r;
    if (m >= p.M || n >= p.N) continue;
    float z[4];
    load4(st + r * kPitch + 4 * (e & 15), z);
    write_out(p, m, n, z);
  }
}

// The address of ``st`` in the shared memory of the cluster's block
// ``rank``, and four fp32 values read there
__device__ __forceinline__ uint32_t cluster_addr(const void* st, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_addr(st)), "r"(rank));
  return a;
}
__device__ __forceinline__ void load4_cluster(uint32_t a, float (&v)[4]) {
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "r"(a)
               : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The splits of a tile are the blocks of one cluster (rank = split); each
// has staged its partial.  Block ``rank`` of ``splits`` takes its share of
// the tile's rows, adds the partials of every block in split order from
// their shared memory, and writes sigmoid(sum + b) into out.
template <typename T>
__device__ __forceinline__ void merge_tile(const Args<T>& p, const float* st,
                                           int rank, int splits, int n0,
                                           int m0) {
  const int r0 = rank * kTileM / splits, r1 = (rank + 1) * kTileM / splits;
  for (int e = threadIdx.x; e < (r1 - r0) * 16; e += 128) {
    const int r = r0 + (e >> 4), n = n0 + 4 * (e & 15), m = m0 + r;
    if (m >= p.M || n >= p.N) continue;
    const float* at = st + r * kPitch + 4 * (e & 15);
    float z[4], v[4];
    load4_cluster(cluster_addr(at, 0), z);
    for (int s = 1; s < splits; ++s) {
      load4_cluster(cluster_addr(at, s), v);
#pragma unroll
      for (int q = 0; q < 4; ++q) z[q] += v[q];
    }
    write_out(p, m, n, z);
  }
}

// The splits-as-blocks kernel (every CD step; also whole tiles where N
// fits 64 features or x's rows are not 16-byte aligned): one warpgroup a
// block copies its slices two ahead and splits each into one buffer of
// planes, then runs its products; two blocks an SM.  As splits, the
// blocks of a tile form a cluster and merge through shared memory.
template <typename T>
__global__ void __launch_bounds__(128, 2)
gemm_sigmoid_kernel(const Args<T> p) {
  using L = Layout<T, 1>;
  constexpr int kStages = 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* const raw = sm + L::kBuf;
  const uint32_t sm_a = smem_addr(sm);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.y * kTileM;
  const bool split_blocks = gridDim.z > 1;
  const int s_first = split_blocks ? blockIdx.z : 0;
  const int first = s_first * p.per;
  const int count = (split_blocks ? min(first + p.per, p.slices) : p.slices)
                    - first;

  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (j < count)
      issue_slice<T, 128, kTileN>(tid, p, raw + j * L::kStage, first + j, m0,
                                  n0);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kStages - 1>();   // slice i landed
    __syncthreads();                // for all; slice i - 1's products done
    split_slice<T, 128, kTileN>(tid, raw + (i % kStages) * L::kStage,
                                p.w_kmajor, sm, p.M - m0, p.N - n0,
                                p.K - (first + i) * kSlice);
    fence_async_smem();
    __syncthreads();
    if (i + kStages < count)        // into slice i's stage
      issue_slice<T, 128, kTileN>(tid, p, raw + (i % kStages) * L::kStage,
                                  first + i + kStages, m0, n0);
    cp_async_commit();
    mma_slice<T, 1>(acc, sm_a, sm_a + L::kWHi, (first + i) % p.per != 0);
    fold(tot, acc, first + i, p.per, p.slices, s_first);
  }
  bar_sync(1, 128);               // every warp's products done: sm is free
  float* const st = reinterpret_cast<float*>(sm);
  stage_tile(tot, st, tid, 1);
  if (!split_blocks) {
    write_tile(p, st, tid, n0, m0);
    return;
  }
  cluster_sync();                 // every split's partial staged
  merge_tile(p, st, blockIdx.z, gridDim.z, n0, m0);
  cluster_sync();                 // read: the blocks may exit
}

// The forward-propagation kernel's shared memory, from a 1024-aligned
// base: two buffers of x's planes (hi [128][32], lo for fp32), a ring of
// three stages of w's planes for the block's 128 features (hi, lo), a
// ring of three raw x boxes [128][32], then the mbarriers of the two
// rings.
template <typename T>
struct WsLayout {
  using L = Layout<T, 2>;
  static constexpr int kXBuf = L::kPlanes * kXPlane;
  static constexpr int kWBuf = L::kPlanes * L::kWPlane;
  static constexpr int kRing = 3;
  static constexpr int kW = 2 * kXBuf, kRaw = kW + kRing * kWBuf;
  static constexpr int kBars = kRaw + kRing * L::kXRaw;
  static constexpr int kSmem = kBars + 2 * kRing * 8 + 1024;
};

// Its producer warpgroup (thread ``tid`` of 128): TMA boxes of x three
// slices ahead into the raw ring (mbarriers ``xbar``), w's pre-split
// planes one slice ahead into the w ring (mbarriers ``wbar``, which the
// products wait on), and each x box split into x plane buffer i % 2 once
// the products have read it.
template <typename T>
__device__ __forceinline__ void produce(int tid, const Args<T>& p,
                                        uint8_t* sm, int m0, int n0) {
  using L = Layout<T, 2>;
  using W = WsLayout<T>;
  constexpr int kR = W::kRing, kAll = 384;
  const int count = p.slices;
  const uint32_t sm_a = smem_addr(sm), wbar = sm_a + W::kBars;
  const uint32_t xbar = wbar + 8 * kR;
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < 2 * kR; ++j) mbar_init(wbar + 8 * j, 1);
    fence_mbar_init();
  }
  bar_sync(5, 128);
  auto load_x = [&](int j) {
    const uint32_t bar = xbar + 8 * (j % kR);
    mbar_expect(bar, L::kXRaw);
    tma_load(sm_a + W::kRaw + (j % kR) * L::kXRaw, &p.tx, j * kSlice, m0,
             bar);
  };
  auto load_w = [&](int j) {
    const uint32_t dst = sm_a + W::kW + (j % kR) * W::kWBuf;
    const uint32_t bar = wbar + 8 * (j % kR);
    mbar_expect(bar, W::kWBuf);
    tma_load(dst, &p.tw_hi, j * kSlice, n0, bar);
    if constexpr (L::kTerms == 3)
      tma_load(dst + L::kWPlane, &p.tw_lo, j * kSlice, n0, bar);
  };
  if (tid == 0)
    for (int j = 0; j < kR && j < count; ++j) {
      load_x(j);
      if (j < 2) load_w(j);
    }
  for (int i = 0; i < count; ++i) {
    mbar_wait(xbar + 8 * (i % kR), (i / kR) & 1);
    if (i >= 2) bar_sync(3 + (i & 1), kAll);    // slice i - 2 read
    if (tid == 0 && i >= 1 && i + 1 < count) load_w(i + 1);
    split_x<T, 128, L::kFeat>(
        tid, reinterpret_cast<const T*>(sm + W::kRaw + (i % kR) * L::kXRaw),
        sm + (i & 1) * W::kXBuf, kTileM, kSlice);
    fence_async_smem();
    bar_sync(5, 128);                 // slice i's x box read by all
    if (tid == 0 && i + kR < count) load_x(i + kR);
    bar_arrive(1 + (i & 1), kAll);
  }
}

// w [K, N] (any strides) -> its TF32 planes hi, lo [N][Kp] (k contiguous,
// Kp = K rounded up to 4), 32 x 32 tiles transposed through shared memory
template <typename T>
__global__ void __launch_bounds__(256)
gemm_sigmoid_wsplit_kernel(const T* __restrict__ w, long long w_sk,
                           long long w_sn, int K, int N, int Kp,
                           uint32_t* __restrict__ hi,
                           uint32_t* __restrict__ lo) {
  __shared__ float t[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int k = k0 + r, n = n0 + threadIdx.x;
    t[r][threadIdx.x] = k < K && n < N ? to_f32(w[k * w_sk + n * w_sn]) : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int n = n0 + r, k = k0 + threadIdx.x;
    if (n >= N || k >= Kp) continue;
    const float v = t[threadIdx.x][r];
    const size_t at = (size_t)n * Kp + k;
    if constexpr (sizeof(T) == 4) {
      const uint32_t h = tf32(v);
      hi[at] = h;
      lo[at] = tf32(v - __uint_as_float(h));
    } else {
      hi[at] = __float_as_uint(v);
    }
  }
}

// The forward-propagation kernel, warp-specialized: warpgroups 0 and 1
// each own 64 of the block's 128 features and run the products;
// warpgroup 2 fills the rings and x's plane buffers (``produce``).  Named
// barriers hand x's buffers over: FULL[b] (ids 1, 2) when warpgroup 2 has
// split into buffer b, EMPTY[b] (ids 3, 4) when the products have read
// it; id 5 orders warpgroup 2's own reads; id 6 and 7 (8) the epilogue.
template <typename T>
__global__ void __launch_bounds__(384, 1)
gemm_sigmoid_ws_kernel(const __grid_constant__ Args<T> p) {
  using W = WsLayout<T>;
  constexpr int kAll = 384;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int wg = threadIdx.x >> 7;
  const int n0 = blockIdx.x * 128, m0 = blockIdx.y * kTileM;
  const int count = p.slices;
  if (wg == 2) {
    produce<T>(threadIdx.x - 256, p, sm, m0, n0);
    return;
  }

  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
  const uint32_t sm_a = smem_addr(sm), wbar = sm_a + W::kBars;
  for (int i = 0; i < count; ++i) {
    const int buf = i & 1, ring = i % W::kRing;
    bar_sync(1 + buf, kAll);
    mbar_wait(wbar + 8 * ring, (i / W::kRing) & 1);
    mma_slice<T, 2>(acc, sm_a + buf * W::kXBuf,
                    sm_a + W::kW + ring * W::kWBuf + wg * (kTileN * 128),
                    i % p.per != 0);
    if (i + 2 < count) bar_arrive(3 + buf, kAll);
    fold(tot, acc, i, p.per, p.slices, 0);
  }
  bar_sync(6, 256);                 // both warpgroups' products done
  float* const st = reinterpret_cast<float*>(sm) + wg * kTileM * kPitch;
  stage_tile(tot, st, threadIdx.x & 127, 7 + wg);
  write_tile(p, st, threadIdx.x & 127, n0 + wg * kTileN, m0);
}

// Launch ``kKernel`` with ``threads`` and ``smem`` bytes of dynamic shared
// memory, in clusters of ``cluster`` blocks along z, opting in above 48 KB
// and to clusters above the portable 8 blocks at its first launch in this
// library.
template <auto kKernel, typename A>
int launch(const dim3& grid, int threads, int smem, int cluster,
           cudaStream_t st, const A& a) {
  static bool opted_in = false;       // internal linkage: one per library
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)        // clusters above 8 blocks (H100: 16)
      e = cudaFuncSetAttribute(
          kKernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = cluster;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kKernel, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A 2-d tensor map over [outer][inner] elements (rows ``row_bytes`` apart)
// in boxes of [box_outer][box_inner], zeros outside; false on failure.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                uint64_t inner, uint64_t outer, uint64_t row_bytes,
                uint32_t box_inner, uint32_t box_outer,
                CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;     // looked up once
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {inner, outer}, strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer}, steps[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Splits as blocks (a cluster a tile), N within 64 features, or x's rows
// not 16-byte aligned: one warpgroup a block.  Else w pre-split into
// planes in ws, then the warp-specialized kernel.
template <typename T>
int run(const void* x, const void* w, const void* b, void* out, void* ws,
        int M, int N, int K, int w_sk, int w_sn, int per, int splits,
        int grid_splits, cudaStream_t st) {
  Args<T> a;
  a.x = static_cast<const T*>(x);
  a.w = static_cast<const T*>(w);
  a.b = static_cast<const T*>(b);
  a.out = static_cast<T*>(out);
  a.M = M, a.N = N, a.K = K;
  a.w_kmajor = w_sk == 1 && w_sn != 1;
  a.w_rs = a.w_kmajor ? w_sn : w_sk;
  a.w_cs = a.w_kmajor ? 1 : w_sn;
  const size_t es = sizeof(T);
  a.x_vec = (uintptr_t)x % 16 == 0 && (size_t)K * es % 16 == 0;
  a.w_vec = a.w_cs == 1 && (uintptr_t)w % 16 == 0
            && (size_t)a.w_rs * es % 16 == 0;
  a.per = per;
  a.slices = (K + kSlice - 1) / kSlice;
  const int m_tiles = (M + kTileM - 1) / kTileM;
  if (grid_splits == 1 && N > kTileN && a.x_vec && ws != nullptr) {
    const int kp = (K + 3) / 4 * 4;
    uint32_t* hi = static_cast<uint32_t*>(ws);
    uint32_t* lo = hi + (size_t)N * kp;
    const CUtensorMapDataType xt = sizeof(T) == 4
        ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (tensor_map(&a.tx, xt, x, K, M, K * es, kSlice, kTileM,
                   CU_TENSOR_MAP_SWIZZLE_NONE) &&
        tensor_map(&a.tw_hi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, hi, K, N,
                   kp * 4, kSlice, 128, CU_TENSOR_MAP_SWIZZLE_128B) &&
        tensor_map(&a.tw_lo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, lo, K, N,
                   kp * 4, kSlice, 128, CU_TENSOR_MAP_SWIZZLE_128B)) {
      gemm_sigmoid_wsplit_kernel<T>
          <<<dim3((kp + 31) / 32, (N + 31) / 32), dim3(32, 8), 0, st>>>(
              a.w, w_sk, w_sn, K, N, kp, hi, lo);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      return launch<gemm_sigmoid_ws_kernel<T>>(
          dim3((N + 127) / 128, m_tiles), 384, WsLayout<T>::kSmem, 1, st, a);
    }
  }
  return launch<gemm_sigmoid_kernel<T>>(
      dim3((N + kTileN - 1) / kTileN, m_tiles, grid_splits), 128,
      Layout<T, 1>::kSmem, grid_splits, st, a);
}

}  // namespace

// x [M, K] and out [M, N] contiguous; w's element (k, n) at k * w_sk + n *
// w_sn (w_sn == 1: row-major [K, N]; w_sk == 1: a transposed view of a
// row-major [N, K]); b [N].  bf16 != 0: every operand and the output are
// bf16, else fp32.  K in ``splits`` splits of ``per`` 32-wide slices
// (ops.split_plan); ``grid_splits`` is ``splits`` (each split a block, a
// cluster of them a tile: at most 16) or 1.  ``ws``: w's two TF32 planes
// [N][K rounded up to 4] for N above 64 with grid_splits 1
// (ops.workspace), else unused.  Returns 0 on success, else the
// cudaError_t of the refused or failed launch.
extern "C" int gemm_sigmoid(const void* x, const void* w, const void* b,
                            void* out, void* ws, int M, int N, int K,
                            int w_sk, int w_sn, int bf16, int per,
                            int splits, int grid_splits, void* stream) {
  const int slices = (K + kSlice - 1) / kSlice;
  if (M < 1 || N < 1 || K < 1 || w_sk < 1 || w_sn < 1 || per < 1 ||
      splits != (slices + per - 1) / per ||
      (grid_splits != 1 && grid_splits != splits) || grid_splits > 16 ||
      (M + kTileM - 1) / kTileM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(x, w, b, out, ws, M, N, K, w_sk, w_sn,
                                   per, splits, grid_splits, st)
              : run<float>(x, w, b, out, ws, M, N, K, w_sk, w_sn, per,
                           splits, grid_splits, st);
}
