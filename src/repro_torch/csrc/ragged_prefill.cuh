// Shared machinery of the Hopper tensor-core attention kernels.  K2
// (ragged_prefill.cu, full attention over the post-write pool) and K4
// (windowed_ragged_prefill.cu, a sliding window over a pre-write page ring
// plus the chunk's fresh K/V) run one warpgroup (128 threads) per 64-row
// query tile: a row is a (token, group head) pair, token-major; keys go in
// 64-slot tiles staged by 16-byte cp.async copies, two stages deep, into
// 128-byte-swizzled bf16 halves; QK^T is `wgmma.m64n64k16` with Q and the
// K tile from shared memory, PV `wgmma.m64n64k16` with p from registers and
// V MN-major; sweep 1 takes each row's max and normalizer, sweep 2 its
// probabilities at the true max and PV.  K9 (flash_attention.cu) and K5/K7
// (mla_attention.cuh) take one online-softmax sweep instead
// (`online_step`).  Each kernel's note gives its contract and what it
// stages.
//
// Everything here sits in an anonymous namespace, the shared-memory opt-in
// flag of `launch_kernel` too: a static of a template with external linkage
// is one GNU-unique object across every library that holds it, and the
// second library to launch would skip its own opt-in (CUDA error 1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;       // query rows a block: the wgmma M
constexpr int kSlots = 64;      // key slots a tile: QK^T's N, PV's 4 x k16
constexpr int kThreads = 128;   // one warpgroup
constexpr int kMaxPs = 32;      // tokens per page
constexpr int kMaxG = 128;      // query heads per KV head
constexpr int kHalf = 64 * 128; // bytes of one 128-byte-swizzled 64-row half
constexpr float kMaskValue = -1e30f;

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
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator across the wait
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define RP_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),              \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
  "+f"(d[31])
#define RP_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B, m64n64k16, bf16 in, fp32 out; A and B K-major in shared
// memory.  ``accumulate`` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RP_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RP_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d += A B, m64n64k16: A (bf16 pairs) from registers in the accumulator's
// row layout, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RP_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RP_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, m64n64k16: A K-major and B MN-major, both in shared memory
// (K6's stage A, K5/K7's PV).
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RP_REGS32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : RP_ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}

#undef RP_ACC32
#undef RP_REGS32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte offset of 16-byte chunk c (8 bf16 columns) of row r in a swizzled
// tile: 64-column halves of 64 rows x 128 bytes, chunk index XOR row % 8
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * kHalf + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Copy the block's 64 query rows (zeros past T) into the swizzled Q tile.
template <int D>
__device__ __forceinline__ void issue_q(uint32_t dst,
                                        const __nv_bfloat16* __restrict__ q,
                                        int b, int tile, int T, int H, int G,
                                        int kh) {
  constexpr int kC = D / 8;
  for (int e = threadIdx.x; e < kRows * kC; e += kThreads) {
    const int r = e / kC, c = e % kC;
    const int row = tile * kRows + r, t = row / G;
    const bool ok = t < T;
    const __nv_bfloat16* src =
        q + (((size_t)b * T + (ok ? t : 0)) * H + kh * G + row % G) * D
        + c * 8;
    cp_async16(dst + swz(r, c), src, ok ? 16 : 0);
  }
}

// The slots of a paged key tile this thread copies, the same in every
// tile: its copy ``it`` is 16 bytes of slot r = (tid + 128 it) / kC (kC
// copies a row), kept as the slot's page in the tile and token in the
// page; page -1 for slots past kt.
template <int kC>
struct Slots {
  static constexpr int kIt = kSlots * kC / kThreads;
  int page[kIt], tok[kIt];
  __device__ __forceinline__ Slots(int ps, int kt) {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int r = (threadIdx.x + it * kThreads) / kC;
      page[it] = r < kt ? r / ps : -1;
      tok[it] = r % ps;
    }
  }
};

template <int D, bool kInt8>
using KvSlots = Slots<D * (kInt8 ? 1 : 2) / 16>;

// S = Q K^T over D / 16 k-steps: Q and K K-major, 32-byte steps within a
// 128-byte swizzled row, the second half at D = 128.
template <int D>
__device__ __forceinline__ void qk(float (&s)[32], uint32_t q, uint32_t k) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kHalf + (kk & 3) * 32;
    wgmma_ss(s, desc(q + off, 16, 1024), desc(k + off, 16, 1024), kk > 0);
  }
  wg_commit_wait();
  pin(s);
}

// O += P V over the tile's 4 k16 steps of 16 keys; V MN-major, one
// 64-column half per instruction (a half is one swizzle atom wide, so the
// leading offset is never stepped: both offsets are the 8-key stride).
template <int D>
__device__ __forceinline__ void pv(float (&o)[(D + 63) / 64][32],
                                   const uint32_t (&a)[4][4], uint32_t v) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < (D + 63) / 64; ++h)
      wgmma_rs(o[h], a[kk], desc(v + h * kHalf + kk * 2048, 1024, 1024));
  wg_commit_wait();
#pragma unroll
  for (int h = 0; h < (D + 63) / 64; ++h) pin(o[h]);
}

// Sweep 1 on one tile's masked fp32 scores: each of this thread's two rows
// takes the tile's max into m and its sum into l, l rescaled to the new
// max, l * exp(m_old - m_new) + sum exp(s - m_new); each of the row's 4
// threads sums its 16 columns in order, then a fixed shuffle tree.  A tile
// fully masked for a row that has seen keys adds exactly 0 and leaves m.
// ``kEmptyTiles``: a row may meet fully masked tiles before its first seen
// key (K4's ring tiles under the window); those leave m at the mask value
// and l at 0 instead of counting their masked slots at exp(0).
template <bool kEmptyTiles>
__device__ __forceinline__ void row_max_sum(const float (&s)[32],
                                            float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float mx = kMaskValue;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (((j >> 1) & 1) == e) mx = fmaxf(mx, s[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[e], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (((j >> 1) & 1) == e) sum += expf(s[j] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (kEmptyTiles && m_new == kMaskValue) continue;
    l[e] = l[e] * expf(m[e] - m_new) + sum;
    m[e] = m_new;
  }
}

// Sweep 2's probabilities as PV's A operand, in the accumulator's row
// layout: p = exp(s - m) / l at the true max, rounded to bf16 (``a``);
// ``kInt8``: p' = p * vs[key] (fp32) as two bf16 terms, a = bf16(p') and
// a2 = bf16(p' - a).
template <bool kInt8>
__device__ __forceinline__ void probs(const float (&s)[32],
                                      const float (&m)[2],
                                      const float (&l)[2], const float* vs,
                                      int lane, uint32_t (&a)[4][4],
                                      uint32_t (&a2)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 8 * kk + 2 * r, e = r & 1;
      float p0 = expf(s[j] - m[e]) / l[e];
      float p1 = expf(s[j + 1] - m[e]) / l[e];
      if constexpr (kInt8) {
        const int col = 8 * (j >> 2) + 2 * (lane & 3);
        p0 = p0 * vs[col];
        p1 = p1 * vs[col + 1];
        const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
        a[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
        a2[kk][r] = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
      } else {
        a[kk][r] = pack_bf16(p0, p1);
      }
    }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One online-softmax step on a tile's masked fp32 scores, for this
// thread's two rows: m_new = max(m, tile max), p = exp(s - m_new) (0 while
// m_new is -inf), alpha = exp(m - m_new) (0 while m is -inf), l = l *
// alpha + sum p, o *= alpha.  p replaces s; each row's alpha goes to
// ``al`` (for accumulators held elsewhere).  Each of a row's 4 threads
// sums its 16 columns in order, then (t0 + t1) + (t2 + t3).
template <int kH>
__device__ __forceinline__ void online_step(float (&s)[32], float (&m)[2],
                                            float (&l)[2],
                                            float (&o)[kH][32],
                                            float (&al)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (((j >> 1) & 1) == e) mx = fmaxf(mx, s[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[e], mx);
    const bool live = m_new > -INFINITY;          // guard fully-masked rows
    const float safe = live ? m_new : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (((j >> 1) & 1) == e) {
        s[j] = live ? expf(s[j] - safe) : 0.f;
        sum += s[j];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = m[e] > -INFINITY ? expf(m[e] - safe) : 0.f;
    l[e] = l[e] * alpha + sum;
    m[e] = m_new;
    al[e] = alpha;
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (((j >> 1) & 1) == e) o[h][j] *= alpha;
  }
}

// Launch ``kKernel`` (one warpgroup a block) with ``smem`` bytes of
// dynamic shared memory, opting in above 48 KB at its first launch in this
// library.  Returns 0, or the cudaError_t of the refused or failed launch.
template <auto kKernel, typename... Args>
int launch_kernel(const dim3& grid, int smem, cudaStream_t st,
                  Args... args) {
  auto* kernel = kKernel;
  static bool opted_in = false;       // internal linkage: one per library
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
