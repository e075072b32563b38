// Kernel K9: causal (or full) GQA flash-attention forward for Hopper
// (sm_90a), the attention of the LM training forward.  q [B, S, H, D] and
// k, v [B, S, K, D] in the model's layout (H % K == 0, query head h reads
// KV head h / G, G = H / K), out [B, S, H, D] in q's dtype; fp32 or bf16.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd (_flash_kernel), and computes what it computes: per
// (b, h, q-tile) an online softmax over K/V tiles with the running max m,
// the normalizer l and the accumulator acc in fp32; q * scale taken in fp32
// before the dot; fp32 scores; the fully-masked-row guards (a row whose
// running max is still -inf takes p = 0 and alpha = 0); p kept in fp32 for
// PV (never rounded to the value dtype); out = acc / max(l, 1e-20) cast
// once.  Tiles strictly above the diagonal are skipped under the causal
// mask.  The TPU kernel asserts S % block == 0; here the ragged tail is
// masked instead (keys at or past S score -inf, queries past S are not
// written), so any S runs.
//
// What bounds it: operations.  Causal at qwen2-0.5b's training shape (B 8,
// S 1024, 14 query / 2 KV heads of 64) the work is 4 * B * H * D * S^2 / 2
// = 15.0 GFLOP on 33.6 MB of q, k, v and out: 0.015 ms at the H100's bf16
// tensor-core rate (989 TFLOP/s) against 0.010 ms of memory at 3.35 TB/s
// (NVIDIA's data sheet).  The TPU kernel keeps p in fp32, and the tensor
// cores would need p rounded to bf16, so this first version runs every
// product on the fp32 CUDA cores (67 TFLOP/s peak): its floor is 0.22 ms
// there, and PERF.md holds its time against the bound.
//
// Design.  One block of 256 threads per (64-query tile, query head,
// request); the tiles run heaviest first (the last causal tile sweeps the
// most keys).  The block stages its 64 queries (times scale, fp32) once,
// then sweeps 64-key tiles of its KV head: K and V staged in shared memory
// as fp32 (a zero-filled tail past S), scores of a 4 x 4 register tile per
// thread (rows 4 ty .. 4 ty + 3, keys tx + 16 j, so a quarter-warp reads 8
// different key rows through a 4-float pad without bank conflicts), the
// row max and sum by shuffles across the 16 threads of a row group, p
// staged in shared memory, then PV into each thread's 4 rows x D / 16
// columns (columns tx + 16 c: consecutive threads, consecutive banks).
// Each thread keeps m and l of its own 4 rows, so the alpha rescale needs no
// exchange.  GQA reads each KV head's tiles once per query head: nothing is
// replicated in device memory.  Head dims 32, 64 and 128; shared memory is
// 45, 68 and 116 KB a block (dynamic, opted in above 48 KB).
//
// Numerics: IEEE expf and division (build without --use_fast_math); the
// dot products sum d in ascending order with fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64, kBK = 64;
constexpr int kThreads = 256;        // 16 row groups x 16 threads
constexpr int kLp = kBK + 4;         // padded row of the p tile
static_assert(kBQ == kBK, "stage() moves 64-row tiles of q, k and v alike");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage rows [r0, r0 + 64) of one head of a [B, S, heads, D] tensor as
// fp32 into dst[64][D + 4], times mul; rows at or past S as zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ src, int b,
                                      int head, int heads, int S, int r0,
                                      float mul) {
  constexpr int kLd = D + 4;
  for (int e = threadIdx.x * 4; e < kBK * D; e += kThreads * 4) {
    const int r = e / D, d = e % D;
    const int s = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) {
      v = load4(src + (((size_t)b * S + s) * heads + head) * D + d);
      v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * kLd + d) = v;
  }
}

template <int D>
struct Smem {
  float q[kBQ * (D + 4)];
  float k[kBK * (D + 4)];
  float v[kBK * (D + 4)];
  float p[kBQ * kLp];
};

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int H,
                 int K, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kC = D / 16;                  // output columns a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;

  stage<T, D>(sm.q, q, b, h, H, S, q0, scale);   // q * scale in fp32

  float m[4], l[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  // keys a tile of queries can see: causal rows stop at their own position
  const int k_end = kCausal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                    // the last tile's k, v and p are done
    stage<T, D>(sm.k, k, b, kh, K, S, k0, 1.f);
    stage<T, D>(sm.v, v, b, kh, K, S, k0, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(sm.q + (ty * 4 + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = load4(sm.k + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float m_cur = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S || (kCausal && kpos > qpos)) s[i][j] = -INFINITY;
        m_cur = fmaxf(m_cur, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_new = fmaxf(m[i], m_cur);
      const bool live = m_new > -INFINITY;        // guard fully-masked rows
      const float safe = live ? m_new : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live ? expf(s[i][j] - safe) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = m[i] > -INFINITY ? expf(m[i] - safe) : 0.f;
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sm.p[(ty * 4 + i) * kLp + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int n = 0; n < kBK; n += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = load4(sm.p + (ty * 4 + i) * kLp + n);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) vv[c] = sm.v[(n + u) * kLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? pr[i].x : u == 1 ? pr[i].y
                         : u == 2 ? pr[i].z : pr[i].w;
#pragma unroll
          for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* row = out + (((size_t)b * S + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) store(row + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int D, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int K, float scale, cudaStream_t st) {
  auto* kernel = flash_fwd_kernel<T, D, kCausal>;
  constexpr size_t kSmem = sizeof(Smem<D>);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, kSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, K, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_causal(int causal, const void* q, const void* k, const void* v,
                    void* out, int B, int S, int H, int K, float scale,
                    cudaStream_t st) {
  return causal ? launch<T, D, true>(q, k, v, out, B, S, H, K, scale, st)
                : launch<T, D, false>(q, k, v, out, B, S, H, K, scale, st);
}

template <typename T>
int dispatch(int D, int causal, const void* q, const void* k, const void* v,
             void* out, int B, int S, int H, int K, float scale,
             cudaStream_t st) {
  switch (D) {
    case 32:
      return dispatch_causal<T, 32>(causal, q, k, v, out, B, S, H, K, scale,
                                    st);
    case 64:
      return dispatch_causal<T, 64>(causal, q, k, v, out, B, S, H, K, scale,
                                    st);
    case 128:
      return dispatch_causal<T, 128>(causal, q, k, v, out, B, S, H, K, scale,
                                     st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out [B, S, H, D] and k, v [B, S, K, D], contiguous, 16-byte aligned;
// H % K == 0; D in {32, 64, 128}; bf16 != 0: every tensor bf16, else fp32.
// Scores are (q * scale) . k.  Returns 0 on success, else the cudaError_t
// of the refused or failed launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int K, int D,
                               int causal, float scale, int bf16,
                               void* stream) {
  if (B < 1 || S < 1 || K < 1 || H < 1 || H % K || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(D, causal, q, k, v, out, B, S, H, K,
                                        scale, st)
              : dispatch<float>(D, causal, q, k, v, out, B, S, H, K, scale,
                                st);
}
