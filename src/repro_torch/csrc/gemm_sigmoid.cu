// Kernel K8: fused GEMM + bias + sigmoid for Hopper (sm_90a), the RBM's
// hidden and visible probabilities out = sigmoid(x @ w + b) with x [M, K],
// w [K, N] (any strides: the negative phase passes W transposed as a view
// and the kernel reads it by index, never materialized), b [N]; fp32 or
// bf16 operands, an fp32 accumulator, the bias and the sigmoid applied
// once at the end, the output in x's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/rbm_cd/kernel.py::
// gemm_sigmoid_fwd (_gemm_sigmoid_kernel): there the MXU-tiled product
// accumulates in fp32 VMEM scratch over the K grid axis and the epilogue
// runs on the last K step.
//
// What bounds it: operations.  2 * M * N * K flops on (M * K + K * N + N +
// M * N) values -- at the forward-prop job's [60000, 784] x [784, 1000],
// 94 GFLOP on 0.43 GB, so the fp32 rate bounds it: the paper's path is
// fp32, and TF32 tensor cores would move results by ~1e-3, so this kernel
// runs on the CUDA cores at 67 TFLOP/s (H100 SXM, NVIDIA's data sheet) and
// never in TF32.  At the CD steps' [100, 784] x [784, 1000] the work is
// 0.16 GFLOP: a few microseconds at that rate, so launch and latency
// dominate there.
//
// Design: a plain shared-memory tiled SGEMM.  One block of 256 threads per
// 64 x 64 output tile; the K axis is swept in 16-wide slices staged in
// shared memory as fp32 (x's slice transposed, so each thread reads its
// rows with one stride), each thread owning a 4 x 4 sub-tile in registers.
// Each slice's 16 products are summed into a partial that is then added to
// the accumulator (a two-level sum, closer to a blocked library GEMM's
// rounding than one running sum over K).  Ragged M, N and K are handled by
// bounds checks: out-of-range operands stage as zeros, which add nothing,
// and out-of-range outputs are not written.  No tensor cores, no TF32.
//
// Numerics: IEEE expf and division (build without --use_fast_math);
// sigmoid(z) = 1 / (1 + exp(-z)), as torch.sigmoid computes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_sigmoid_kernel(const T* __restrict__ x,    // [M, K] row-major
                    const T* __restrict__ w,    // (k, n) at k*w_sk + n*w_sn
                    const T* __restrict__ b,    // [N]
                    T* __restrict__ out,        // [M, N] row-major
                    int M, int N, int K, int w_sk, int w_sn) {
  __shared__ float xs[kBK][kBM + 4];    // x slice, transposed: xs[k][m]
  __shared__ float ws[kBK][kBN + 4];    // w slice: ws[k][n]
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // w is read along its contiguous axis: n when w_sn == 1, else k
  const bool w_rows = w_sn == 1;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int mm = e / kBK, kk = e % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kk = w_rows ? e / kBN : e % kBK;
      const int nn = w_rows ? e % kBN : e / kBK;
      const int gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < K && gn < N)
          ? to_f32(w[(size_t)gk * w_sk + (size_t)gn * w_sn]) : 0.f;
    }
    __syncthreads();
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][tm * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ws[kk][tn * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], c[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tm * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tn * 4 + j;
      if (gn >= N) continue;
      const float z = acc[i][j] + to_f32(b[gn]);
      out[(size_t)gm * N + gn] = from_f32<T>(1.f / (1.f + expf(-z)));
    }
  }
}

}  // namespace

// x [M, K] and out [M, N] contiguous; w's element (k, n) at k * w_sk + n *
// w_sn (w_sn == 1: row-major [K, N]; w_sk == 1: a transposed view of a
// row-major [N, K]); b [N].  bf16 != 0: every operand and the output are
// bf16, else fp32.  Returns 0 on success, else the cudaError_t of the
// refused or failed launch.
extern "C" int gemm_sigmoid(const void* x, const void* w, const void* b,
                            void* out, int M, int N, int K, int w_sk,
                            int w_sn, int bf16, void* stream) {
  if (M < 1 || N < 1 || K < 1 || w_sk < 1 || w_sn < 1 ||
      (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    gemm_sigmoid_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), M, N, K, w_sk, w_sn);
  else
    gemm_sigmoid_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(out), M, N, K,
        w_sk, w_sn);
  return (int)cudaGetLastError();
}
