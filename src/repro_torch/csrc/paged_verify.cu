// Kernel K3: small-q speculative verify for Hopper (sm_90a), Q = 1 + draft
// length query tokens per request, bf16 or int8 pages.  The body, its
// contract, bound and design are in paged_attention.cuh (shared with K1,
// which is its one-query case: with n_q = 1 on every row K3 reproduces K1
// bit for bit); this file instantiates it for up to kVerifyRows
// (query token, query head) rows per (request, KV head) and gives it its C
// entry point.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/kernel.py::
// paged_verify_fwd (_paged_verify_kernel).

#include "paged_attention.cuh"

// Q * G rows per block: 35 at Q = 5 (four drafts) and G = 7 (qwen2-0.5b);
// the static shared memory (queries, four warps' pages, scores and
// softmax states) stays under the 48 KB a block gets without opting in.
constexpr int kVerifyRows = 48;

// q/out [B, Q, H, D] bf16; pools and tables as paged_decode; pos and n_q
// [B] int32 (base positions, live query counts).  Returns 0 on success,
// else the cudaError_t of the refused or failed launch.
extern "C" int paged_verify(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scale,
                            const void* v_scale, const void* tables,
                            const void* pos, const void* n_q, void* out,
                            int B, int Q, int K, int G, int D, int ps,
                            int n_pages, float scale, void* stream) {
  return paged::launch<kVerifyRows>(q, k_pages, v_pages, k_scale, v_scale,
                                    tables, pos, n_q, out, B, Q, K, G, D, ps,
                                    n_pages, scale, stream);
}
