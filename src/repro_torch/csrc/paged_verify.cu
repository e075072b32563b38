// Kernel K3: small-q speculative verify for Hopper (sm_90a), Q = 1 + draft
// length query tokens per request, bf16 or int8 pages, full causal or
// sliding-window ring (window > 0).  The body, its contract, bound and
// design are in paged_attention.cuh (shared with K1, which is its one-query
// case: with n_q = 1 on every row K3 reproduces K1 bit for bit, ring mode
// included); this file instantiates it for up to kVerifyRows (query token,
// query head) rows per block and gives it its C entry point.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/kernel.py::
// paged_verify_fwd (_paged_verify_kernel), with its logit-softcap mode.

#include "paged_attention.cuh"

// At most 48 (query token, query head) rows per block, three m16 tiles: Q =
// 5 (four drafts) is 35 rows at G = 7 (qwen2-0.5b) and 45 at G = 9
// (starcoder2-7b), one row block per (request, KV head); at G = 12
// (command-r-plus-104b) its 60 rows go to two row blocks of 4 and 1 query
// tokens.  At D = 128 an int8 block takes 215 KB of dynamic shared memory
// (a 256-key split of K and V, the scores and p), so a fourth m16 tile
// would not fit beside them.
constexpr int kVerifyRows = 48;

// q/out [B, Q, H, D] bf16; pools and tables as paged_decode; pos and n_q
// [B] int32 (base positions, live query counts); window and softcap as
// paged_decode;
// workspace at least B * K * n_splits * Q * G * (D + 2) * 4 bytes.
// Returns 0 on success, else the cudaError_t of the refused or failed
// launch.
extern "C" int paged_verify(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scale,
                            const void* v_scale, const void* tables,
                            const void* pos, const void* n_q, void* out,
                            void* workspace, long long workspace_bytes,
                            int B, int Q, int K, int G, int D, int ps,
                            int n_pages, int window, float scale,
                            float softcap, void* stream) {
  return paged::launch<kVerifyRows>(q, k_pages, v_pages, k_scale, v_scale,
                                    tables, pos, n_q, out, workspace,
                                    workspace_bytes, B, Q, K, G, D, ps,
                                    n_pages, window, scale, softcap,
                                    stream);
}
