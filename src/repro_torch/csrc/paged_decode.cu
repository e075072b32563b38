// Kernel K1: paged-attention decode for Hopper (sm_90a), one query token per
// request, bf16 or int8 pages, full causal or sliding-window ring (window >
// 0, the table a ring of n_pages * ps slots).  The body (keys split over
// blocks, mma.sync tensor-core products, cp.async staging, an ordered
// merge), its contract, bound and design are in paged_attention.cuh; this
// file instantiates it for one query row per (request, query head), one
// m16 tile a block, and gives it its C entry point.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/kernel.py::
// paged_decode_fwd, with its logit-softcap mode.

#include "paged_attention.cuh"

// Query heads per KV head: the block's rows at one query token.
constexpr int kDecodeRows = 16;

// q/out [B, H, D] bf16; k_pages/v_pages [P, ps, K, D] bf16, or int8 with
// k_scale/v_scale [P, ps, K] bf16 (both null for bf16 pages); tables
// [B, n_pages] and pos [B] int32; window 0 (causal) or the sliding window
// of the ring; softcap 0 (none) or the logit cap c > 0; workspace: the split partials, at least workspace_bytes =
// B * K * n_splits * G * (D + 2) * 4 (paged_attention.cuh, launch).
// Returns 0 on success, else the cudaError_t of the refused or failed
// launch.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scale,
                            const void* v_scale, const void* tables,
                            const void* pos, void* out, void* workspace,
                            long long workspace_bytes, int B, int K, int G,
                            int D, int ps, int n_pages, int window,
                            float scale, float softcap, void* stream) {
  return paged::launch<kDecodeRows>(q, k_pages, v_pages, k_scale, v_scale,
                                    tables, pos, nullptr, out, workspace,
                                    workspace_bytes, B, 1, K, G, D, ps,
                                    n_pages, window, scale, softcap,
                                    stream);
}
