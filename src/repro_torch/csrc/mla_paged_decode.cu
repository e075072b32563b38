// Kernel K5: absorbed-latent MLA paged decode for Hopper (sm_90a), one query
// token per request, bf16 or int8 latent pages.  The body (rows in 64-row
// tensor-core tiles, keys split over blocks at 8 absolute pages, cp.async
// staging, `wgmma` products, an ordered merge), its contract, bound and
// design are in mla_attention.cuh (shared with K7, the small-q verify, of
// which this is the one-query case); this file gives it its C entry point.
// At deepseek-v2's 128 heads a request's rows are two tiles of 64 heads,
// each sweeping every split its token sees.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/kernel.py::
// mla_paged_decode_fwd (_mla_paged_decode_kernel).

#include "mla_attention.cuh"

// q_eff/out [B, H, L] and q_rope [B, H, R] bf16; ckv [P, ps, L] and krope
// [P, ps, R] latent pages, bf16 (scales null) or int8 (ckv_scale and
// krope_scale [P, ps] bf16); tables [B, n_pages] and pos [B] int32;
// workspace: the split partials, at least workspace_bytes = B * n_splits *
// H * (L + 2) * 4 (mla_attention.cuh, launch).  L = 512, R = 64
// (deepseek-v2), H a multiple of 8, ps <= 16.  Returns 0 on success, else
// the cudaError_t of the refused or failed launch.
extern "C" int mla_paged_decode(const void* q_eff, const void* q_rope,
                                const void* ckv, const void* krope,
                                const void* ckv_scale,
                                const void* krope_scale, const void* tables,
                                const void* pos, void* out, void* workspace,
                                long long workspace_bytes, int B, int H,
                                int L, int R, int ps, int n_pages,
                                float scale, void* stream) {
  return mla::launch(q_eff, q_rope, ckv, krope, ckv_scale, krope_scale,
                     tables, pos, nullptr, out, workspace, workspace_bytes,
                     B, 1, H, L, R, ps, n_pages, scale, stream);
}
