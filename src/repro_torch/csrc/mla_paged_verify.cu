// Kernel K7: small-q absorbed-latent MLA verify for Hopper (sm_90a), Q = 1 +
// draft length query tokens per request, bf16 or int8 latent pages.  The
// body, its contract, bound and design are in mla_attention.cuh (shared
// with K5, which is its one-query case: K7 with one live query reproduces
// K5 bit for bit, and its row j the decode step at pos + j); this file
// gives it its C entry point.  A request's Q * H rows, token-major, go to
// ceil(Q * H / 64) row tiles: at Q = 5 and H = 128 ten tiles of 64 heads of
// one token, at H = 8 one tile of all 40 rows.  Tiles of dead tokens write
// empty partials and read nothing.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/kernel.py::
// mla_paged_verify_fwd (_mla_paged_verify_kernel).

#include "mla_attention.cuh"

// q_eff/out [B, Q, H, L] and q_rope [B, Q, H, R] bf16; latent pages and
// scales as mla_paged_decode; tables [B, n_pages], pos and n_q [B] int32
// (base positions, live query counts); workspace as mla_paged_decode's, Q
// times larger (B * n_splits * Q * H * (L + 2) * 4 bytes).  Returns 0 on
// success, else the cudaError_t of the refused or failed launch.
extern "C" int mla_paged_verify(const void* q_eff, const void* q_rope,
                                const void* ckv, const void* krope,
                                const void* ckv_scale,
                                const void* krope_scale, const void* tables,
                                const void* pos, const void* n_q, void* out,
                                void* workspace, long long workspace_bytes,
                                int B, int Q, int H, int L, int R, int ps,
                                int n_pages, float scale, void* stream) {
  return mla::launch(q_eff, q_rope, ckv, krope, ckv_scale, krope_scale,
                     tables, pos, n_q, out, workspace, workspace_bytes, B, Q,
                     H, L, R, ps, n_pages, scale, stream);
}
