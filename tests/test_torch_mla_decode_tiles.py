"""K5's and K7's tensor-core arithmetic on the CPU: a model of the Hopper
kernels' order and rounding (``csrc/mla_attention.cuh``) held to
``mla_paged_decode_plain``/``mla_paged_verify_plain`` and to the Pallas
TPU kernels.

The model, written here and nowhere in the package, computes what the
kernels compute, in their order, for every request:

* rows are (query token, head) pairs, token-major, in 64-row tiles (64
  heads of a token at H = 128, several tokens' heads at H = 8 or 16);
* a row's keys are split at 8 absolute pages: a tile's block for split s
  sweeps pages 8 s .. min(a_hi, 8 s + 7), a_hi the page of the tile's last
  live query (at most the table's last); a split with none of them leaves
  an empty partial;
* within a split, 64-slot key tiles of four pages, each page padded to 16
  slots, anchored at the split's first page;
* scores are fp32 sums of exact bf16 products, each k16 step's 16 products
  summed exactly and added to the fp32 accumulator (the tensor cores' k16
  step): one sum over the 576 columns for bf16 pages; int8, the 512 ckv
  and the 64 krope columns apart, s = cs * s_ckv + rs * s_rope; then times
  the scale; slots past ps, past the row's position or past the table, and
  dead rows, score -inf;
* one online-softmax step a tile with the TPU kernel's guards: m_new =
  max(m, tile max), p = exp(s - m_new) (0 while m_new is -inf), alpha =
  exp(m - m_new) (0 while m is -inf), l = l * alpha + sum p, the tile's sum
  taken as the kernel's threads take it (each of a row's 4 threads sums
  its 16 columns in order, then (t0 + t1) + (t2 + t3)), O *= alpha;
* p' = p (int8: p * cs) as two bf16 terms, h1 = bf16(p') and h2 = bf16(p'
  - h1), each times the tile's ckv part (int8 values as bf16), k16 steps
  summed exactly into the fp32 accumulator, h1's four steps before h2's;
* the partials merged in increasing split order with the guarded rescale
  (m = max, l = l f_old + l_s f_s, O the same, each one fused multiply-add),
  empty partials skipped, then one bf16 cast after O / max(l, 1e-20).

Bounds: each output element within one bf16 ulp of the largest |plain|
in its row (one head of one token), never below 2^-14 -- the bound
``chip_smoke.py`` holds the kernels to on the card -- and the same against
the Pallas kernels in interpret mode on the same numpy inputs.  Bit for
bit, in the model, as the card checks the kernels: K7 with one live query
equals K5; a verify row j equals the decode row at pos + j; a request
alone equals its rows in the batch.  Positions sit at a split's edges
(split width - 1, split width, split width + 1 keys), across several
splits, and at 0 (an idle row on the null page).  Inputs are drawn from a
seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.kernel import (  # noqa: E402
    mla_paged_decode_fwd, mla_paged_verify_fwd)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    mla_paged_decode_plain, mla_paged_verify_plain)
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    MLA_DIMS, MLA_SPLIT_PAGES)
from repro_torch.models.attention import quantize_int8  # noqa: E402

L, R = MLA_DIMS
ROWS = 64                     # rows of a tile: the wgmma M
PAGE_SLOTS = 16               # a page's slots in a key tile
TILE_PAGES = 4                # pages of a 64-slot key tile
INF = float("inf")
SCALE = 192 ** -0.5


from _torch_common import one_thread  # noqa: E402, F401


def _quad_sum(e):
    """[rows, 64] -> [rows]: thread c of a row's quad holds columns 8 j +
    2 c + {0, 1} and sums them in order; then (t0 + t1) + (t2 + t3)."""
    x = e.reshape(-1, 8, 4, 2).permute(0, 2, 1, 3).reshape(-1, 4, 16)
    t = x[:, :, 0].clone()
    for j in range(1, 16):
        t = t + x[:, :, j]
    return (t[:, 0] + t[:, 1]) + (t[:, 2] + t[:, 3])


def _mma(acc, a, b):
    """acc [rows, N] fp32 (None: zeros) += a [rows, n] @ b [n, N], both
    exact in bf16: each k16 step's 16 products summed exactly, then one
    fp32 rounding into the accumulator."""
    rows, n = a.shape
    steps = torch.einsum("rck,ckn->crn", a.double().reshape(rows, n // 16, 16),
                         b.double().reshape(n // 16, 16, -1))
    for t in steps:
        acc = t.float() if acc is None else (acc.double() + t).float()
    return acc


def _fma(x, y, z):
    """fp32 fmaf: x * y + z rounded once (x * y is exact in fp64)."""
    return (x.double() * y.double() + z.double()).float()


def _split(qt, qp, table, ckv, krope, cs_pages, rs_pages, first, final, ps,
           n_keys):
    """One block's partial (m, l, O) for its rows (qt [rows, L + R] bf16
    values, qp their positions, -1 for dead rows) over pages first..final
    of a split."""
    rows = qt.shape[0]
    int8 = cs_pages is not None
    m = torch.full((rows,), -INF)
    l = torch.zeros(rows)
    o = torch.zeros(rows, L)
    col = torch.arange(ROWS)
    t = col % PAGE_SLOTS
    for i in range((final - first) // TILE_PAGES + 1):
        kt = torch.zeros(ROWS, L + R)
        cs = torch.zeros(ROWS)
        rs = torch.zeros(ROWS)
        for pp in range(TILE_PAGES):
            a = first + i * TILE_PAGES + pp
            if a > final:
                continue
            page = int(table[a])
            at = slice(pp * PAGE_SLOTS, pp * PAGE_SLOTS + ps)
            kt[at, :L] = ckv[page].float()
            kt[at, L:] = krope[page].float()
            if int8:
                cs[at] = cs_pages[page].float()
                rs[at] = rs_pages[page].float()
        key = (first + i * TILE_PAGES + col // PAGE_SLOTS) * ps + t
        if int8:
            s = cs * _mma(None, qt[:, :L], kt[:, :L].T) \
                + rs * _mma(None, qt[:, L:], kt[:, L:].T)
        else:
            s = _mma(None, qt, kt.T)
        s = s * SCALE
        masked = (t >= ps)[None, :] | (key[None, :] > qp[:, None]) \
            | (key >= n_keys)[None, :]
        s = s.masked_fill(masked, -INF)
        m_new = torch.maximum(m, s.amax(-1))
        live = m_new > -INF
        safe = torch.where(live, m_new, torch.zeros(()))
        p = torch.where(live[:, None], torch.exp(s - safe[:, None]),
                        torch.zeros(()))
        alpha = torch.where(m > -INF, torch.exp(m - safe), torch.zeros(()))
        l = l * alpha + _quad_sum(p)
        m = m_new
        pv = p * cs if int8 else p
        h1 = pv.bfloat16()
        h2 = (pv - h1.float()).bfloat16()
        o = _mma(_mma(o * alpha[:, None], h1, kt[:, :L]), h2, kt[:, :L])
    return m, l, o


def mla_model(q_eff, q_rope, ckv, krope, tables, pos, n_q, *,
              ckv_scale=None, krope_scale=None):
    """q_eff [B, Q, H, L], q_rope [B, Q, H, R] -> [B, Q, H, L] bf16, as K7
    (or, at Q = 1 and every query live, K5) computes it."""
    B, Q, H, _ = q_eff.shape
    ps, n_pages = ckv.shape[1], tables.shape[1]
    n_splits = -(-n_pages // MLA_SPLIT_PAGES)
    QH = Q * H
    out = torch.zeros(B, Q, H, L, dtype=torch.bfloat16)
    for b in range(B):
        q_all = torch.cat([q_eff[b].reshape(QH, L), q_rope[b].reshape(QH, R)],
                          -1).float()
        p_b, nq_b = int(pos[b]), int(n_q[b])
        ms = torch.full((n_splits, QH), -INF)
        ls = torch.zeros(n_splits, QH)
        os_ = torch.zeros(n_splits, QH, L)
        for r0 in range(0, QH, ROWS):
            rows = min(ROWS, QH - r0)
            j = (r0 + torch.arange(rows)) // H
            qp = torch.where(j < nq_b, p_b + j, torch.full((), -1))
            j_last = min((r0 + rows - 1) // H, nq_b - 1)
            last = p_b + j_last
            a_hi = -1 if j_last < r0 // H or last < 0 \
                else min(last // ps, n_pages - 1)
            for s in range(n_splits):
                first = s * MLA_SPLIT_PAGES
                final = min(a_hi, first + MLA_SPLIT_PAGES - 1)
                if first > final:
                    continue                         # an empty partial
                m, l, o = _split(q_all[r0:r0 + rows], qp, tables[b], ckv,
                                 krope, ckv_scale, krope_scale, first, final,
                                 ps, n_pages * ps)
                ms[s, r0:r0 + rows], ls[s, r0:r0 + rows] = m, l
                os_[s, r0:r0 + rows] = o
        m = torch.full((QH,), -INF)
        l = torch.zeros(QH)
        o = torch.zeros(QH, L)
        for s in range(n_splits):
            seen = ms[s] > -INF
            m_new = torch.maximum(m, ms[s])
            f_old = torch.where(torch.isfinite(m), torch.exp(m - m_new),
                                torch.zeros(()))
            f_s = torch.exp(ms[s] - m_new)
            l = torch.where(seen, _fma(l, f_old, ls[s] * f_s), l)
            o = torch.where(seen[:, None],
                            _fma(o, f_old[:, None], os_[s] * f_s[:, None]), o)
            m = torch.where(seen, m_new, m)
        out[b] = (o / torch.clamp(l, min=1e-20)[:, None]).bfloat16() \
            .reshape(Q, H, L)
    return out


def decode_model(q_eff, q_rope, ckv, krope, tables, pos, **kw):
    """K5: q_eff [B, H, L], q_rope [B, H, R], one live query a row."""
    ones = torch.ones(q_eff.shape[0], dtype=torch.int32)
    return mla_model(q_eff[:, None], q_rope[:, None], ckv, krope, tables, pos,
                     ones, **kw)[:, 0]


def _row_ulps(got, want):
    """Worst |got - want| over one bf16 ulp of the largest |want| in its
    row, never below 2^-14."""
    a = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7).clamp_min(2.0 ** -14)
    return ((got.float() - want.float()).abs() / ulp).max().item()


def _case(seed, H, ps, Q, int8, pos=None, n_q=None):
    """Latent pages over shuffled tables for requests at ``pos`` (default:
    a split's last key, the next split's first and second, a row across
    two splits and an idle row at 0 on the null page), ``n_q`` live
    queries (default 1..Q), Q queries a row, H heads.  Returns (q_eff,
    q_rope, ckv, krope, tables, pos, n_q, scale kwargs)."""
    rng = np.random.RandomState(seed)
    width = MLA_SPLIT_PAGES * ps                     # keys of a split
    pos = pos or [width - 1, width, width + 1, 2 * width + 5, 0]
    n_q = n_q or [1 + b % Q for b in range(len(pos))]
    lengths = [p + Q for p in pos]
    lengths[-1] = 0 if pos[-1] == 0 else lengths[-1]
    need = [-(-n // ps) for n in lengths]
    P = sum(need) + 2
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((len(pos), -(-(max(pos) + Q) // ps) + 1), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    ckv = torch.from_numpy(rng.randn(P, ps, L).astype(np.float32)).bfloat16()
    kr = torch.from_numpy(rng.randn(P, ps, R).astype(np.float32)).bfloat16()
    B = len(pos)
    q_eff = torch.from_numpy(rng.randn(B, Q, H, L).astype(np.float32)) \
        .bfloat16()
    q_rope = torch.from_numpy(rng.randn(B, Q, H, R).astype(np.float32)) \
        .bfloat16()
    kw = {}
    if int8:
        (ckv, kw["ckv_scale"]), (kr, kw["krope_scale"]) = \
            quantize_int8(ckv), quantize_int8(kr)
    return (q_eff, q_rope, ckv, kr, torch.from_numpy(tables),
            torch.tensor(pos, dtype=torch.int32),
            torch.tensor(n_q, dtype=torch.int32), kw)


CASES = [(8, 16, False), (8, 8, True), (16, 16, True), (16, 8, False),
         (128, 16, False), (128, 16, True), (128, 8, False)]


@pytest.mark.parametrize("H,ps,int8", CASES)
def test_decode_model_matches_plain_within_a_row_ulp(H, ps, int8):
    """K5's model: rows at a split's edges, across splits, and idle."""
    q, qr, c, r, t, pos, _, kw = _case(H * 10 + ps + int8, H, ps, 1, int8)
    got = decode_model(q[:, 0], qr[:, 0], c, r, t, pos, **kw)
    want = mla_paged_decode_plain(q[:, 0], qr[:, 0], c, r, t, pos,
                                  scale=SCALE, **kw)
    assert torch.isfinite(got.float()).all()
    assert _row_ulps(got, want) <= 1.0


@pytest.mark.parametrize("H,ps,int8", CASES)
def test_verify_model_matches_plain_within_a_row_ulp(H, ps, int8):
    """K7's model at Q = 3, live queries 1..3: dead rows exact zeros; at
    H = 8 and 16 a tile holds several tokens' rows."""
    Q = 3
    q, qr, c, r, t, pos, n_q, kw = _case(H + ps + int8, H, ps, Q, int8)
    got = mla_model(q, qr, c, r, t, pos, n_q, **kw)
    want = mla_paged_verify_plain(q, qr, c, r, t, pos, n_q, scale=SCALE,
                                  **kw)
    assert torch.isfinite(got.float()).all()
    assert _row_ulps(got, want) <= 1.0
    dead = torch.arange(Q)[None, :] >= n_q[:, None]
    assert (got[dead] == 0).all()


@pytest.mark.parametrize("kernel,H,ps,int8", [
    ("K5", 16, 16, False), ("K5", 8, 8, True), ("K7", 8, 16, True),
    ("K7", 16, 8, False)])
def test_model_matches_the_pallas_kernel_within_a_row_ulp(kernel, H, ps,
                                                          int8):
    """The model and the TPU kernel in interpret mode on the same inputs."""
    Q = 1 if kernel == "K5" else 3
    q, qr, c, r, t, pos, n_q, kw = _case(7 + H + ps, H, ps, Q, int8)
    j = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
         for k, v in kw.items()}
    jc, jr = (jnp.asarray(x.numpy()) if int8 else
              jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (c, r))
    jt, jp = jnp.asarray(t.numpy()), jnp.asarray(pos.numpy())
    if kernel == "K5":
        got = decode_model(q[:, 0], qr[:, 0], c, r, t, pos, **kw)
        ref = mla_paged_decode_fwd(
            jnp.asarray(q[:, 0].float().numpy(), jnp.bfloat16),
            jnp.asarray(qr[:, 0].float().numpy(), jnp.bfloat16), jc, jr, jt,
            jp, scale=SCALE, interpret=True, **j)
    else:
        got = mla_model(q, qr, c, r, t, pos, n_q, **kw)
        ref = mla_paged_verify_fwd(
            jnp.asarray(q.float().numpy(), jnp.bfloat16),
            jnp.asarray(qr.float().numpy(), jnp.bfloat16), jc, jr, jt, jp,
            jnp.asarray(n_q.numpy()), scale=SCALE, interpret=True, **j)
    want = torch.from_numpy(np.asarray(ref, np.float32))
    assert _row_ulps(got, want) <= 1.0


@pytest.mark.parametrize("H,ps,int8", [CASES[0], CASES[1], CASES[5]])
def test_model_verify_at_one_query_is_decode_bit_for_bit(H, ps, int8):
    q, qr, c, r, t, pos, _, kw = _case(H + 3 * ps, H, ps, 5, int8)
    one = mla_model(q, qr, c, r, t, pos, torch.ones_like(pos), **kw)[:, 0]
    assert torch.equal(one, decode_model(q[:, 0], qr[:, 0], c, r, t, pos,
                                         **kw))


@pytest.mark.parametrize("H,ps,int8", [CASES[1], CASES[2], CASES[4]])
def test_model_verify_rows_equal_decode_at_pos_plus_j(H, ps, int8):
    """Every verify row j at Q = 4 equals the decode row at pos + j, for
    rows whose queries straddle a split's edge."""
    Q = 4
    width = MLA_SPLIT_PAGES * ps
    q, qr, c, r, t, pos, _, kw = _case(
        H + ps + 11, H, ps, Q, int8, pos=[width - 2, width + 3, 5, 0],
        n_q=[Q, Q, Q, 1])
    ver = mla_model(q, qr, c, r, t, pos, torch.full_like(pos, Q), **kw)
    for j in range(Q):
        dec = decode_model(q[:, j], qr[:, j], c, r, t, pos + j, **kw)
        assert torch.equal(ver[:3, j], dec[:3])


@pytest.mark.parametrize("kernel", ["K5", "K7"])
@pytest.mark.parametrize("int8", [False, True])
def test_model_request_alone_equals_its_rows_in_the_batch(kernel, int8):
    H, ps = (16, 8) if kernel == "K7" else (128, 16)
    Q = 3 if kernel == "K7" else 1
    q, qr, c, r, t, pos, n_q, kw = _case(31 + int8, H, ps, Q, int8)
    full = mla_model(q, qr, c, r, t, pos, n_q, **kw)
    for b in range(q.shape[0]):
        one = slice(b, b + 1)
        assert torch.equal(mla_model(q[one], qr[one], c, r, t[one], pos[one],
                                     n_q[one], **kw), full[one])
