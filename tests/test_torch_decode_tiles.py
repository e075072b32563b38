"""K1's and K3's arithmetic on the CPU: a model of the Hopper kernels'
order and rounding (``csrc/paged_attention.cuh``) held to
``paged_decode_plain`` and ``paged_verify_plain``.

The model, written here and nowhere in the package, computes what the
kernels compute, in their order, for every (request, KV head, row block):

* rows are (query token, group head) pairs, token-major, at most 16 a
  block for K1 and 48 for K3 (split by query token);
* a row's keys are split at 16 absolute pages (256 key slots at 16-token
  pages, each page padded to 16 slots): the block sweeps the absolute
  pages a_lo..a_hi of its last live query (page a at table slot a, or a
  mod n_pages in a ring), split ``x`` being group x (causal) or a_lo // 16
  + x (ring), one more split than the table's groups in a ring;
* scores are exact k16 sums of bf16 products, one fp32 rounding each
  step (the tensor cores' mma), the K scale (int8) and then the scale
  applied to the fp32 dot, then the logit cap (``softcap > 0``: s =
  softcap * tanh(s / softcap)), then the mask (causal or the ring rule),
  which replaces the capped score;
* each split's softmax at once with the TPU kernel's guards: m the max, p
  = exp(s - m) (0 where no slot is seen), l = sum p taken as the kernel's
  lanes take it (lane i sums slots i, i + 32, ... in order, then an xor
  shuffle tree);
* p' = p (int8: p * vs) split into bf16 terms h1 = bf16(p'), h2 = bf16(p'
  - h1); PV one page a k16 step, h1 then h2, each step's 16 products
  summed exactly and added to the fp32 accumulator;
* the partials merged in increasing split order with the guarded rescale
  (empty ones skipped), one bf16 cast after acc / max(l, 1e-20).

Bounds: each output element within one bf16 ulp of the largest |plain|
in its row, never below 2^-14 (the bound ``chip_smoke.py`` holds the
kernels to on the card).  Bit for bit, in the model: K3 at one live query
equals K1; a verify row j equals decode at pos + j; a ring of n pages and
one of n + 1 holding the same window give the same rows; a request's rows
alone equal its rows in the batch; with a cap too (queries scaled so
the scores reach it).  Inputs are drawn from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_plain, paged_verify_plain)
from repro_torch.kernels.paged_attention.ops import SPLIT_PAGES  # noqa: E402
from repro_torch.models.attention import quantize_int8  # noqa: E402

SLOTS = 16                      # key slots a page (one k16 step)
INF = float("inf")


from _torch_common import one_thread  # noqa: E402, F401


def _lane_sum(p):
    """[rows, 256] fp32 -> [rows]: lane i sums slots i, i + 32, ... in
    order, then the xor shuffle tree 16, 8, 4, 2, 1."""
    lanes = p[:, 0:32].clone()
    for x in range(1, p.shape[1] // 32):
        lanes = lanes + p[:, 32 * x:32 * x + 32]
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ off]
    return lanes[:, 0]


def _fma(x, y, z):
    """fp32 fmaf: x * y + z rounded once (x * y is exact in fp64)."""
    return (x.double() * y.double() + z.double()).float()


def _visible(idx, qp, window, ring):
    if window == 0:
        return idx <= qp
    k_abs = qp - torch.remainder(torch.remainder(qp, ring) - idx, ring)
    return (k_abs >= 0) & (k_abs > qp - window)


def paged_model(q, k_pages, v_pages, tables, pos, n_q, *, scale, window=0,
                softcap=0.0, k_scale=None, v_scale=None, max_rows=48):
    """q [B, Q, H, D] -> [B, Q, H, D] bf16, as K3 (``max_rows=48``) or, at
    Q = 1 and ``max_rows=16``, K1 computes it."""
    B, Q, H, D = q.shape
    _, ps, K, _ = k_pages.shape
    G = H // K
    n_pages = tables.shape[1]
    ring = n_pages * ps
    qpb = max_rows // G
    n_splits = -(-n_pages // SPLIT_PAGES) + (1 if window else 0)
    int8 = k_scale is not None
    out = torch.zeros(B, Q, H, D, dtype=torch.bfloat16)
    for b in range(B):
        p_b, nq_b = int(pos[b]), int(n_q[b])
        for kh in range(K):
            for j0 in range(0, Q, qpb):
                rows = min(qpb, Q - j0) * G
                r = torch.arange(rows)
                j = j0 + r // G
                live = j < nq_b
                qp = p_b + j
                qr = q[b, j, kh * G + r % G].double()          # [rows, D]
                j_last = min(j0 + rows // G, nq_b) - 1
                last = p_b + j_last
                a_hi = -1 if (j_last < j0 or last < 0) else last // ps
                if window == 0:
                    a_hi = min(a_hi, n_pages - 1)
                a_lo = max(0, a_hi - n_pages + 1)
                m = torch.full((rows,), -INF)
                l = torch.zeros(rows)
                acc = torch.zeros(rows, D)
                for split in range(n_splits):
                    group = (a_lo // SPLIT_PAGES if window else 0) + split
                    first = max(a_lo, group * SPLIT_PAGES)
                    final = min(a_hi, group * SPLIT_PAGES + SPLIT_PAGES - 1)
                    if first > final:
                        continue                     # an empty partial
                    ms, ls, accs = _split(
                        qr, live, qp, k_pages, v_pages, k_scale, v_scale,
                        tables[b], kh, group, first, final, ps, n_pages,
                        window, ring, scale, softcap, int8)
                    seen = ms > -INF
                    m_new = torch.maximum(m, ms)
                    f_old = torch.where(torch.isfinite(m),
                                        torch.exp(m - m_new),
                                        torch.zeros(()))
                    f_s = torch.exp(ms - m_new)
                    l = torch.where(seen, _fma(l, f_old, ls * f_s), l)
                    acc = torch.where(seen[:, None],
                                      _fma(acc, f_old[:, None],
                                           accs * f_s[:, None]), acc)
                    m = torch.where(seen, m_new, m)
                o = (acc / torch.clamp(l, min=1e-20)[:, None]).bfloat16()
                out[b, j, kh * G + r % G] = o
    return out


def _split(qr, live, qp, k_pages, v_pages, k_scale, v_scale, table, kh,
           group, first, final, ps, n_pages, window, ring, scale, softcap,
           int8):
    """One block's partial (m, l, acc) over absolute pages first..final of
    split ``group``."""
    rows, D = qr.shape
    n = SPLIT_PAGES * SLOTS
    kt = torch.zeros(n, D, dtype=torch.float64)
    vt = torch.zeros(n, D, dtype=torch.float64)
    ks = torch.zeros(n)
    vs = torch.zeros(n)
    idx = torch.full((n,), -1, dtype=torch.long)
    for a in range(first, final + 1):
        po = a - group * SPLIT_PAGES
        i = a if window == 0 else a % n_pages
        page = int(table[i])
        at = slice(po * SLOTS, po * SLOTS + ps)
        kt[at] = k_pages[page, :, kh].double()
        vt[at] = v_pages[page, :, kh].double()
        if int8:
            ks[at] = k_scale[page, :, kh].float()
            vs[at] = v_scale[page, :, kh].float()
        idx[at] = i * ps + torch.arange(ps)
    # exact k16 sums of the products, one fp32 rounding a step
    prod = torch.einsum("rcd,scd->rsc", qr.reshape(rows, D // 16, 16),
                        kt.reshape(n, D // 16, 16))
    s = torch.zeros(rows, n)
    for c in range(D // 16):
        s = (s.double() + prod[..., c]).float()
    if int8:
        s = s * ks
    s = s * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    ok = live[:, None] & (idx[None, :] >= 0) \
        & _visible(idx[None, :], qp[:, None], window, ring)
    s = torch.where(ok, s, torch.full((), -INF))
    m = s.amax(-1)
    fin = torch.isfinite(m)
    safe = torch.where(fin, m, torch.zeros(()))
    p = torch.where(fin[:, None], torch.exp(s - safe[:, None]),
                    torch.zeros(()))
    l = _lane_sum(p)
    pv = p * vs if int8 else p
    h1 = pv.bfloat16()
    h2 = (pv - h1.float()).bfloat16()
    acc = torch.zeros(rows, D)
    for a in range(first, final + 1):
        at = slice((a - group * SPLIT_PAGES) * SLOTS,
                   (a - group * SPLIT_PAGES + 1) * SLOTS)
        for h in (h1, h2):
            acc = (acc.double() + h[:, at].double() @ vt[at]).float()
    return torch.where(fin, m, torch.full((), -INF)), l, acc


def decode_model(q, k_pages, v_pages, tables, pos, **kw):
    """K1: q [B, H, D], one live query a row, 16 rows a block."""
    ones = torch.ones(q.shape[0], dtype=torch.int32)
    return paged_model(q[:, None], k_pages, v_pages, tables, pos, ones,
                       max_rows=16, **kw)[:, 0]


def _within_one_ulp(got, want):
    """Worst |got - want| over one bf16 ulp of the largest |want| in its
    row, never below 2^-14."""
    a = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7).clamp_min(2.0 ** -14)
    return ((got.float() - want.float()).abs() / ulp).max().item()


def _pool(rng, lengths, ps, K, D, width):
    need = [-(-n // ps) for n in lengths]
    P = sum(need) + 2
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((len(lengths), width), np.int32)
    at = 0
    for b, n_ in enumerate(need):
        tables[b, :n_] = perm[at:at + n_]
        at += n_
    k = torch.from_numpy(rng.randn(P, ps, K, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(P, ps, K, D).astype(np.float32))
    return k.bfloat16(), v.bfloat16(), torch.from_numpy(tables)


def _ring(rng, B, n_ring, ps, K, D):
    P = B * n_ring + 1
    tables = (rng.permutation(P - 1) + 1).reshape(B, n_ring).astype(np.int32)
    k = torch.from_numpy(rng.randn(P, ps, K, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(P, ps, K, D).astype(np.float32))
    return k.bfloat16(), v.bfloat16(), torch.from_numpy(tables)


def _int8(k, v, kw):
    (k8, kw["k_scale"]), (v8, kw["v_scale"]) = quantize_int8(k), \
        quantize_int8(v)
    return k8, v8


def _case(seed, G, D, Q, int8, window, softcap=0.0, gain=1.0):
    """B = 3 requests over K = 2 KV heads: causal at positions 255, 256
    (a split's last key and the next split's first) and 300 (two splits);
    ring (window 64 over 6 pages) at 37, 95 (the ring's last slot) and 330
    (wrapped).  Live queries 1..Q; ``softcap`` with queries times
    ``gain``."""
    rng = np.random.RandomState(seed)
    ps, K = 16, 2
    if window:
        pos = [37, 95, 330]
        k, v, t = _ring(rng, 3, 6, ps, K, D)
    else:
        pos = [255, 256, 300]
        k, v, t = _pool(rng, [p + Q for p in pos], ps, K, D, 24)
    n_q = [min(Q, 2), 1, Q]
    q = torch.from_numpy(rng.randn(3, Q, K * G, D).astype(np.float32)
                         * gain).bfloat16()
    kw = dict(scale=D ** -0.5, window=window)
    if softcap:
        kw["softcap"] = softcap
    if int8:
        k, v = _int8(k, v, kw)
    return q, k, v, t, torch.tensor(pos, dtype=torch.int32), \
        torch.tensor(n_q, dtype=torch.int32), kw


CASES = [(2, 32, 1, False, 0), (7, 64, 5, False, 0), (7, 64, 5, True, 0),
         (12, 128, 5, False, 0), (9, 128, 3, True, 64), (2, 64, 4, False, 64),
         (12, 32, 5, True, 64), (5, 128, 2, True, 0)]


@pytest.mark.parametrize("G,D,Q,int8,window", CASES)
def test_model_matches_plain_within_a_row_ulp(G, D, Q, int8, window):
    """K3's and K1's model against their plain versions: ragged live
    queries, dead rows exact zeros, positions across a split boundary; at
    G = 12 and Q = 5 K3's 60 rows go to two row blocks."""
    q, k, v, t, pos, n_q, kw = _case(G * D + Q, G, D, Q, int8, window)
    got = paged_model(q, k, v, t, pos, n_q, **kw)
    want = paged_verify_plain(q, k, v, t, pos, n_q, **kw)
    assert torch.isfinite(got.float()).all()
    assert _within_one_ulp(got, want) <= 1.0
    dead = torch.arange(q.shape[1])[None, :] >= n_q[:, None]
    assert (got[dead] == 0).all()
    dec = decode_model(q[:, 0].contiguous(), k, v, t, pos, **kw)
    assert _within_one_ulp(dec, paged_decode_plain(q[:, 0].contiguous(), k,
                                                   v, t, pos, **kw)) <= 1.0


@pytest.mark.parametrize("G,D,Q,int8,window", CASES[1:6])
def test_model_verify_at_one_query_is_decode_bit_for_bit(G, D, Q, int8,
                                                         window):
    q, k, v, t, pos, _, kw = _case(G + D + Q, G, D, Q, int8, window)
    one = paged_model(q, k, v, t, pos, torch.ones_like(pos), **kw)[:, 0]
    assert torch.equal(one, decode_model(q[:, 0].contiguous(), k, v, t, pos,
                                         **kw))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [0, 64])
def test_model_verify_rows_equal_decode_at_pos_plus_j(int8, window):
    """Every live verify row j equals the decode row at pos + j on the
    same pool (after the verify's K/V writes).  The ring carries the
    speculative pool's slack page, as in serving."""
    rng = np.random.RandomState(11 + int8)
    ps, K, G, D, Q = 16, 2, 7, 64, 5
    pos = [251, 250, 330]
    if window:
        k, v, t = _ring(rng, 3, 6 + 1, ps, K, D)
    else:
        k, v, t = _pool(rng, [p + Q for p in pos], ps, K, D, 24)
    q = torch.from_numpy(rng.randn(3, Q, K * G, D).astype(np.float32)) \
        .bfloat16()
    kw = dict(scale=D ** -0.5, window=window)
    if int8:
        k, v = _int8(k, v, kw)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    n_q = torch.tensor([5, 3, 4], dtype=torch.int32)
    ver = paged_model(q, k, v, t, pos_t, n_q, **kw)
    for j in range(Q):
        dec = decode_model(q[:, j].contiguous(), k, v, t, pos_t + j, **kw)
        for b in range(3):
            if j < int(n_q[b]):
                assert torch.equal(ver[b, j], dec[b])


def _ring_pages(hist, tables, ps, upto):
    """Pages holding, in each row's ring, the newest n * ps positions up to
    ``upto[b]`` of ``hist[b]`` at slot ``a mod (n * ps)``."""
    B, n = tables.shape
    pages = hist.new_zeros((int(tables.max()) + 1, ps) + hist.shape[2:])
    for b in range(B):
        a = torch.arange(max(0, upto[b] - n * ps + 1), upto[b] + 1)
        slot = a % (n * ps)
        pages[tables[b, slot // ps].long(), slot % ps] = hist[b, a]
    return pages


@pytest.mark.parametrize("kernel", ["K1", "K3"])
@pytest.mark.parametrize("int8", [False, True])
def test_model_rings_of_n_and_n_plus_1_pages_agree(kernel, int8):
    """One window of K/V (window 128, ps 16) in a ring of 9 pages and in
    one of 10, at positions past the wrap: split 0 of the longer ring can
    hold only the page no row sees, so the rows are equal bit for bit."""
    rng = np.random.RandomState(5 + int8)
    K, G, D, ps, window, Q = 2, 3, 32, 16, 128, 5
    n0 = window // ps + 1
    pos = [200, 145, 177, 300, 263]
    live = [1, 3, 5, 2, 4] if kernel == "K3" else [1] * 5
    upto = [p + live[b] - 1 for b, p in enumerate(pos)]
    hk = torch.from_numpy(rng.randn(5, max(upto) + 1, K, D)
                          .astype(np.float32)).bfloat16()
    hv = torch.from_numpy(rng.randn(5, max(upto) + 1, K, D)
                          .astype(np.float32)).bfloat16()
    q = torch.from_numpy(rng.randn(5, Q, K * G, D).astype(np.float32)) \
        .bfloat16()
    pos_t = torch.tensor(pos, dtype=torch.int32)
    outs = []
    for n in (n0, n0 + 1):
        t = torch.from_numpy((rng.permutation(5 * n) + 1).reshape(5, n)
                             .astype(np.int32))
        k, v = _ring_pages(hk, t, ps, upto), _ring_pages(hv, t, ps, upto)
        kw = dict(scale=D ** -0.5, window=window)
        if int8:
            k, v = _int8(k, v, kw)
        if kernel == "K1":
            outs.append(decode_model(q[:, 0].contiguous(), k, v, t, pos_t,
                                     **kw))
        else:
            outs.append(paged_model(q, k, v, t, pos_t,
                                    torch.tensor(live, dtype=torch.int32),
                                    **kw))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("G,D,Q,int8,window", [CASES[1], CASES[4]])
def test_model_row_alone_equals_row_in_batch(G, D, Q, int8, window):
    q, k, v, t, pos, n_q, kw = _case(3 * G + D, G, D, Q, int8, window)
    full = paged_model(q, k, v, t, pos, n_q, **kw)
    dec = decode_model(q[:, 0].contiguous(), k, v, t, pos, **kw)
    for b in range(q.shape[0]):
        one = slice(b, b + 1)
        assert torch.equal(paged_model(q[one], k, v, t[one], pos[one],
                                       n_q[one], **kw), full[one])
        assert torch.equal(decode_model(q[one, 0].contiguous(), k, v,
                                        t[one], pos[one], **kw), dec[one])


# (G, D, Q, int8, window, query gain) at softcap 30: gain 16 takes the
# largest scores to about the cap, 64 to several times it
CAP_CASES = [(7, 64, 5, False, 0, 16.0), (7, 64, 5, True, 0, 64.0),
             (9, 128, 3, False, 64, 64.0), (12, 32, 5, True, 64, 16.0)]


@pytest.mark.parametrize("G,D,Q,int8,window,gain", CAP_CASES)
def test_capped_model_matches_plain_and_decode(G, D, Q, int8, window, gain):
    """The cap at the model's point of the kernels' order (after the
    scale, before the mask): K3's and K1's model within a row ulp of the
    capped plain versions and apart from the uncapped ones; K3 at one live
    query equals K1 bit for bit."""
    q, k, v, t, pos, n_q, kw = _case(G * D + Q + 1, G, D, Q, int8, window,
                                     softcap=30.0, gain=gain)
    got = paged_model(q, k, v, t, pos, n_q, **kw)
    want = paged_verify_plain(q, k, v, t, pos, n_q, **kw)
    assert _within_one_ulp(got, want) <= 1.0
    free = {x: y for x, y in kw.items() if x != "softcap"}
    assert _within_one_ulp(paged_verify_plain(q, k, v, t, pos, n_q, **free),
                           want) > 1.0
    dec = decode_model(q[:, 0].contiguous(), k, v, t, pos, **kw)
    assert _within_one_ulp(dec, paged_decode_plain(q[:, 0].contiguous(), k,
                                                   v, t, pos, **kw)) <= 1.0
    one = paged_model(q, k, v, t, pos, torch.ones_like(pos), **kw)[:, 0]
    assert torch.equal(one, dec)
