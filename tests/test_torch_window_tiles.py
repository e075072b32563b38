"""K4's arithmetic on the CPU: a model of the Hopper kernel's order and
rounding (``csrc/windowed_ragged_prefill.cu``) held to
``windowed_prefill_plain``.

The model, written here and nowhere in the package, computes what the
kernel computes, in its order, for every (request, KV head, 64-row query
tile):

* rows are (token, group head) pairs, token-major; a tile whose first
  token is at or past n_live is all zeros;
* keys come in 64-slot tiles from two sources, ring tiles then fresh
  tiles.  Ring tile r holds absolute pages [r ppt, (r + 1) ppt), ppt = 64
  // ps, page a read from slot-page a % n_ring; only pages a in [a_lo,
  a_hi] are staged (a_hi = (start - 1) // ps, a_lo = max(0, a_hi - n_ring
  + 1)), every other slot is zero-filled; a staged slot's position is the
  TPU kernel's formula on its slot index.  Fresh tile f holds chunk tokens
  [64 f, 64 f + 64), zeros at or past n_live;
* tiles no live row of the query tile sees are skipped (ring pages older
  than the first token's window, fresh tiles past the last live token);
  a tile is masked element by element (-1e30 unless the key's position
  is in (q_abs - window, q_abs]) only where it crosses an edge;
* scores are fp32 dot products times the scale after the dot; int8 ring
  keys take the factored key scale, (q . k8) * ks * scale, fresh keys ks =
  1; then the logit cap (``softcap > 0``: s = softcap * tanh(s /
  softcap)) on ring and fresh keys alike, before the mask, in the one
  score routine both sweeps run;
* sweep 1 keeps the row max m and rescales only the normalizer, l * exp(m
  - m_new) + sum exp(s - m_new), each tile's sum taken as the kernel's
  threads take it (each of a row's 4 threads sums its 16 columns in order,
  then (t0 + t1) + (t2 + t3)); a tile that leaves m at -1e30 changes
  nothing;
* sweep 2 forms p = exp(s - m) / l at the true max, rounded to bf16 for
  bf16 rings; for int8 rings p' = p * vs (vs = 1 for fresh keys) split
  into two bf16 terms h1 = bf16(p'), h2 = bf16(p' - h1); every 16 keys'
  products are summed and added to the fp32 accumulator (the tensor
  cores' k16 step), h1's four steps before h2's;
* one bf16 cast at the output.

Bounds: each output element within one bf16 ulp of the largest |plain|
in its row (one head of one token), never below 2^-14 -- the bound
``chip_smoke.py`` holds the kernel to on the card; padding rows exact
zeros; a window held in an n-page and an (n + 1)-page ring gives the same
bits, with a cap too.  Inputs are drawn from a seed with numpy.  The sums of a row's quad
and of PV's k16 steps, and the row-ulp bound, are K2's model's
(``test_torch_prefill_tiles.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ragged_prefill import windowed_prefill_plain  # noqa: E402
from repro_torch.models.attention import quantize_int8  # noqa: E402
from repro_torch.models.cache_spec import window_pages  # noqa: E402
from test_torch_prefill_tiles import (_pv, _quad_sum,  # noqa: E402
                                      _within_one_ulp as _row_ulps)

SLOTS = 64                 # key slots a tile (csrc kSlots)
MASK = -1e30
NO_KEY = -2 ** 31          # a zero-filled slot's position (csrc kNoKey)


from _torch_common import one_thread  # noqa: E402, F401


def k4_model(q, k_new, v_new, k_pages, v_pages, tables, start, n_live, *,
             window, scale, softcap=0.0, k_scale=None, v_scale=None,
             stage_below_lo=False):
    """K4 in the kernel's order.  ``stage_below_lo`` stages a ring tile's
    pages below a_lo too (a broken variant the tests show is wrong)."""
    B, T, H, D = q.shape
    _, ps, K, _ = k_pages.shape
    G = H // K
    n_ring = tables.shape[1]
    ring = n_ring * ps
    ppt = SLOTS // ps
    kt = ppt * ps
    int8 = k_scale is not None
    out = torch.zeros_like(q)
    for b in range(B):
        st, nl = int(start[b]), min(int(n_live[b]), T)
        last = st - 1
        a_hi = last // ps if last >= 0 else -1
        a_lo = max(0, a_hi - n_ring + 1)

        def ring_tile(r, kh):
            """(K, V, ks, vs, positions) of ring tile r."""
            pos = torch.full((SLOTS,), NO_KEY, dtype=torch.int64)
            kv = [torch.zeros(SLOTS, D) for _ in range(2)]
            sc = [torch.zeros(SLOTS) for _ in range(2)]
            for col in range(kt):
                a = r * ppt + col // ps
                if a > a_hi or (a < a_lo and not stage_below_lo):
                    continue
                sp, j = a % n_ring, col % ps
                k_abs = last - ((last % ring - (sp * ps + j)) % ring)
                pos[col] = k_abs if k_abs >= 0 else NO_KEY
                page = int(tables[b, sp])
                for x, pages, scales in ((0, k_pages, k_scale),
                                         (1, v_pages, v_scale)):
                    kv[x][col] = pages[page, j, kh].float()
                    if int8:
                        sc[x][col] = scales[page, j, kh].float()
            return kv[0], kv[1], sc[0], sc[1], pos

        def fresh_tile(f, kh):
            f_idx = f + torch.arange(SLOTS)
            live = f_idx < nl
            kv = [torch.zeros(SLOTS, D) for _ in range(2)]
            for x, src in ((0, k_new), (1, v_new)):
                kv[x][live] = src[b, f_idx[live], kh].float()
            pos = torch.where(live, st + f_idx,
                              torch.tensor(NO_KEY, dtype=torch.int64))
            return kv[0], kv[1], torch.ones(SLOTS), torch.ones(SLOTS), pos

        for kh in range(K):
            for tile in range(-(-T * G // SLOTS)):
                t_first = tile * SLOTS // G
                if t_first >= nl:
                    continue                      # zeros
                rows = tile * SLOTS + torch.arange(SLOTS)
                valid = rows < T * G
                t = rows // G
                qt = torch.zeros(SLOTS, D)
                qt[valid] = q[b, t[valid], kh * G + rows[valid] % G].float()
                q_abs = (st + t)[:, None]
                row_last = min(tile * SLOTS + SLOTS, T * G) - 1
                t_last = min(row_last // G, nl - 1)
                q_last = st + t_last
                lo_key = st + t_first - window + 1
                tiles = []
                p_lo = max(a_lo, max(lo_key, 0) // ps)
                if p_lo <= a_hi:
                    for r in range(p_lo // ppt, a_hi // ppt + 1):
                        a0 = r * ppt
                        masked = kt < SLOTS or a0 < a_lo or a0 + ppt > a_hi \
                            or a0 * ps <= q_last - window
                        tiles.append((ring_tile(r, kh), masked))
                for f in range(max(lo_key - st, 0) // SLOTS * SLOTS,
                               t_last + 1, SLOTS):
                    masked = f + SLOTS - 1 > t_first or f + SLOTS > nl \
                        or st + f <= q_last - window
                    tiles.append((fresh_tile(f, kh), masked))

                def scores(tl, masked):
                    kv, _, ks, _, pos = tl
                    s = (qt.double() @ kv.double().T).float()
                    if int8:
                        s = s * ks
                    s = s * scale
                    if softcap:
                        s = softcap * torch.tanh(s / softcap)
                    if masked:
                        ok = (pos <= q_abs) & (pos > q_abs - window)
                        s = torch.where(ok, s, torch.tensor(MASK))
                    return s

                m = torch.full((SLOTS,), MASK)
                l = torch.zeros(SLOTS)
                for tl, masked in tiles:
                    s = scores(tl, masked)
                    m_new = torch.maximum(m, s.amax(-1))
                    e = torch.exp(s - m_new[:, None])
                    upd = m_new != MASK
                    l = torch.where(upd, l * torch.exp(m - m_new)
                                    + _quad_sum(e), l)
                    m = torch.where(upd, m_new, m)
                o = torch.zeros(SLOTS, D)
                for tl, masked in tiles:
                    p = torch.exp(scores(tl, masked) - m[:, None]) / l[:, None]
                    vt, vs = tl[1], tl[3]
                    if int8:
                        p = p * vs
                        h1 = p.bfloat16()
                        h2 = (p - h1.float()).bfloat16()
                        o = _pv(_pv(o, h1, vt), h2, vt)
                    else:
                        o = _pv(o, p.bfloat16(), vt)
                keep = valid & (t < nl)
                out[b, t[keep], kh * G + rows[keep] % G] = o[keep].bfloat16()
    return out


def _bf16(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()


def _inputs(seed, T, K, G, D, ps, window, starts, n_live, int8, softcap=0.0,
            gain=1.0):
    """Random ring pages (one slack page: the speculative pool's ring),
    chunk queries and fresh K/V."""
    rng = np.random.RandomState(seed)
    B = len(starts)
    n_ring = window_pages(window, ps) + 1
    P = B * n_ring + 1
    tables = torch.from_numpy((rng.permutation(P - 1) + 1)
                              .reshape(B, n_ring).astype(np.int32))
    k, v = _bf16(rng, P, ps, K, D), _bf16(rng, P, ps, K, D)
    q = (_bf16(rng, B, T, K * G, D).float() * gain).bfloat16()
    kn, vn = _bf16(rng, B, T, K, D), _bf16(rng, B, T, K, D)
    kw = dict(scale=D ** -0.5, window=window)
    if softcap:
        kw["softcap"] = softcap
    if int8:
        (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_int8(k), \
            quantize_int8(v)
    return (q, kn, vn, k, v, tables, torch.tensor(starts, dtype=torch.int32),
            torch.tensor(n_live, dtype=torch.int32)), kw


@pytest.mark.parametrize("G,D,ps,window,T,int8", [
    (9, 128, 16, 64, 48, False), (9, 128, 16, 64, 48, True),
    (12, 64, 16, 32, 48, False), (12, 64, 16, 32, 48, True),
    (3, 32, 8, 100, 40, True), (2, 64, 24, 64, 48, False),
    (7, 128, 32, 48, 70, True)])
def test_model_matches_plain_within_a_row_ulp(G, D, ps, window, T, int8):
    """Chunks at start 0 (empty ring), inside the first window, on a page
    edge of a wrapped ring that is no multiple of 64, and mid-page past
    the wrap; windows shorter than the chunk (32, 48) put the window's
    edge among the fresh keys; G = 9 and 12 straddle 64-row tiles; the
    third chunk's rows past n_live are padding."""
    starts = [0, 40, 13 * ps, 333]
    args, kw = _inputs(G * 100 + D + ps + window, T, 2, G, D, ps, window,
                       starts, [T, T, 21, T], int8)
    got = k4_model(*args, **kw)
    want = windowed_prefill_plain(*args, **kw)
    assert torch.isfinite(got.float()).all()
    assert _row_ulps(got, want) <= 1.0
    assert (got[2, 21:] == 0).all() and (want[2, 21:] == 0).all()


def _ring_pages(hist, tables, ps, upto):
    """Pages holding, in each row's ring of ``tables`` [B, n], the newest
    n * ps positions up to ``upto[b]`` of ``hist[b]`` [B, N, K, D]:
    position a at slot a mod (n * ps), as the engine writes it."""
    B, n = tables.shape
    ring = n * ps
    pages = torch.zeros((B * n + 1, ps) + tuple(hist.shape[2:]),
                        dtype=hist.dtype)
    for b in range(B):
        a = torch.arange(max(0, upto[b] - ring + 1), upto[b] + 1)
        slot = a % ring
        pages[tables[b, slot // ps].long(), slot % ps] = hist[b, a]
    return pages


@pytest.mark.parametrize("int8", [False, True])
def test_model_equal_across_ring_lengths(int8):
    """One window of K/V (window 100, 16-token pages) in an 8-page and a
    9-page ring, a chunk at start 332: a_lo is 13 in the 8-page ring (13
    mod 4 != 0), so the first anchored ring tile, pages 12..15, straddles
    it.  The model gives the same bits on both rings, within a row ulp of
    the plain version; staging page 12 too would read slot-page 4, which
    holds page 20, and count its keys twice."""
    rng = np.random.RandomState(11 + int8)
    K, G, D, ps, window, T, st = 2, 3, 64, 16, 100, 40, 332
    n0 = window_pages(window, ps)
    assert n0 == 8 and (st - 1) // ps - n0 + 1 == 13
    hk, hv = _bf16(rng, 1, st, K, D), _bf16(rng, 1, st, K, D)
    q = _bf16(rng, 1, T, K * G, D)
    kn, vn = _bf16(rng, 1, T, K, D), _bf16(rng, 1, T, K, D)
    start = torch.tensor([st], dtype=torch.int32)
    live = torch.tensor([T], dtype=torch.int32)
    outs, plain = [], []
    for n in (n0, n0 + 1):
        tables = torch.from_numpy(
            (rng.permutation(n) + 1).reshape(1, n).astype(np.int32))
        k, v = (_ring_pages(h, tables, ps, [st - 1]) for h in (hk, hv))
        kw = dict(scale=D ** -0.5, window=window)
        if int8:
            (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_int8(k), \
                quantize_int8(v)
        args = (q, kn, vn, k, v, tables, start, live)
        outs.append(k4_model(*args, **kw))
        plain.append(windowed_prefill_plain(*args, **kw))
        if n == n0:
            wrong = k4_model(*args, stage_below_lo=True, **kw)
    assert torch.equal(outs[0], outs[1])
    assert _row_ulps(outs[0], plain[0]) <= 1.0
    assert _row_ulps(outs[1], plain[1]) <= 1.0
    assert _row_ulps(wrong, plain[0]) > 1.0


@pytest.mark.parametrize("G,D,ps,window,T,int8,gain", [
    (9, 128, 16, 64, 48, False, 16.0), (9, 128, 16, 64, 48, True, 64.0),
    (12, 64, 16, 32, 48, True, 16.0), (3, 32, 8, 100, 40, False, 64.0)])
def test_capped_model_matches_plain_within_a_row_ulp(G, D, ps, window, T,
                                                     int8, gain):
    """At softcap 30 (queries scaled so the scores reach the cap, gain 16,
    or several times it, 64) on ring and fresh keys: the model within a row
    ulp of the capped plain version and apart from the uncapped one."""
    starts = [0, 40, 13 * ps, 333]
    args, kw = _inputs(G * 10 + D + ps + window, T, 2, G, D, ps, window,
                       starts, [T, T, 21, T], int8, softcap=30.0, gain=gain)
    got = k4_model(*args, **kw)
    want = windowed_prefill_plain(*args, **kw)
    assert _row_ulps(got, want) <= 1.0
    free = {x: y for x, y in kw.items() if x != "softcap"}
    assert _row_ulps(windowed_prefill_plain(*args, **free), want) > 1.0
    assert (got[2, 21:] == 0).all()
