"""K2's arithmetic on the CPU: a model of the Hopper kernel's order and
rounding (``csrc/ragged_prefill.cu``) held to ``ragged_prefill_plain``.

The model, written here and nowhere in the package, computes what the
kernel computes, in its order, for every (request, KV head):

* rows are (token, group head) pairs, token-major; keys go in 64-slot
  tiles of whole pages, kt = (64 // ps) * ps keys a tile, anchored at
  absolute key 0; slots past kt, keys past the table and keys after the
  row's position score -1e30;
* scores are fp32 dot products (exact products, one rounding) times the
  scale after the dot; int8 pages take the factored key scale, (q . k8) *
  ks * scale; then the logit cap (``softcap > 0``: s = softcap * tanh(s /
  softcap)), before the mask, in the one score routine both sweeps run;
* sweep 1 keeps the row max m and rescales only the normalizer, l * exp(m
  - m_new) + sum exp(s - m_new), each tile's sum taken as the kernel's
  threads take it (each of a row's 4 threads sums its 16 columns in order,
  then (t0 + t1) + (t2 + t3));
* sweep 2 forms p = exp(s - m) / l at the true max, rounded to bf16 for
  bf16 pages; for int8 pages p' = p * vs (fp32) split into two bf16 terms
  h1 = bf16(p'), h2 = bf16(p' - h1), each multiplied by the int8 values;
  every 16 keys' products are summed exactly and added to the fp32
  accumulator (the tensor cores' k16 step), h1's four steps before h2's;
* one bf16 cast at the output.

Bounds: each output element within one bf16 ulp of the largest |plain|
in its row (one head of one token), never below 2^-14 -- the bound
``chip_smoke.py`` holds the kernel to on the card; and a prompt's rows
are equal bit for bit whether it is prefilled as one chunk or as two,
with a cap too.  Inputs are drawn from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ragged_prefill import ragged_prefill_plain  # noqa: E402
from repro_torch.models.attention import quantize_int8  # noqa: E402

SLOTS = 64                 # key slots a tile (csrc kSlots)
MASK = -1e30


from _torch_common import one_thread  # noqa: E402, F401


def _quad_sum(e):
    """[rows, 64] -> [rows]: thread c of a row's quad holds columns 8 j +
    2 c + {0, 1} and sums them in order; then (t0 + t1) + (t2 + t3)."""
    x = e.reshape(-1, 8, 4, 2).permute(0, 2, 1, 3).reshape(-1, 4, 16)
    t = x[:, :, 0].clone()
    for j in range(1, 16):
        t = t + x[:, :, j]
    return (t[:, 0] + t[:, 1]) + (t[:, 2] + t[:, 3])


def _pv(o, p, v):
    """o [rows, D] fp32 += p [rows, 64] times v [64, D], both exact in bf16
    (or int8): each 16 keys' products summed exactly, then one fp32
    rounding into the accumulator."""
    for kk in range(4):
        t = torch.zeros(o.shape, dtype=torch.float64)
        for j in range(16 * kk, 16 * kk + 16):
            t = t + p[:, j:j + 1].double() * v[j].double()
        o = (o.double() + t).float()
    return o


def k2_model(q, k_pages, v_pages, tables, start, *, scale, softcap=0.0,
             k_scale=None, v_scale=None):
    B, T, H, D = q.shape
    _, ps, K, _ = k_pages.shape
    G = H // K
    ppt = SLOTS // ps
    kt = ppt * ps
    n_pages = tables.shape[1]
    n_keys = n_pages * ps
    int8 = k_scale is not None
    out = torch.empty_like(q)
    for b in range(B):
        st = int(start[b])
        n = min((st + T - 1) // kt + 1, -(-n_pages // ppt))
        kg = k_pages[tables[b].long()].reshape(n_keys, K, D)
        vg = v_pages[tables[b].long()].reshape(n_keys, K, D)
        if int8:
            ksg = k_scale[tables[b].long()].reshape(n_keys, K).float()
            vsg = v_scale[tables[b].long()].reshape(n_keys, K).float()
        qpos = st + torch.arange(T).repeat_interleave(G)

        def tile(i, kh, x, xs=None):
            """Slot-padded [64, D] tile i of KV head kh (zeros past kt and
            past the table), its keys' positions and, for int8, scales."""
            t = torch.zeros(SLOTS, D, dtype=torch.float32)
            s = torch.zeros(SLOTS, dtype=torch.float32)
            keys = i * kt + torch.arange(SLOTS)
            live = (torch.arange(SLOTS) < kt) & (keys < n_keys)
            at = keys[live]
            t[live] = x[at, kh].float()
            if xs is not None:
                s[live] = xs[at, kh]
            return t, s, keys, live

        for kh in range(K):
            qr = q[b, :, kh * G:(kh + 1) * G].reshape(T * G, D).double()

            def scores(i):
                kt_, ks, keys, live = tile(i, kh, kg,
                                           ksg if int8 else None)
                s = (qr @ kt_.double().T).float()
                if int8:
                    s = s * ks
                s = s * scale
                if softcap:
                    s = softcap * torch.tanh(s / softcap)
                ok = live[None, :] & (keys[None, :] <= qpos[:, None])
                return torch.where(ok, s, torch.tensor(MASK))

            m = torch.full((T * G,), MASK)
            l = torch.zeros(T * G)
            for i in range(n):
                s = scores(i)
                m_new = torch.maximum(m, s.amax(-1))
                e = torch.exp(s - m_new[:, None])
                l = l * torch.exp(m - m_new) + _quad_sum(e)
                m = m_new
            o = torch.zeros(T * G, D)
            for i in range(n):
                p = torch.exp(scores(i) - m[:, None]) / l[:, None]
                vt, vs, _, _ = tile(i, kh, vg, vsg if int8 else None)
                if int8:
                    p = p * vs
                    h1 = p.bfloat16()
                    h2 = (p - h1.float()).bfloat16()
                    o = _pv(_pv(o, h1, vt), h2, vt)
                else:
                    o = _pv(o, p.bfloat16(), vt)
            out[b, :, kh * G:(kh + 1) * G] = o.bfloat16().reshape(T, G, D)
    return out


def _within_one_ulp(got, want):
    """Each element of ``got`` within one bf16 ulp of the largest |want|
    in its row, never below 2^-14; returns the worst error over bound."""
    a = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7).clamp_min(2.0 ** -14)
    return ((got.float() - want.float()).abs() / ulp).max().item()


def _inputs(seed, B, T, K, G, D, ps, starts, int8, softcap=0.0, gain=1.0):
    rng = np.random.RandomState(seed)
    need = [-(-(s + T) // ps) for s in starts]
    width = max(need) + 1
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((B, width), np.int32)
    at = 0
    for b, n_ in enumerate(need):
        tables[b, :n_] = perm[at:at + n_]
        at += n_
    k = torch.from_numpy(rng.randn(P, ps, K, D).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.randn(P, ps, K, D).astype(np.float32)).bfloat16()
    q = torch.from_numpy(
        rng.randn(B, T, K * G, D).astype(np.float32) * gain).bfloat16()
    kw = dict(scale=D ** -0.5)
    if softcap:
        kw["softcap"] = softcap
    if int8:
        (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_int8(k), \
            quantize_int8(v)
    return q, k, v, torch.from_numpy(tables), \
        torch.tensor(starts, dtype=torch.int32), kw


@pytest.mark.parametrize("G,D,ps,int8", [
    (1, 32, 8, False), (2, 64, 16, True), (3, 128, 32, False),
    (7, 64, 16, False), (12, 128, 16, True), (3, 32, 32, True),
    (7, 128, 8, True), (12, 64, 8, False), (2, 128, 16, False),
    (1, 64, 32, True), (3, 64, 24, True)])
def test_model_matches_plain_within_a_row_ulp(G, D, ps, int8):
    """Mid-page starts, T not a multiple of a tile's 64 rows or keys."""
    q, k, v, t, st, kw = _inputs(G * 100 + D + ps, 2, 37, 2, G, D, ps,
                                 [45, 3], int8)
    got = k2_model(q, k, v, t, st, **kw)
    want = ragged_prefill_plain(q, k, v, t, st, **kw)
    assert torch.isfinite(got.float()).all()
    assert _within_one_ulp(got, want) <= 1.0


@pytest.mark.parametrize("G,D,ps,int8", [
    (7, 64, 16, False), (7, 64, 16, True), (3, 128, 32, True),
    (12, 32, 8, False)])
def test_model_rows_equal_across_a_chunk_split(G, D, ps, int8):
    """A 150-token prompt prefilled as one chunk and as chunks [0, 52) and
    [52, 150) over the same post-write pool: the same rows, bit for bit."""
    q, k, v, t, _, kw = _inputs(G + D + ps, 1, 150, 2, G, D, ps, [0], int8)
    one = k2_model(q, k, v, t, torch.tensor([0], dtype=torch.int32), **kw)
    a = k2_model(q[:, :52], k, v, t, torch.tensor([0], dtype=torch.int32),
                 **kw)
    b = k2_model(q[:, 52:], k, v, t, torch.tensor([52], dtype=torch.int32),
                 **kw)
    assert torch.equal(one, torch.cat([a, b], dim=1))
    assert _within_one_ulp(one, ragged_prefill_plain(
        q, k, v, t, torch.tensor([0], dtype=torch.int32), **kw)) <= 1.0


@pytest.mark.parametrize("G,D,ps,int8,gain", [
    (7, 64, 16, False, 16.0), (3, 128, 32, True, 64.0),
    (12, 32, 8, True, 16.0), (2, 128, 16, False, 64.0)])
def test_capped_model_matches_plain_and_chunk_split(G, D, ps, int8, gain):
    """At softcap 30, queries scaled so the scores reach the cap (gain 16)
    or several times it (64): the model within a row ulp of the capped
    plain version and apart from the uncapped one, and a 100-token prompt
    cut at token 52 equal to one chunk bit for bit."""
    q, k, v, t, st, kw = _inputs(G * 7 + D + ps, 1, 100, 2, G, D, ps, [0],
                                 int8, softcap=30.0, gain=gain)
    one = k2_model(q, k, v, t, st, **kw)
    want = ragged_prefill_plain(q, k, v, t, st, **kw)
    assert _within_one_ulp(one, want) <= 1.0
    free = {x: y for x, y in kw.items() if x != "softcap"}
    assert _within_one_ulp(ragged_prefill_plain(q, k, v, t, st, **free),
                           want) > 1.0
    a = k2_model(q[:, :52], k, v, t, st, **kw)
    b = k2_model(q[:, 52:], k, v, t, st + 52, **kw)
    assert torch.equal(one, torch.cat([a, b], dim=1))
