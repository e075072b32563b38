"""K6's arithmetic on the CPU: a model of the two Hopper kernels' order and
rounding (``csrc/mla_build_kv.cu``, stage A, and
``csrc/mla_ragged_prefill.cu``, stage B) held to
``mla_ragged_prefill_plain``, at deepseek-v2's widths (L 512, nope 128, R
64, v 128) with 2 heads and 16-token pages.

The model, written here and nowhere in the package, computes what the
kernels compute, in their order:

* stage A builds every key of a request's pages up to the one holding the
  chunk's last row (within the table) once: bf16 pages as the fp64 sum of
  the exact products, rounded to fp32 and then to bf16; int8 pages as fp32
  sums of the int8 latent times bf16 ``wkv_b``, each 16 products summed
  exactly and added to the fp32 accumulator (the tensor cores' k16 step),
  times the slot's fp32 ckv scale, kept as hi = bf16(x), lo = bf16(x -
  hi);
* stage B, for each (request, head, 64-row query tile): keys in 64-key
  tiles anchored at key 0 (K = nope from stage A ++ the rope key from the
  pages; int8: the rope key f32(q8) * f32(s) split into hi and lo too),
  tiles past the tile's last query skipped, keys after a row's position
  or past the table at -1e30; scores fp32 dot products over the 192 query
  dims (int8: q . (k_hi + k_lo)) times the scale after the dot;
* sweep 1 keeps the row max m and rescales only the normalizer, l * exp(m
  - m_new) + sum exp(s - m_new), each tile's sum as the kernel's threads
  take it (K2's model, ``test_torch_prefill_tiles.py``);
* sweep 2 forms p = exp(s - m) / l at the true max, rounded to bf16 for
  bf16 pages; int8: p_hi = bf16(p), p_lo = bf16(p - p_hi), and PV =
  p_hi . v_hi + p_hi . v_lo + p_lo . v_hi, every 16 keys' products summed
  exactly into the fp32 accumulator, in that order;
* one bf16 cast at the output; every row of the chunk is computed.

Bounds: each output element within one bf16 ulp of the largest |plain| in
its row (one head of one token), never below 2^-14 -- the bound
``chip_smoke.py`` holds the kernels to on the card; stage A's bf16 K/V
equal to the plain einsum's and its int8 hi + lo within 2^-16 of each
row's largest |x|; a prompt's rows equal bit for bit however it is cut
into chunks (and not so with key tiles anchored at the chunk's start); a
request alone equal to its rows in the batch.  Inputs are drawn from a
seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels.ragged_prefill import (  # noqa: E402
    mla_build_kv, mla_build_kv_plain, mla_ragged_prefill_plain)
from repro_torch.kernels.ragged_prefill.ops import (  # noqa: E402
    mla_built_keys, mla_kv_rows)
from repro_torch.models.attention import (  # noqa: E402
    dequant_int8, gather_pages, quantize_int8)
from test_torch_prefill_tiles import (_pv, _quad_sum,  # noqa: E402
                                      _within_one_ulp as _row_ulps)

KEYS = 64                  # keys a tile (csrc kSlots), rows a query tile
MASK = -1e30
L, NOPE, R, VD, PS, H = 512, 128, 64, 128, 16, 2


from _torch_common import one_thread  # noqa: E402, F401


def stage_a_model(ckv_pages, wkv_b, tables, start, T, ckv_scale=None):
    """Stage A's K/V planes, each [B, n_keys, H, nope + v] fp32 holding
    bf16 values (one plane for bf16 pages, hi and lo for int8), rows past
    a request's built keys zero."""
    B, n_pages = tables.shape
    n_keys = n_pages * PS
    cc = ckv_pages[tables.long()].reshape(B, n_keys, L)
    w = wkv_b.reshape(L, -1)
    if ckv_scale is None:
        planes = [(cc.double() @ w.double()).float().bfloat16().float()]
    else:
        acc = torch.zeros(B, n_keys, w.shape[1])
        for k0 in range(0, L, 16):
            acc = (acc.double() + cc[..., k0:k0 + 16].double()
                   @ w[k0:k0 + 16].double()).float()
        x = acc * ckv_scale[tables.long()].reshape(B, n_keys, 1).float()
        hi = x.bfloat16().float()
        planes = [hi, (x - hi).bfloat16().float()]
    built = torch.arange(n_keys)[None, :] \
        < mla_built_keys(start, T, n_pages, PS)[:, None]
    return [torch.where(built[..., None], p, torch.zeros(())).reshape(
        B, n_keys, H, NOPE + VD) for p in planes]


def k6_model(q, ckv_pages, krope_pages, wkv_b, tables, start, *,
             ckv_scale=None, krope_scale=None, anchor_at_start=False,
             fp32=False):
    """K6 in the kernels' order; ``fp32`` returns the fp32 accumulators
    before the output's bf16 cast.  ``anchor_at_start`` anchors the key
    tiles at the chunk's start instead of key 0 (a broken variant the
    tests show is wrong)."""
    B, T, _, E = q.shape
    n_pages = tables.shape[1]
    n_keys = n_pages * PS
    int8 = ckv_scale is not None
    scale = float(np.float32(1.0 / np.sqrt(E)))
    kv = stage_a_model(ckv_pages, wkv_b, tables, start, T, ckv_scale)
    rope = krope_pages[tables.long()].reshape(B, n_keys, R).float()
    if int8:
        rope = rope * krope_scale[tables.long()].reshape(B, n_keys, 1).float()
        rh = rope.bfloat16().float()
        ropes = [rh, (rope - rh).bfloat16().float()]
    else:
        ropes = [rope]
    out = torch.zeros(B, T, H, VD)
    for b in range(B):
        st = int(start[b])
        off = (st % KEYS - KEYS if st % KEYS else 0) if anchor_at_start \
            else 0
        for h in range(H):
            ks = [torch.cat([p[b, :, h, :NOPE], r[b]], -1)
                  for p, r in zip(kv, ropes)]
            vs = [p[b, :, h, NOPE:] for p in kv]

            def tile(x, keys):
                t = torch.zeros(KEYS, x.shape[1])
                live = (keys >= 0) & (keys < n_keys)
                t[live] = x[keys[live]]
                return t

            for t0 in range(0, T, KEYS):
                rows = torch.arange(t0, min(t0 + KEYS, T))
                qt = q[b, rows, h].double()
                q_abs = st + rows
                q_last = int(q_abs[-1])
                firsts = [f for f in range(off, min(q_last, n_keys - 1) + 1,
                                           KEYS)]

                def scores(f):
                    keys = f + torch.arange(KEYS)
                    k = sum(tile(x, keys).double() for x in ks)
                    s = (qt @ k.T).float() * scale
                    ok = (keys[None, :] >= 0) & (keys[None, :] < n_keys) \
                        & (keys[None, :] <= q_abs[:, None])
                    return torch.where(ok, s, torch.tensor(MASK))

                m = torch.full((len(rows),), MASK)
                l = torch.zeros(len(rows))
                for f in firsts:
                    s = scores(f)
                    m_new = torch.maximum(m, s.amax(-1))
                    l = l * torch.exp(m - m_new) \
                        + _quad_sum(torch.exp(s - m_new[:, None]))
                    m = m_new
                o = torch.zeros(len(rows), VD)
                for f in firsts:
                    p = torch.exp(scores(f) - m[:, None]) / l[:, None]
                    keys = f + torch.arange(KEYS)
                    vt = [tile(x, keys) for x in vs]
                    if int8:
                        h1 = p.bfloat16()
                        h2 = (p - h1.float()).bfloat16()
                        o = _pv(_pv(_pv(o, h1, vt[0]), h1, vt[1]), h2, vt[0])
                    else:
                        o = _pv(o, p.bfloat16(), vt[0])
                out[b, rows, h] = o
    return out if fp32 else out.bfloat16()


def _bf16(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()


def _inputs(seed, T, starts, n_live, int8):
    """Random latent pages over shuffled tables (entries past a request's
    pages on the null page 0, as the engine leaves them), chunk queries
    and ``wkv_b``."""
    rng = np.random.RandomState(seed)
    need = [-(-(s + n) // PS) for s, n in zip(starts, n_live)]
    width = max(-(-(s + T) // PS) for s in starts)
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((len(starts), width), np.int32)
    at = 0
    for b, n_ in enumerate(need):
        tables[b, :n_] = perm[at:at + n_]
        at += n_
    ckv, kr = _bf16(rng, P, PS, L), _bf16(rng, P, PS, R)
    q = _bf16(rng, len(starts), T, H, NOPE + R)
    w = torch.from_numpy((rng.randn(L, H, NOPE + VD) / np.sqrt(L))
                         .astype(np.float32)).bfloat16()
    kw = {}
    if int8:
        (ckv, kw["ckv_scale"]), (kr, kw["krope_scale"]) = \
            quantize_int8(ckv), quantize_int8(kr)
    return (q, ckv, kr, w, torch.from_numpy(tables),
            torch.tensor(starts, dtype=torch.int32)), kw


@pytest.mark.parametrize("int8", [False, True])
def test_model_matches_plain_within_a_row_ulp(int8):
    """Chunks at start 0, mid-page (40, no multiple of 64) and at 100 with
    21 live tokens of 70: its padding rows read the null page and are
    computed; 70 rows are two query tiles."""
    args, kw = _inputs(7 + int8, 70, [0, 40, 100], [70, 70, 21], int8)
    got = k6_model(*args, **kw)
    want = mla_ragged_prefill_plain(*args, nope=NOPE, **kw)
    assert got.shape == want.shape == (3, 70, H, VD)
    assert torch.isfinite(got.float()).all()
    assert _row_ulps(got, want) <= 1.0


@pytest.mark.parametrize("int8", [False, True])
def test_stage_a_model_matches_plain(int8):
    """Stage A's bf16 K/V equal the plain einsum's; its int8 hi + lo lie
    within 2^-16 of each row's largest |x| of the fp32 einsum x; the
    wrapper on CPU tensors is the plain version."""
    (q, ckv, kr, w, t, st), kw = _inputs(3, 40, [0, 37], [40, 13], int8)
    T = q.shape[1]
    cs = kw.get("ckv_scale")
    plain = mla_build_kv_plain(ckv, w, t, st, T, ckv_scale=cs)
    assert torch.equal(mla_build_kv(ckv, w, t, st, T, nope=NOPE,
                                    ckv_scale=cs), plain)
    n_keys = t.shape[1] * PS
    assert plain.shape == (2, H, mla_kv_rows(t.shape[1], PS),
                           (NOPE + VD) * (2 if int8 else 1))
    assert not plain[:, :, n_keys:].any()
    model = stage_a_model(ckv, w, t, st, T, cs)
    got = sum(p.permute(0, 2, 1, 3) for p in model)        # [B, H, S, 256]
    if int8:
        built = torch.arange(n_keys)[None, :] \
            < mla_built_keys(st, T, t.shape[1], PS)[:, None]
        x = torch.einsum("bsl,lhe->bhse", dequant_int8(
            gather_pages(ckv, t), gather_pages(cs, t)), w.float())
        x = torch.where(built[:, None, :, None], x, torch.zeros(()))
        bound = 2.0 ** -16 * x.abs().amax(-1, keepdim=True)
        assert ((got - x).abs() <= bound).all()
    else:
        assert torch.equal(got, plain[:, :, :n_keys].float())


@pytest.mark.parametrize("int8", [False, True])
def test_model_rows_equal_across_a_chunk_split(int8):
    """A 150-token prompt prefilled as one chunk and as chunks [0, 52) and
    [52, 150) over the same post-write pages: the same rows, bit for bit,
    down to the fp32 accumulators before the output's cast.  With key
    tiles anchored at the chunk's start the second chunk's rows sum over
    other tiles and their accumulators part from the one-chunk rows',
    though each row stays within a row ulp of the plain version."""
    (q, ckv, kr, w, t, _), kw = _inputs(11 + int8, 150, [0], [150], int8)

    def run(lo, hi, **extra):
        return k6_model(q[:, lo:hi], ckv, kr, w, t,
                        torch.tensor([lo], dtype=torch.int32), fp32=True,
                        **kw, **extra)

    one = run(0, 150)
    assert torch.equal(one, torch.cat([run(0, 52), run(52, 150)], 1))
    assert _row_ulps(one.bfloat16(), mla_ragged_prefill_plain(
        q, ckv, kr, w, t, torch.tensor([0], dtype=torch.int32), nope=NOPE,
        **kw)) <= 1.0
    wrong = run(52, 150, anchor_at_start=True)
    assert not torch.equal(wrong, one[:, 52:])
    assert _row_ulps(wrong.bfloat16(), one[:, 52:].bfloat16()) <= 1.0


def test_model_request_alone_equals_its_rows_in_the_batch():
    """Each request of a batch of three, prefilled alone through its own
    table row, gives its rows in the batch bit for bit."""
    args, kw = _inputs(5, 40, [0, 96, 16], [40, 40, 13], True)
    q, ckv, kr, w, t, st = args
    got = k6_model(*args, **kw)
    for b in range(3):
        assert torch.equal(k6_model(q[b:b + 1], ckv, kr, w, t[b:b + 1],
                                    st[b:b + 1], **kw), got[b:b + 1])


def test_build_kv_plain_matches_the_jax_materialization():
    """Stage A's plain version against the JAX package's per-head K/V
    materialization (``repro.models.mla``: ``jnp.einsum`` of the gathered
    latent with ``wkv_b``), the same bf16 inputs: each element within one
    bf16 ulp of its row's largest |x| (JAX sums in fp32 and rounds once to
    bf16, the port's sums are fp64)."""
    (q, ckv, kr, w, t, st), _ = _inputs(2, 40, [0, 37], [40, 40], False)
    ws = mla_build_kv_plain(ckv, w, t, st, 40)
    B, n_pages = t.shape
    cc = ckv[t.long()].reshape(B, n_pages * PS, L)
    ref = np.asarray(jnp.einsum(
        "bsl,lhe->bshe", jnp.asarray(cc.float().numpy(), jnp.bfloat16),
        jnp.asarray(w.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    ref = torch.from_numpy(ref.copy()).permute(0, 2, 1, 3)
    built = mla_built_keys(st, 40, n_pages, PS)
    for b in range(B):
        n = int(built[b])
        assert _row_ulps(ws[b, :, :n], ref[b, :, :n]) <= 1.0
