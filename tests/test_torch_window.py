"""The sliding-window family's kernels and host metadata against the JAX
package, on the CPU.

1. The plain versions of K4 (``windowed_prefill_plain``), K1 in ring mode
   (``paged_decode_plain(window=)``) and K3 in ring mode
   (``paged_verify_plain(window=)``) against the Pallas kernels they
   replace, run in interpret mode through their public wrappers
   (``repro.kernels.ragged_prefill.ops.ragged_prefill_attend(window=)``,
   ``repro.kernels.paged_attention.ops.paged_attention_decode/verify
   (window=)``), with bf16 and int8 ring pages, rings with and without a
   slack page.  The Hopper kernels are held to these plain versions on the
   card (``tests/test_torch_hopper.py``, ``chip_smoke.py``).
2. ``decode_meta``, ``prefill_meta`` and ``verify_meta`` equal the JAX
   functions on the same numpy inputs, and the ring masks equal
   ``decode_valid_mask`` / ``verify_valid_mask``.
3. The model-level cores ``ring_chunk_attention`` and ``chunked_attention
   (window=)`` against their JAX counterparts in fp32.

Tolerance (as ``tests/test_torch_kernels.py``): every output element
within one bf16 ulp of the largest magnitude in its row (one head of one
token), never below 2^-14 -- both sides take fp32 scores and sums of the
same bf16 operands in another order, and where two sums differ in their
last bit a probability can round to its other bf16 neighbour.  K4's rows
past ``n_live`` are chunk padding that the caller discards: the port
writes zeros there and the Pallas kernel whatever those rows attend, so
only live rows are compared.  The fp32 model cores agree to 1e-5.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch, reduced  # noqa: E402
from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention_decode, paged_attention_verify)
from repro.kernels.ragged_prefill.ops import ragged_prefill_attend  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import attn_backend as jback  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode, paged_decode_plain, paged_verify, paged_verify_plain)
from repro_torch.kernels.ragged_prefill import (  # noqa: E402
    windowed_prefill, windowed_prefill_plain)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import attn_backend as tback  # noqa: E402
from repro_torch.models.attention import quantize_int8  # noqa: E402
from repro_torch.models.cache_spec import window_pages  # noqa: E402
from test_torch_kernels import _bf16, _within_one_ulp  # noqa: E402


from _torch_common import one_thread  # noqa: E402, F401


def _ring_pool(rng, B, n_ring, ps, K, D):
    """Random bf16 pages and B disjoint rings of ``n_ring`` shuffled pages
    (page 0, the null page, in no ring)."""
    P = B * n_ring + 2
    tables = (rng.permutation(P - 1)[:B * n_ring] + 1).reshape(B, n_ring)
    return (_bf16(rng.randn(P, ps, K, D)), _bf16(rng.randn(P, ps, K, D)),
            tables.astype(np.int32))


def _quantized(kt, vt):
    """The pools quantized by the port's ``quantize_int8``, as (jax, torch)
    pairs of payloads and scales."""
    out = []
    for x in (kt, vt):
        q8, s = quantize_int8(x)
        out.append(((jnp.asarray(q8.numpy()),
                     jnp.asarray(s.float().numpy(), jnp.bfloat16)), (q8, s)))
    return out


# ------------------------------------------------------------- K4 (prefill)

WINDOW_CASES = [
    # (B, H, K, D, ps, n_ring, T, window, starts, n_live)
    (2, 4, 2, 32, 8, 4, 16, 20, (0, 45), (16, 16)),       # crosses window
    (3, 4, 1, 32, 4, 5, 8, 16, (0, 13, 61), (8, 5, 8)),   # MQA ring
    (1, 4, 2, 32, 8, 3, 32, 17, (29,), (32,)),            # unaligned window,
                                                          # chunk > ring span
    (2, 8, 2, 32, 8, 5, 16, 32, (0, 77), (16, 11)),       # ring + slack page
]


@pytest.mark.parametrize("B,H,K,D,ps,n_ring,T,window,starts,n_live",
                         WINDOW_CASES)
@pytest.mark.parametrize("int8", [False, True])
def test_windowed_prefill_plain_matches_pallas(B, H, K, D, ps, n_ring, T,
                                               window, starts, n_live, int8):
    rng = np.random.RandomState(B * 10 + n_ring + int8)
    (kj, kt), (vj, vt), tables = _ring_pool(rng, B, n_ring, ps, K, D)
    qj, qt = _bf16(rng.randn(B, T, H, D))
    knj, knt = _bf16(rng.randn(B, T, K, D))
    vnj, vnt = _bf16(rng.randn(B, T, K, D))
    start = np.array(starts, np.int32)
    live = np.array(n_live, np.int32)
    jkw, tkw = {}, {}
    if int8:
        ((kj, ksj), (kt, kst)), ((vj, vsj), (vt, vst)) = _quantized(kt, vt)
        jkw = dict(k_scale=ksj, v_scale=vsj)
        tkw = dict(k_scale=kst, v_scale=vst)
    ref = ragged_prefill_attend(qj, knj, vnj, kj, vj, jnp.asarray(tables),
                                jnp.asarray(start), jnp.asarray(live),
                                window=window, q_blk=8, interpret=True, **jkw)
    ref = np.asarray(ref, np.float32)
    got = windowed_prefill_plain(qt, knt, vnt, kt, vt,
                                 torch.from_numpy(tables),
                                 torch.from_numpy(start),
                                 torch.from_numpy(live), window=window,
                                 scale=1.0 / math.sqrt(D), **tkw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H, D)
    got = got.float().numpy()
    for b in range(B):
        assert _within_one_ulp(got[b, :live[b]], ref[b, :live[b]])
        assert (got[b, live[b]:] == 0).all()


def test_windowed_wrapper_runs_the_plain_version_on_cpu():
    rng = np.random.RandomState(3)
    (_, kt), (_, vt), tables = _ring_pool(rng, 2, 4, 8, 2, 32)
    q, kn, vn = (_bf16(rng.randn(2, 16, n, 32))[1] for n in (4, 2, 2))
    st = torch.tensor([0, 40], dtype=torch.int32)
    nl = torch.tensor([16, 9], dtype=torch.int32)
    t = torch.from_numpy(tables)
    n0 = windowed_prefill.launches
    torch.testing.assert_close(
        windowed_prefill(q, kn, vn, kt, vt, t, st, nl, window=20, scale=0.2),
        windowed_prefill_plain(q, kn, vn, kt, vt, t, st, nl, window=20,
                               scale=0.2), rtol=0, atol=0)
    assert windowed_prefill.launches == n0      # counts kernel launches only


# ------------------------------------------------ K1 / K3 ring (decode, verify)

RING_CASES = [
    # (ps, K, G, D, window, slack)
    (8, 2, 2, 32, 20, 0),
    (8, 2, 2, 32, 32, 1),
    (16, 1, 9, 32, 40, 1),      # starcoder2-7b's G over one KV head
    (4, 2, 1, 32, 16, 0),
]


def _ring_positions(ring):
    """Before the ring fills, at its last slot, just past a wrap, several
    wraps on."""
    return np.array([3, ring - 1, ring + 2, 3 * ring + 5], np.int32)


@pytest.mark.parametrize("ps,K,G,D,window,slack", RING_CASES)
@pytest.mark.parametrize("int8", [False, True])
def test_ring_decode_plain_matches_pallas(ps, K, G, D, window, slack, int8):
    rng = np.random.RandomState(ps + G + window + int8)
    n_ring = window_pages(window, ps) + slack
    pos = _ring_positions(n_ring * ps)
    B, H = len(pos), K * G
    (kj, kt), (vj, vt), tables = _ring_pool(rng, B, n_ring, ps, K, D)
    qj, qt = _bf16(rng.randn(B, H, D))
    jkw, tkw = {}, {}
    if int8:
        ((kj, ksj), (kt, kst)), ((vj, vsj), (vt, vst)) = _quantized(kt, vt)
        jkw = dict(k_scale=ksj, v_scale=vsj)
        tkw = dict(k_scale=kst, v_scale=vst)
    scale = 1.0 / math.sqrt(D)
    ref = paged_attention_decode(qj, kj, vj, jnp.asarray(tables),
                                 jnp.asarray(pos), scale=scale, window=window,
                                 interpret=True, **jkw)
    got = paged_decode(qt, kt, vt, torch.from_numpy(tables),
                       torch.from_numpy(pos), scale=scale, window=window,
                       **tkw)
    assert got.shape == (B, H, D)
    assert _within_one_ulp(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("ps,K,G,D,window,slack", RING_CASES)
@pytest.mark.parametrize("int8", [False, True])
def test_ring_verify_plain_matches_pallas(ps, K, G, D, window, slack, int8):
    rng = np.random.RandomState(ps * G + window + int8)
    Q = 4
    n_ring = window_pages(window, ps) + slack
    pos = _ring_positions(n_ring * ps)
    n_q = np.array([1, 4, 3, 2], np.int32)
    B, H = len(pos), K * G
    (kj, kt), (vj, vt), tables = _ring_pool(rng, B, n_ring, ps, K, D)
    qj, qt = _bf16(rng.randn(B, Q, H, D))
    jkw, tkw = {}, {}
    if int8:
        ((kj, ksj), (kt, kst)), ((vj, vsj), (vt, vst)) = _quantized(kt, vt)
        jkw = dict(k_scale=ksj, v_scale=vsj)
        tkw = dict(k_scale=kst, v_scale=vst)
    scale = 1.0 / math.sqrt(D)
    ref = paged_attention_verify(qj, kj, vj, jnp.asarray(tables),
                                 jnp.asarray(pos), jnp.asarray(n_q),
                                 scale=scale, window=window, interpret=True,
                                 **jkw)
    got = paged_verify(qt, kt, vt, torch.from_numpy(tables),
                       torch.from_numpy(pos), torch.from_numpy(n_q),
                       scale=scale, window=window, **tkw)
    assert _within_one_ulp(got.float().numpy(), np.asarray(ref, np.float32))
    dead = np.arange(Q)[None, :] >= n_q[:, None]
    assert (got.float().numpy()[dead] == 0).all()
    # one live query per row is the ring decode, bit for bit
    one = paged_verify_plain(qt, kt, vt, torch.from_numpy(tables),
                             torch.from_numpy(pos),
                             torch.ones(B, dtype=torch.int32), scale=scale,
                             window=window, **tkw)
    dec = paged_decode_plain(qt[:, 0], kt, vt, torch.from_numpy(tables),
                             torch.from_numpy(pos), scale=scale,
                             window=window, **tkw)
    assert torch.equal(one[:, 0], dec)


# ------------------------------------------------------------- masks, metas

@pytest.mark.parametrize("n,window", [(24, 20), (40, 32), (16, 16)])
def test_ring_masks_match_jax(n, window):
    rng = np.random.RandomState(n + window)
    pos = np.concatenate([[0, n - 1, n, 2 * n + 3],
                          rng.randint(0, 5 * n, size=6)]).astype(np.int32)
    n_q = rng.randint(1, 5, size=len(pos)).astype(np.int32)
    for w in (0, window):
        want = np.asarray(jattn.decode_valid_mask(jnp.asarray(pos), n,
                                                  window=w))
        got = tattn.decode_valid_mask(torch.from_numpy(pos), n, window=w)
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jattn.verify_valid_mask(
            jnp.asarray(pos), jnp.asarray(n_q), 4, n, window=w))
        got = tattn.verify_valid_mask(torch.from_numpy(pos),
                                      torch.from_numpy(n_q), 4, n, window=w)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def cfgs():
    return (reduced(get_arch("starcoder2-7b")),
            tconfigs.reduced(tconfigs.get_arch("starcoder2-7b")))


@pytest.mark.parametrize("ps,slack", [(8, 0), (8, 1), (4, 1)])
def test_ring_metas_match_jax(cfgs, ps, slack):
    jcfg, tcfg = cfgs
    rng = np.random.RandomState(ps + slack)
    width = window_pages(jcfg.sliding_window, ps) + slack
    B = 4
    tables = (rng.permutation(B * width) + 1).reshape(B, width) \
        .astype(np.int32)
    tables[3] = 0                                   # an idle row
    pos = np.array([0, 7, width * ps + 3, 0], np.int32)
    for name in ("tables", "pos", "write_page", "write_off"):
        np.testing.assert_array_equal(
            tback.decode_meta(tcfg, ps, tables, pos)[name],
            jback.decode_meta(jcfg, ps, tables, pos)[name])
    n_q = np.array([3, 1, 5, 1], np.int32)
    jm = jback.verify_meta(jcfg, ps, tables, pos, n_q, 5)
    tm = tback.verify_meta(tcfg, ps, tables, pos, n_q, 5)
    for name in jm:
        np.testing.assert_array_equal(tm[name], jm[name])
    # chunks at 0, mid-ring, past a wrap, and longer than the ring span
    T = width * ps + 2 * ps
    start = np.array([0, 3 * ps, 5 * width * ps, 0], np.int32)
    n_tail = np.array([T - 5, ps, T, T], np.int32)
    slots = np.arange(B, dtype=np.int32)
    jm = jback.prefill_meta(jcfg, ps, tables, slots, start, n_tail, T)
    tm = tback.prefill_meta(tcfg, ps, tables, slots, start, n_tail, T)
    for name in jm:
        np.testing.assert_array_equal(tm[name], jm[name])


# ------------------------------------------------------------ model cores

def test_ring_chunk_attention_matches_jax():
    rng = np.random.RandomState(5)
    B, T, H, K, D, n, window = 3, 12, 4, 2, 16, 20, 14
    q, k, v = (rng.randn(B, T, h, D).astype(np.float32)
               for h in (H, K, K))
    kr, vr = (rng.randn(B, n, K, D).astype(np.float32) for _ in range(2))
    start = np.array([0, 9, 47], np.int32)
    n_live = np.array([12, 7, 12], np.int32)
    want = jattn.ring_chunk_attention(
        *map(jnp.asarray, (q, k, v, kr, vr, start, n_live)), window=window,
        q_block=8)
    got = tattn.ring_chunk_attention(
        *map(torch.from_numpy, (q, k, v, kr, vr, start, n_live)),
        window=window, scale=1.0 / math.sqrt(D), q_block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("window", [0, 5, 16])
def test_windowed_chunked_attention_matches_jax(window):
    rng = np.random.RandomState(window)
    B, S, H, K, D = 2, 20, 4, 2, 16
    q, k, v = (rng.randn(B, S, h, D).astype(np.float32) for h in (H, K, K))
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   window=window, q_block=8)
    got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                  scale=1.0 / math.sqrt(D), q_block=8,
                                  window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
