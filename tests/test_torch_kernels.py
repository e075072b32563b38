"""The plain PyTorch versions of the port's kernels against the JAX Pallas
kernels they replace (interpret mode on the CPU).  The Hopper kernels are
held to these plain versions on the card by ``tests/test_torch_hopper.py``
and ``chip_smoke.py``.

Inputs are drawn with numpy from a seed and rounded once to bf16.  The
bound holds each output element within one bf16 ulp of the largest
magnitude in its row (one head of one token), never below ``ULP_FLOOR`` =
2^-14: both sides take fp32 scores and sums of the same bf16 operands, in
another order (and the decode kernel folds its softmax online); where two
sums differ in their last bit a probability can round to its other bf16
neighbour, moving the row by up to an ulp of its larger terms, so an
element that cancels to near 0 is not held to its own ulp.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.paged_attention.kernel import paged_decode_fwd  # noqa: E402
from repro.kernels.ragged_prefill.kernel import ragged_prefill_fwd  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode, paged_decode_plain)
from repro_torch.kernels.ragged_prefill import (  # noqa: E402
    ragged_prefill, ragged_prefill_plain)


def _bf16(a):
    """(jax bf16 array, torch bf16 tensor) holding identical values."""
    j = jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j, np.float32)).bfloat16()


ULP_FLOOR = 2.0 ** -14


def _within_one_ulp(got, ref):
    """Every element of ``got`` within one bf16 ulp of the largest |ref| in
    its row (the last axis), never below ``ULP_FLOOR``."""
    a = np.abs(ref).astype(np.float64).max(-1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(np.maximum(a, 1e-30))) - 7)
    return bool((np.abs(got - ref) <= np.maximum(ulp, ULP_FLOOR)).all())


def _pool_and_tables(rng, lengths, ps, K, D, width):
    """Shuffled physical pages for requests of ``lengths`` tokens; table
    entries past a request's pages point at the null page 0."""
    need = [-(-n // ps) for n in lengths]
    P = sum(need) + 3
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((len(lengths), width), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    k = _bf16(rng.randn(P, ps, K, D))
    v = _bf16(rng.randn(P, ps, K, D))
    return k, v, tables


DECODE_CASES = [
    # (ps, K, G, D, width) — pos covers 0, a page's last slot, a page's
    # first slot and the table's last slot
    (8, 2, 1, 32, 4),
    (8, 2, 2, 32, 4),
    (16, 2, 7, 64, 3),
    (16, 1, 7, 32, 2),
]


@pytest.mark.parametrize("ps,K,G,D,width", DECODE_CASES)
def test_paged_decode_plain_matches_pallas(ps, K, G, D, width):
    rng = np.random.RandomState(ps * 100 + G)
    pos = np.array([0, ps - 1, ps, width * ps - 1], np.int32)
    B, H = len(pos), K * G
    (kj, kt), (vj, vt), tables = _pool_and_tables(rng, pos + 1, ps, K, D,
                                                  width)
    qj, qt = _bf16(rng.randn(B, H, D))
    scale = 1.0 / math.sqrt(D)
    ref = paged_decode_fwd(qj.reshape(B, K, G, D), kj, vj,
                           jnp.asarray(tables), jnp.asarray(pos),
                           scale=scale, interpret=True)
    ref = np.asarray(ref, np.float32).reshape(B, H, D)
    got = paged_decode_plain(qt, kt, vt, torch.from_numpy(tables),
                             torch.from_numpy(pos), scale=scale)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, D)
    assert _within_one_ulp(got.float().numpy(), ref)


PREFILL_CASES = [
    # (ps, K, G, D, T, q_blk, starts, n_live)
    (8, 2, 2, 32, 16, 8, (0, 8, 21), (16, 9, 5)),
    (16, 2, 7, 32, 16, 16, (0, 40, 16), (16, 12, 3)),
]


@pytest.mark.parametrize("ps,K,G,D,T,q_blk,starts,n_live", PREFILL_CASES)
def test_ragged_prefill_plain_matches_pallas(ps, K, G, D, T, q_blk, starts,
                                             n_live):
    rng = np.random.RandomState(ps + G)
    B, H = len(starts), K * G
    start = np.array(starts, np.int32)
    live = np.array(n_live, np.int32)
    width = max(-(-(s + T) // ps) for s in starts)
    (kj, kt), (vj, vt), tables = _pool_and_tables(rng, start + T, ps, K, D,
                                                  width)
    qj, qt = _bf16(rng.randn(B, T, H, D))
    ref = ragged_prefill_fwd(
        qj.reshape(B, T, K, G, D).transpose(0, 2, 1, 3, 4), kj, vj,
        jnp.asarray(tables), jnp.asarray(start), jnp.asarray(live),
        scale=1.0 / math.sqrt(D), q_blk=q_blk, interpret=True)
    ref = np.asarray(ref, np.float32).transpose(0, 2, 1, 3, 4) \
        .reshape(B, T, H, D)
    got = ragged_prefill_plain(qt, kt, vt, torch.from_numpy(tables),
                               torch.from_numpy(start),
                               scale=1.0 / math.sqrt(D))
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H, D)
    assert _within_one_ulp(got.float().numpy(), ref)


def test_wrappers_run_the_plain_version_on_cpu():
    rng = np.random.RandomState(7)
    (_, kt), (_, vt), tables = _pool_and_tables(rng, [20, 3], 8, 2, 32, 3)
    q = _bf16(rng.randn(2, 4, 32))[1]
    pos = torch.tensor([19, 2], dtype=torch.int32)
    t = torch.from_numpy(tables)
    n0 = paged_decode.launches
    torch.testing.assert_close(
        paged_decode(q, kt, vt, t, pos, scale=0.2),
        paged_decode_plain(q, kt, vt, t, pos, scale=0.2), rtol=0, atol=0)
    qp = _bf16(rng.randn(2, 5, 4, 32))[1]
    st = torch.tensor([8, 0], dtype=torch.int32)
    m0 = ragged_prefill.launches
    torch.testing.assert_close(
        ragged_prefill(qp, kt, vt, t, st, scale=0.2),
        ragged_prefill_plain(qp, kt, vt, t, st, scale=0.2), rtol=0, atol=0)
    # the counters count kernel launches only
    assert (paged_decode.launches, ragged_prefill.launches) == (n0, m0)


@pytest.mark.parametrize("mode,item", [
    (dict(window=32), "item 11"), (dict(softcap=30.0), "softcap"),
    (dict(k_scale=0, v_scale=0), "item 8")])
def test_unported_kernel_modes_refuse(mode, item):
    rng = np.random.RandomState(8)
    (_, kt), (_, vt), tables = _pool_and_tables(rng, [20], 8, 2, 32, 3)
    t = torch.from_numpy(tables)
    q = _bf16(rng.randn(1, 4, 32))[1]
    with pytest.raises(NotImplementedError, match=item):
        paged_decode(q, kt, vt, t, torch.tensor([19], dtype=torch.int32),
                     scale=0.2, **mode)
    with pytest.raises(NotImplementedError, match=item):
        ragged_prefill(_bf16(rng.randn(1, 4, 4, 32))[1], kt, vt, t,
                       torch.tensor([0], dtype=torch.int32), scale=0.2,
                       **mode)
