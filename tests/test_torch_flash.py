"""Kernel K9's plain version and its differentiable form on the CPU,
against the JAX package.

1. ``attention_plain`` (what ``flash_attention`` runs for CPU tensors)
   against ``repro.kernels.flash_attention``'s Pallas kernel in interpret
   mode and against its oracle ``attention_ref``, on the same numpy inputs:
   fp32 and bf16, causal and full, G = 1, 2 and 6 query heads a KV head, at
   S = 200 (not a multiple of 128; the Pallas kernel runs 40-row blocks,
   since it asserts S % block == 0).  fp32 within 2e-6 (both take fp32
   scores and sums, the kernel with an online softmax: a few fp32 ulps);
   bf16 within one bf16 ulp of each output row's largest |value| (the
   bound the kernel is held to on the card: fp32 sums that round once to
   bf16 can land on either neighbour).
2. ``flash_attention_train``'s gradients (the backward recomputed by query
   block in torch ops) against ``jax.grad`` of ``attention_ref`` through a
   fixed random cotangent, fp32, causal and full, G = 1, 2 and 6, with a
   query block that does not divide S: within 1e-5 relative L2 and 1e-5
   absolute per element (fp32 sums in another order).
3. The backends' training core: ``reference`` is the chunked attention
   (the port of JAX's training attention, window included); ``hopper``
   refuses CPU tensors.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_plain, flash_attention, flash_attention_train)
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.models.attn_backend import get_backend  # noqa: E402

S, H, D = 200, 6, 64


from _torch_common import one_thread  # noqa: E402, F401


def _inputs(G, seed, B=1):
    rng = np.random.RandomState(seed)
    K = H // G
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, S, K, D).astype(np.float32),
            rng.randn(B, S, K, D).astype(np.float32))


def _row_ulp(want):
    a = np.abs(want).max(-1, keepdims=True).clip(1e-30)
    return np.maximum(np.exp2(np.floor(np.log2(a)) - 7), 2.0 ** -14)


@pytest.mark.parametrize("G", [1, 2, 6])
@pytest.mark.parametrize("dtype,causal", [("float32", True),
                                          ("float32", False),
                                          ("bfloat16", True),
                                          ("bfloat16", False)])
def test_plain_matches_pallas_and_ref(G, dtype, causal):
    q, k, v = _inputs(G, seed=G)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    pallas = np.asarray(j_flash(jq, jk, jv, causal=causal, block_q=40,
                                block_k=40, interpret=True), np.float32)
    ref = np.asarray(jnp.swapaxes(attention_ref(
        *(jnp.swapaxes(a, 1, 2) for a in (jq, jk, jv)), causal=causal),
        1, 2), np.float32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tdt and got.shape == (1, S, H, D)
    got = got.float().numpy()
    np.testing.assert_array_equal(
        got, attention_plain(tq, tk, tv, causal=causal).float().numpy())
    for want in (pallas, ref):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        else:
            assert (np.abs(got - want) <= _row_ulp(want)).all()


@pytest.mark.parametrize("G", [1, 2, 6])
@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(G, causal):
    q, k, v = _inputs(G, seed=10 + G)
    dout = np.random.RandomState(20 + G).randn(1, S, H, D).astype(np.float32)

    def jloss(q, k, v):
        o = attention_ref(*(jnp.swapaxes(a, 1, 2) for a in (q, k, v)),
                          causal=causal)
        return jnp.sum(jnp.swapaxes(o, 1, 2) * dout)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = flash_attention_train(tq, tk, tv, causal=causal, q_block=48)
    got = torch.autograd.grad((o * torch.from_numpy(dout)).sum(),
                              (tq, tk, tv))
    for name, g, w in zip("qkv", got, want):
        g, w = g.numpy(), np.asarray(w)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 1e-5, (name, rel)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)


def test_reference_train_core_is_the_chunked_attention():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(2, seed=3))
    scale = 1.0 / math.sqrt(D)
    ref = get_backend("reference")
    for window in (0, 48):
        got = ref.train_attend(q, k, v, scale=scale, window=window,
                               q_block=64)
        want = chunked_attention(q, k, v, scale=scale, q_block=64,
                                 window=window)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="hopper"):
        get_backend("hopper").train_attend(q, k, v, scale=scale)
