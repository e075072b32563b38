"""The int8 paged KV pool of the port, on the CPU, against the JAX package.

1. *Quantize contract* — ``quantize_int8`` / ``dequant_int8`` bit for bit
   against ``repro.models.attention``'s (absmax in fp32, scale
   ``bf16(absmax / 127)``, round half to even against the stored scale,
   ``q = 0`` where ``s == 0``), over page sizes and head layouts, all-zero
   and denormal pages, and an outlier head that must not touch the others.
2. *Attend cores* — the int8 modes of ``paged_decode_plain``,
   ``ragged_prefill_plain`` and ``paged_verify_plain`` (the plain versions
   of kernels K1, K2 and K3) against the Pallas kernels' int8 modes in
   interpret mode, held as the other kernel tests are: each element within
   one bf16 ulp of the largest magnitude in its row, never below 2^-14.
3. *Pool* — scale leaves on the payload's page axis, byte accounting equal
   to the JAX pool's (and, at full qwen2-0.5b width, 12288 -> 6336 bytes
   per token), conservation, and the COW fork and quarantine scrub walking
   the scale leaves.
4. *Engine and gate* — int8 engine tokens equal the JAX int8 engine's and
   the uncached int8 engine's (prefix-cache COW forks); the dual gate
   passes and catches a planted divergence; ``launch.serve --kv-dtype int8
   --verify``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ServeConfig as JServeConfig  # noqa: E402
from repro.configs import get_arch, reduced  # noqa: E402
from repro.kernels.paged_attention.kernel import (  # noqa: E402
    paged_decode_fwd, paged_verify_fwd)
from repro.kernels.ragged_prefill.kernel import ragged_prefill_fwd  # noqa: E402
from repro.models.attention import dequant_int8 as j_dequant  # noqa: E402
from repro.models.attention import quantize_int8 as j_quantize  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving.kv_pool import PagedKVPool as JPool  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_plain, paged_verify_plain)
from repro_torch.kernels.ragged_prefill import ragged_prefill_plain  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.attention import (dequant_int8,  # noqa: E402
                                          quantize_int8)
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (Engine, PagedKVPool,  # noqa: E402
                                 dual_gate_verify, logit_tol)
from repro_torch.serving.engine import _copy_page, _zero_pages  # noqa: E402
from test_torch_engine import seeded_params  # noqa: E402
from test_torch_kernels import _bf16, _within_one_ulp  # noqa: E402


from _torch_common import one_thread  # noqa: E402, F401


@pytest.fixture(scope="module")
def setup():
    jcfg = reduced(get_arch("qwen2-0.5b"))
    tcfg = tconfigs.reduced(tconfigs.get_arch("qwen2-0.5b"))
    jparams = seeded_params(jcfg, 0)
    tparams = params_from_numpy(tcfg, jax.device_get(jparams))
    return jcfg, tcfg, jparams, tparams


# ---------------------------------------------------------- quantize contract

def _same_as_jax(x: np.ndarray):
    """Quantize ``x`` (fp32) in both frameworks; payload, scale and the
    dequantized values must agree bit for bit.  Returns the port's
    (q, s, dequantized)."""
    jq, js = j_quantize(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js, np.float32))
    back = dequant_int8(q, s)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(j_dequant(jq, js)))
    return q, s, back


@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("K,D", [(1, 64), (2, 32), (4, 16)])
def test_quantize_matches_jax(ps, K, D):
    rng = np.random.RandomState(ps * 100 + K)
    x = (rng.randn(5, ps, K, D) * 3.0).astype(np.float32)
    # exact halves of the stored scale exercise round-half-to-even
    x[0, 0, 0, :4] = [0.5, 1.5, 2.5, -2.5]
    x[0, 0, 0, 4] = 127.0
    _same_as_jax(x)


def test_quantize_bf16_input_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 8, 2, 32).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    jq, js = j_quantize(jnp.asarray(x, jnp.bfloat16))
    q, s = quantize_int8(torch.from_numpy(xb).bfloat16())
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js, np.float32))


def test_all_zero_page_stores_zeros():
    q, s, back = _same_as_jax(np.zeros((2, 8, 2, 16), np.float32))
    assert not q.any() and not s.float().any() and not back.any()


def test_denormal_magnitudes_match_jax():
    """Scales that underflow bf16 collapse the slice to exact zeros, not
    NaN or inf; scales that survive as bf16 subnormals quantize as in
    JAX."""
    rng = np.random.RandomState(7)
    signs = np.where(rng.rand(3, 8, 2, 8) < 0.5, -1.0, 1.0).astype(np.float32)
    for mag in (1e-39, 1e-38, 1e-30):
        x = signs * mag * (0.5 + rng.rand(3, 8, 2, 8).astype(np.float32))
        _, _, back = _same_as_jax(x)
        assert torch.isfinite(back).all()
    q, s, _ = _same_as_jax(signs * np.float32(1e-39))
    assert not s.float().any() and not q.any()


def test_outlier_head_is_isolated():
    """The scale is per (token slot, kv head): a 1e4 outlier in head 0 does
    not coarsen any other head's grid."""
    rng = np.random.RandomState(8)
    base = rng.randn(1, 8, 4, 16).astype(np.float32)
    spiked = base.copy()
    spiked[..., 0, :] *= 1e4
    qb, sb, _ = _same_as_jax(base)
    qs, ss, _ = _same_as_jax(spiked)
    assert torch.equal(qb[..., 1:, :], qs[..., 1:, :])
    assert torch.equal(sb[..., 1:], ss[..., 1:])


# ------------------------------------------------------------- attend cores

def _int8_pool(rng, lengths, ps, K, D, width):
    """Shuffled int8 pages quantized from one fp32 draw in both frameworks
    (bit-identical, checked), with null-padded tables."""
    need = [-(-n // ps) for n in lengths]
    P = sum(need) + 3
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((len(lengths), width), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    j, t = [], []
    for _ in range(2):                                   # k, then v
        x = rng.randn(P, ps, K, D).astype(np.float32)
        jq, js = j_quantize(jnp.asarray(x))
        q, s, _ = _same_as_jax(x)
        j += [jq, js]
        t += [q, s]
    return j, t, tables


@pytest.mark.parametrize("ps,K,G,D,width", [(8, 2, 2, 32, 4),
                                            (16, 2, 7, 64, 3)])
def test_int8_decode_plain_matches_pallas(ps, K, G, D, width):
    rng = np.random.RandomState(ps + G)
    pos = np.array([0, ps - 1, ps, width * ps - 1], np.int32)
    B, H = len(pos), K * G
    (kq, ks, vq, vs), (tk, tks, tv, tvs), tables = _int8_pool(
        rng, pos + 1, ps, K, D, width)
    qj, qt = _bf16(rng.randn(B, H, D))
    scale = 1.0 / math.sqrt(D)
    ref = paged_decode_fwd(qj.reshape(B, K, G, D), kq, vq,
                           jnp.asarray(tables), jnp.asarray(pos),
                           scale=scale, k_scale=ks, v_scale=vs,
                           interpret=True)
    ref = np.asarray(ref, np.float32).reshape(B, H, D)
    got = paged_decode_plain(qt, tk, tv, torch.from_numpy(tables),
                             torch.from_numpy(pos), scale=scale,
                             k_scale=tks, v_scale=tvs)
    assert got.dtype == torch.bfloat16
    assert _within_one_ulp(got.float().numpy(), ref)


@pytest.mark.parametrize("ps,K,G,D,T,q_blk,starts", [
    (8, 2, 2, 32, 16, 8, (0, 8, 21)),
    (16, 2, 7, 32, 16, 16, (0, 40, 16))])
def test_int8_ragged_prefill_plain_matches_pallas(ps, K, G, D, T, q_blk,
                                                  starts):
    rng = np.random.RandomState(ps * 3 + G)
    B, H = len(starts), K * G
    start = np.array(starts, np.int32)
    width = max(-(-(s + T) // ps) for s in starts)
    (kq, ks, vq, vs), (tk, tks, tv, tvs), tables = _int8_pool(
        rng, start + T, ps, K, D, width)
    qj, qt = _bf16(rng.randn(B, T, H, D))
    scale = 1.0 / math.sqrt(D)
    ref = ragged_prefill_fwd(
        qj.reshape(B, T, K, G, D).transpose(0, 2, 1, 3, 4), kq, vq,
        jnp.asarray(tables), jnp.asarray(start),
        jnp.full((B,), T, jnp.int32), scale=scale, q_blk=q_blk,
        k_scale=ks, v_scale=vs, interpret=True)
    ref = np.asarray(ref, np.float32).transpose(0, 2, 1, 3, 4) \
        .reshape(B, T, H, D)
    got = ragged_prefill_plain(qt, tk, tv, torch.from_numpy(tables),
                               torch.from_numpy(start), scale=scale,
                               k_scale=tks, v_scale=tvs)
    assert got.dtype == torch.bfloat16
    assert _within_one_ulp(got.float().numpy(), ref)


@pytest.mark.parametrize("Q", [1, 2, 4])
def test_int8_verify_plain_matches_pallas(Q):
    ps, K, G, D, width = 8, 2, 2, 32, 5
    rng = np.random.RandomState(10 + Q)
    pos = np.concatenate([[0], rng.randint(1, width * ps - Q, size=3)]) \
        .astype(np.int32)
    n_q = np.concatenate([[1], rng.randint(1, Q + 1, size=3)]) \
        .astype(np.int32)
    B, H = len(pos), K * G
    (kq, ks, vq, vs), (tk, tks, tv, tvs), tables = _int8_pool(
        rng, pos + Q, ps, K, D, width)
    qj, qt = _bf16(rng.randn(B, Q, H, D))
    scale = 1.0 / math.sqrt(D)
    ref = paged_verify_fwd(
        qj.reshape(B, Q, K, G, D).transpose(0, 2, 1, 3, 4), kq, vq,
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(n_q),
        scale=scale, k_scale=ks, v_scale=vs, interpret=True)
    ref = np.asarray(ref, np.float32).transpose(0, 2, 1, 3, 4) \
        .reshape(B, Q, H, D)
    got = paged_verify_plain(qt, tk, tv, torch.from_numpy(tables),
                             torch.from_numpy(pos), torch.from_numpy(n_q),
                             scale=scale, k_scale=tks, v_scale=tvs)
    got = got.float().numpy()
    assert _within_one_ulp(got, ref)
    for b in range(B):
        assert not got[b, n_q[b]:].any() and not ref[b, n_q[b]:].any()


# --------------------------------------------------------------------- pool

def test_pool_scale_leaves_and_byte_accounting(setup):
    jcfg, tcfg, _, _ = setup
    kw = dict(page_size=8, max_slots=2, max_len=32)
    pool_b = PagedKVPool(tcfg, tconfigs.ServeConfig(**kw))
    pool_i = PagedKVPool(tcfg, tconfigs.ServeConfig(kv_dtype="int8", **kw))
    assert set(pool_i.kv) == {"k", "v", "k_scale", "v_scale"}
    assert set(pool_b.kv) == {"k", "v"}
    for name in ("k", "v"):
        assert pool_i.kv[name].dtype == torch.int8
        scale = pool_i.kv[f"{name}_scale"]
        assert scale.dtype == torch.bfloat16
        assert scale.shape == pool_i.kv[name].shape[:4]
    assert pool_i.total_pages == pool_b.total_pages
    assert pool_i.table_width == pool_b.table_width
    assert pool_i.page_nbytes == pool_i.kv_bytes_per_token * 8
    jpool = JPool(jcfg, JServeConfig(kv_dtype="int8", **kw))
    assert pool_i.kv_bytes_per_token == jpool.kv_bytes_per_token
    assert pool_i.kv_bytes_per_token / pool_b.kv_bytes_per_token <= 0.55


def test_full_width_bytes_per_token():
    """qwen2-0.5b at full width: 24 layers x 2 KV heads x 64 dims x K and
    V is 12288 bytes a token in bf16, 6144 + 192 of scales in int8."""
    cfg = tconfigs.get_arch("qwen2-0.5b")
    kw = dict(page_size=16, max_slots=1, max_len=16, num_pages=2)
    assert PagedKVPool(cfg, tconfigs.ServeConfig(**kw)) \
        .kv_bytes_per_token == 12288
    assert PagedKVPool(cfg, tconfigs.ServeConfig(kv_dtype="int8", **kw)) \
        .kv_bytes_per_token == 6336


def test_pool_conservation_under_int8(setup):
    _, tcfg, _, _ = setup
    pool = PagedKVPool(tcfg, tconfigs.ServeConfig(
        page_size=8, max_slots=2, max_len=32, kv_dtype="int8"))
    free0 = pool.num_free
    pages = pool.alloc(3)
    pool.share(pages[:2])
    assert pool.metrics.value("pool.pages_allocated") == 3
    assert pool.metrics.value("pool.ref_total") == 5
    pool.release(pages[:2])            # shared pages survive one release
    assert pool.num_free == free0 - 3
    pool.release(pages)
    assert pool.num_free == free0 and pool.refcounts == {}
    assert pool.conservation_ok()


def test_fork_and_scrub_walk_the_scale_leaves(setup):
    _, tcfg, _, _ = setup
    pool = PagedKVPool(tcfg, tconfigs.ServeConfig(
        page_size=8, max_slots=2, max_len=32, kv_dtype="int8"))
    for leaf in pool.kv.values():
        leaf[:, 3] = 7
    _copy_page(pool.kv, 3, 5)
    assert all((leaf[:, 5] == 7).all() for leaf in pool.kv.values())
    _zero_pages(pool.kv, [3, 5])
    assert not any(leaf[:, [3, 5]].float().any()
                   for leaf in pool.kv.values())


# ---------------------------------------------------------- engine and gate

INT8 = dict(page_size=8, max_slots=4, max_len=48, kv_dtype="int8")


def _serve(tcfg, tparams, prompts, budgets, **kw):
    eng = Engine(tcfg, tconfigs.ServeConfig(**kw), tparams, device="cpu")
    with torch.no_grad():
        res, m = eng.run_offline(prompts, budgets)
    return eng, [r.tokens for r in res], m


def test_int8_engine_matches_jax_int8_engine(setup):
    """Same family prefix, diverging mid-page: the prefix cache shares full
    pages and COW-forks the partial one (payload and scales), chunked
    prefill splits the prompts; tokens equal the JAX int8 engine's and the
    uncached int8 engine's."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.RandomState(5)
    fam = rng.randint(1, tcfg.vocab, size=18).tolist()
    prompts = [fam + rng.randint(1, tcfg.vocab, size=n).tolist()
               for n in (6, 11, 3, 9)]
    budgets = [6, 9, 4, 7]
    kw = dict(INT8, prefix_cache=True, prefill_chunk_tokens=16)
    eng, tokens, m = _serve(tcfg, tparams, prompts, budgets, **kw)
    assert m["cached_tokens"] > 0
    assert eng.metrics.value("engine.cow_forks") > 0
    assert eng.pool.conservation_ok()
    jeng = JEngine(jcfg, JServeConfig(**kw), jparams)
    assert tokens == [r.tokens for r in jeng.run_offline(prompts,
                                                         budgets)[0]]
    _, uncached, _ = _serve(tcfg, tparams, prompts, budgets, **INT8)
    assert tokens == uncached


def test_dual_gate_passes(setup):
    _, tcfg, _, tparams = setup
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, tcfg.vocab, size=int(rng.randint(4, 20)))
               .tolist() for _ in range(3)]
    _, tokens, _ = _serve(tcfg, tparams, prompts, 6, **INT8)
    with torch.no_grad():
        rep = dual_gate_verify(tcfg, tconfigs.ServeConfig(**INT8), tparams,
                               prompts, tokens)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}
    assert rep["tol"] == logit_tol(tcfg) == 0.25
    assert rep["max_logit_err"] > 0                # int8 really differs
    assert rep["replay_failures"] == 0 and rep["high_margin_tokens"] > 0


def test_dual_gate_catches_a_planted_divergence(setup):
    _, tcfg, _, tparams = setup
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, tcfg.vocab, size=12).tolist()]
    _, tokens, _ = _serve(tcfg, tparams, prompts, 4, **INT8)
    bad = list(tokens[0])
    bad[0] = (bad[0] + 1) % tcfg.vocab
    with torch.no_grad():
        rep = dual_gate_verify(tcfg, tconfigs.ServeConfig(**INT8), tparams,
                               prompts, [bad])
    assert not rep["ok"] and rep["replay_failures"] == 1


def test_cli_int8_verify_on_cpu(capsys):
    tokens = tserve.main([
        "--device", "cpu", "--arch", "qwen2-0.5b", "--reduced",
        "--requests", "6", "--mixed", "--prompt-len", "40", "--kv-dtype",
        "int8", "--prefix-cache", "--shared-prefix", "2", "--verify"])
    out = capsys.readouterr().out
    assert len(tokens) == 6
    assert "int8 pages" in out and "dual gate passed for 6 requests" in out
