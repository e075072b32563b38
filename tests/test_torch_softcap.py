"""The attention logit softcap (``cfg.attn_logit_softcap``: every scaled
score becomes ``c * tanh(s / c)`` before the mask) in the port against the
JAX package, on the CPU.

1. The plain versions of K1-K4 with a cap against the Pallas kernels they
   replace, run in interpret mode through their public wrappers:
   ``paged_decode_fwd`` (causal and ring, bf16 and int8 pages),
   ``paged_verify_fwd`` (60 rows a KV head: G = 12 at Q = 5; a ring with
   int8 pages), ``ragged_prefill_fwd`` (bf16 at head dim 32, int8 at 128)
   and ``windowed_ragged_prefill_fwd`` (bf16 and int8 rings).  Each at cap
   30 with queries scaled so the largest scores reach about the cap, and
   in a saturating case (queries x 64: the largest |s| at least 3 x the
   cap).  Each case also holds the capped output apart from the uncapped
   one by more than the tolerance, so a cap that is dropped fails.
2. Reduced qwen2-0.5b and starcoder2-7b engines with a cap against the
   JAX engine: the dual gate (max |dlogit| <= 0.25, no greedy mismatch
   where the JAX margin exceeds twice the observed error) along the port's
   tokens, and tokens equal to the JAX engine's up to the first position
   where the JAX margin lies within twice the observed error (starcoder2-
   7b's are all equal; one qwen2-0.5b request parts at such a position);
   the capped tokens part from the uncapped engine's.
3. Reduced qwen2-0.5b's loss and gradients with a cap against JAX's
   ``loss`` and ``jax.grad`` in fp32, and reduced seamless-m4t-large-v2's
   capped encoder (whose JAX ``full_attention_block`` reads the cap)
   against JAX's ``encode`` in bf16.

Random weights give pre-cap scores of std d_model * std(wq) * std(wk)
(unit-RMS inputs; 0.18 at these reduced widths), where a cap barely acts:
the models here draw every self-attention ``wq`` at the gain that gives
the scores std ``SCORE_SD``, and take cap ``MODEL_CAP``.  Tolerances as the files they extend:
kernels within one bf16 ulp of the row's largest |value| (never below
2^-14, ``tests/test_torch_kernels.py``); fp32 loss within 1e-5 and
gradients within 1e-5 relative L2 (``tests/test_torch_train.py``); the
bf16 encoder output within 2 bf16 ulps of each row's largest |JAX value|
(``tests/test_torch_encdec.py``).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ServeConfig as JServeConfig  # noqa: E402
from repro.configs import get_arch, reduced  # noqa: E402
from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention_decode, paged_attention_verify)
from repro.kernels.ragged_prefill.ops import ragged_prefill_attend  # noqa: E402
from repro.models.registry import build_model as j_build  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving.quant_verify import replay_logits as j_replay  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode, paged_decode_plain, paged_verify_plain)
from repro_torch.kernels.ragged_prefill import (  # noqa: E402
    ragged_prefill, ragged_prefill_plain, windowed_prefill_plain)
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import (tree_leaves, tree_map,  # noqa: E402
                                       tree_unflatten)
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import Engine, dual_gate, replay_logits  # noqa: E402
from test_torch_engine import seeded_params  # noqa: E402
from test_torch_kernels import (_bf16, _pool_and_tables,  # noqa: E402
                                _within_one_ulp)
from test_torch_window import _quantized, _ring_pool  # noqa: E402
from test_torch_window_engine import _assert_equal_or_low_margin  # noqa: E402

from _torch_common import one_thread  # noqa: E402, F401

CAP = 30.0                     # the kernel cases' cap
GAINS = {"at_cap": 16.0, "saturating": 64.0}    # query gains (exact in bf16)
SCORE_SD = 2.0                 # the models' pre-cap score std
MODEL_CAP = 5.0                # the models' cap: about 2.5 x SCORE_SD
TOL = 0.25


def _max_score(q, kg, valid, scale):
    """The largest |scaled score| of a visible key: q [B, Q, H, D], kg [B,
    S, K, D] (repeated to the query heads), valid [B, Q, S]."""
    H, K = q.shape[2], kg.shape[2]
    kh = kg.float().repeat_interleave(H // K, 2)
    s = torch.einsum("bqhd,bshd->bqhs", q.float(), kh).abs() * scale
    return float(s.masked_fill(~valid[:, :, None, :], 0).max())


def _check(got, ref, uncapped, saturating, max_s):
    """``got`` (port, capped) within one row ulp of ``ref`` (Pallas,
    capped), the capped output apart from ``uncapped``, and in the
    saturating case scores of at least 3 x the cap."""
    assert _within_one_ulp(got, ref)
    assert not _within_one_ulp(uncapped, ref)
    assert max_s >= (3 * CAP if saturating else 0.5 * CAP), max_s


# ------------------------------------------------------------- K1 decode

@pytest.mark.parametrize("gain", GAINS, ids=list(GAINS))
@pytest.mark.parametrize("window,int8", [(0, False), (0, True), (20, False),
                                         (20, True)])
def test_decode_plain_matches_pallas(window, int8, gain):
    rng = np.random.RandomState(41 + window + int8)
    B, K, H, D, ps = 2, 2, 4, 32, 8
    if window:
        (kj, kt), (vj, vt), tables = _ring_pool(rng, B, 4, ps, K, D)
        pos = np.array([45, 13], np.int32)
    else:
        (kj, kt), (vj, vt), tables = _pool_and_tables(rng, [30, 9], ps, K, D,
                                                      4)
        pos = np.array([29, 8], np.int32)
    qj, qt = _bf16(rng.randn(B, H, D) * GAINS[gain])
    jkw, tkw = {}, {}
    if int8:
        ((kj, ksj), (kt, kst)), ((vj, vsj), (vt, vst)) = _quantized(kt, vt)
        jkw, tkw = dict(k_scale=ksj, v_scale=vsj), dict(k_scale=kst,
                                                        v_scale=vst)
    scale = 1.0 / math.sqrt(D)
    ref = paged_attention_decode(qj, kj, vj, jnp.asarray(tables),
                                 jnp.asarray(pos), scale=scale, softcap=CAP,
                                 window=window, interpret=True, **jkw)
    args = (qt, kt, vt, torch.from_numpy(tables), torch.from_numpy(pos))
    got = paged_decode_plain(*args, scale=scale, window=window, softcap=CAP,
                             **tkw)
    # the wrapper runs the plain version on the CPU, cap and all
    n0 = paged_decode.launches
    assert torch.equal(paged_decode(*args, scale=scale, window=window,
                                    softcap=CAP, **tkw), got)
    assert paged_decode.launches == n0
    uncapped = paged_decode_plain(*args, scale=scale, window=window, **tkw)
    from repro_torch.models.attention import decode_valid_mask, gather_kv
    kg, _ = gather_kv(kt, vt, args[3], tkw.get("k_scale"),
                      tkw.get("v_scale"))
    valid = decode_valid_mask(args[4], kg.shape[1], window=window)
    _check(got.float().numpy(), np.asarray(ref, np.float32),
           uncapped.float().numpy(), gain == "saturating",
           _max_score(qt[:, None], kg, valid[:, None], scale))


# ------------------------------------------------------------- K3 verify

@pytest.mark.parametrize("gain", GAINS, ids=list(GAINS))
@pytest.mark.parametrize("H,window,int8", [(24, 0, False), (4, 20, True)])
def test_verify_plain_matches_pallas(H, window, int8, gain):
    rng = np.random.RandomState(43 + H + int8)
    B, K, D, ps, Q = 3, 2, 32, 8, 5
    n_q = np.array([5, 2, 3], np.int32)
    if window:
        (kj, kt), (vj, vt), tables = _ring_pool(rng, B, 4, ps, K, D)
        pos = np.array([44, 10, 30], np.int32)
    else:
        (kj, kt), (vj, vt), tables = _pool_and_tables(rng, [30, 12, 20], ps,
                                                      K, D, 4)
        pos = np.array([25, 10, 17], np.int32)
    qj, qt = _bf16(rng.randn(B, Q, H, D) * GAINS[gain])
    jkw, tkw = {}, {}
    if int8:
        ((kj, ksj), (kt, kst)), ((vj, vsj), (vt, vst)) = _quantized(kt, vt)
        jkw, tkw = dict(k_scale=ksj, v_scale=vsj), dict(k_scale=kst,
                                                        v_scale=vst)
    scale = 1.0 / math.sqrt(D)
    ref = paged_attention_verify(qj, kj, vj, jnp.asarray(tables),
                                 jnp.asarray(pos), jnp.asarray(n_q),
                                 scale=scale, softcap=CAP, window=window,
                                 interpret=True, **jkw)
    args = (qt, kt, vt, torch.from_numpy(tables), torch.from_numpy(pos),
            torch.from_numpy(n_q))
    got = paged_verify_plain(*args, scale=scale, window=window, softcap=CAP,
                             **tkw)
    uncapped = paged_verify_plain(*args, scale=scale, window=window, **tkw)
    from repro_torch.models.attention import gather_kv, verify_valid_mask
    kg, _ = gather_kv(kt, vt, args[3], tkw.get("k_scale"),
                      tkw.get("v_scale"))
    valid = verify_valid_mask(args[4], args[5], Q, kg.shape[1],
                              window=window)
    _check(got.float().numpy(), np.asarray(ref, np.float32),
           uncapped.float().numpy(), gain == "saturating",
           _max_score(qt, kg, valid, scale))
    dead = np.arange(Q)[None, :] >= n_q[:, None]
    assert (got.float().numpy()[dead] == 0).all()


# ------------------------------------------------------ K2 ragged prefill

@pytest.mark.parametrize("gain", GAINS, ids=list(GAINS))
@pytest.mark.parametrize("D,int8", [(32, False), (128, True)])
def test_ragged_prefill_plain_matches_pallas(D, int8, gain):
    rng = np.random.RandomState(47 + D + int8)
    B, T, K, H, ps = 2, 16, 2, 4, 8
    starts = np.array([8, 0], np.int32)
    (kj, kt), (vj, vt), tables = _pool_and_tables(
        rng, [int(s) + T for s in starts], ps, K, D, 4)
    qj, qt = _bf16(rng.randn(B, T, H, D) * GAINS[gain])
    jkw, tkw = {}, {}
    if int8:
        ((kj, ksj), (kt, kst)), ((vj, vsj), (vt, vst)) = _quantized(kt, vt)
        jkw, tkw = dict(k_scale=ksj, v_scale=vsj), dict(k_scale=kst,
                                                        v_scale=vst)
    scale = 1.0 / math.sqrt(D)
    live = np.full(B, T, np.int32)
    ref = ragged_prefill_attend(qj, qj, qj, kj, vj, jnp.asarray(tables),
                                jnp.asarray(starts), jnp.asarray(live),
                                softcap=CAP, q_blk=8, interpret=True, **jkw)
    args = (qt, kt, vt, torch.from_numpy(tables), torch.from_numpy(starts))
    got = ragged_prefill_plain(*args, scale=scale, softcap=CAP, **tkw)
    n0 = ragged_prefill.launches
    assert torch.equal(ragged_prefill(*args, scale=scale, softcap=CAP,
                                      **tkw), got)
    assert ragged_prefill.launches == n0
    uncapped = ragged_prefill_plain(*args, scale=scale, **tkw)
    from repro_torch.models.attention import gather_kv
    kg, _ = gather_kv(kt, vt, args[3], tkw.get("k_scale"),
                      tkw.get("v_scale"))
    qpos = args[4][:, None] + torch.arange(T)[None, :]
    valid = torch.arange(kg.shape[1])[None, None, :] <= qpos[:, :, None]
    _check(got.float().numpy(), np.asarray(ref, np.float32),
           uncapped.float().numpy(), gain == "saturating",
           _max_score(qt, kg, valid, scale))


# --------------------------------------------------- K4 windowed prefill

@pytest.mark.parametrize("gain", GAINS, ids=list(GAINS))
@pytest.mark.parametrize("int8", [False, True])
def test_windowed_prefill_plain_matches_pallas(int8, gain):
    rng = np.random.RandomState(53 + int8)
    B, T, K, H, D, ps, n_ring, window = 2, 16, 2, 4, 32, 8, 5, 32
    (kj, kt), (vj, vt), tables = _ring_pool(rng, B, n_ring, ps, K, D)
    qj, qt = _bf16(rng.randn(B, T, H, D) * GAINS[gain])
    knj, knt = _bf16(rng.randn(B, T, K, D))
    vnj, vnt = _bf16(rng.randn(B, T, K, D))
    start = np.array([45, 0], np.int32)
    live = np.array([16, 11], np.int32)
    jkw, tkw = {}, {}
    if int8:
        ((kj, ksj), (kt, kst)), ((vj, vsj), (vt, vst)) = _quantized(kt, vt)
        jkw, tkw = dict(k_scale=ksj, v_scale=vsj), dict(k_scale=kst,
                                                        v_scale=vst)
    ref = ragged_prefill_attend(qj, knj, vnj, kj, vj, jnp.asarray(tables),
                                jnp.asarray(start), jnp.asarray(live),
                                window=window, softcap=CAP, q_blk=8,
                                interpret=True, **jkw)
    ref = np.asarray(ref, np.float32)
    args = (qt, knt, vnt, kt, vt, torch.from_numpy(tables),
            torch.from_numpy(start), torch.from_numpy(live))
    kw = dict(window=window, scale=1.0 / math.sqrt(D), **tkw)
    got = windowed_prefill_plain(*args, softcap=CAP, **kw).float().numpy()
    uncapped = windowed_prefill_plain(*args, **kw).float().numpy()
    from repro_torch.models.attention import gather_kv, ring_chunk_mask
    kr, _ = gather_kv(kt, vt, args[5], tkw.get("k_scale"),
                      tkw.get("v_scale"))
    kc = torch.cat([kr.float(), knt.float()], 1)
    seen = ring_chunk_mask(args[6], args[7], kr.shape[1], T, window)
    max_s = _max_score(qt, kc, seen, kw["scale"])
    for b in range(B):       # rows past n_live: padding the caller drops
        n = live[b]
        assert (got[b, n:] == 0).all()
        assert _within_one_ulp(got[b, :n], ref[b, :n])
    assert not _within_one_ulp(uncapped[0], ref[0])
    assert max_s >= (3 * CAP if gain == "saturating" else 0.5 * CAP), max_s


# --------------------------------------------------- reduced models

def _gained(jparams):
    """The JAX parameter tree with every self-attention ``wq`` (not the
    cross-attention's, whose scores JAX does not cap) times the gain that
    gives pre-cap scores of std ``SCORE_SD``."""
    def walk(node, key=""):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v, k) for k, v in node.items()}
        if key in ("attn", "self_attn") and "wq" in out:
            wq = np.asarray(out["wq"], np.float32)
            gain = SCORE_SD / (wq.shape[-3] * wq.std()
                               * np.asarray(out["wk"], np.float32).std())
            out["wq"] = jnp.asarray(wq * gain, out["wq"].dtype)
        return out
    return walk(jparams)


def _pair(arch, cap=MODEL_CAP, fp32=False, **over):
    """(jax cfg, torch cfg, jax params, torch params) of reduced ``arch``
    at softcap ``cap``, with the gained ``wq``."""
    jcfg = dataclasses.replace(reduced(get_arch(arch)),
                               attn_logit_softcap=cap, **over)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch(arch)),
                               attn_logit_softcap=cap)
    jp = _gained(seeded_params(jcfg, 0))
    tp = params_from_numpy(tcfg, jax.device_get(jp))
    if fp32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        tp = tree_map(lambda t: t.float(), tp)
    return jcfg, tcfg, jp, tp


ENGINES = {
    "qwen2-0.5b": (dict(page_size=8, max_slots=3, max_len=64,
                        prefix_cache=True, prefill_chunk_tokens=16),
                   (12, 30, 40), (8, 6, 10)),
    # window 32 over a 5-page ring of 8: prompts past the window wrap it
    "starcoder2-7b": (dict(page_size=8, max_slots=3, max_len=96,
                           prefill_chunk_tokens=16),
                      (40, 9, 57), (12, 8, 10)),
}


@pytest.fixture(scope="module", params=list(ENGINES))
def engines(request):
    """The JAX engine and the port's, capped, on the same prompts; the
    port's uncapped engine too."""
    arch = request.param
    scfg, lens, budgets = ENGINES[arch]
    jcfg, tcfg, jp, tp = _pair(arch)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, jcfg.vocab, size=n).tolist() for n in lens]
    jtokens = [r.tokens for r in JEngine(jcfg, JServeConfig(**scfg), jp)
               .run_offline(prompts, list(budgets))[0]]

    def serve(cfg):
        eng = Engine(cfg, tconfigs.ServeConfig(**scfg), tp, device="cpu")
        with torch.no_grad():
            return [r.tokens for r in eng.run_offline(prompts,
                                                      list(budgets))[0]]
    uncapped = serve(dataclasses.replace(tcfg, attn_logit_softcap=0.0))
    return (jcfg, tcfg, jp, tp, scfg, prompts, serve(tcfg), jtokens,
            uncapped)


def test_capped_engine_matches_jax_engine(engines):
    jcfg, tcfg, jp, tp, scfg, prompts, tokens, jtokens, uncapped = engines
    # exact, or parting first where JAX's top two logits lie within twice
    # the observed error (the dual gate's allowance)
    _assert_equal_or_low_margin(jcfg, tcfg, jp, tp, prompts, tokens,
                                jtokens, scfg)
    assert tokens != uncapped                # the cap changed the stream
    # the JAX paged replay runs eagerly (seconds a request): two requests
    pick = [0, 2]
    ref = [j_replay(jcfg, JServeConfig(**scfg), jp, prompts[i], tokens[i],
                    kv_dtype="bf16") for i in pick]
    with torch.no_grad():
        test = [replay_logits(tcfg, tconfigs.ServeConfig(**scfg), tp,
                              prompts[i], tokens[i]) for i in pick]
    rep = dual_gate(ref, test, [tokens[i] for i in pick], tol=TOL)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def test_capped_loss_and_grads_match_jax():
    jcfg, tcfg, jp, tp = _pair("qwen2-0.5b", fp32=True)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab, (2, 48)) \
        .astype(np.int32)
    jm = j_build(jcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
            jp, {"tokens": jnp.asarray(toks)})
    leaves = [p.detach().requires_grad_(True) for _, p in tree_leaves(tp)]
    tl, _ = build_model(tcfg).loss(tree_unflatten(tp, leaves),
                                   {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(tl, leaves)
    assert abs(tl.item() - float(jl)) <= 1e-5
    want = {p: np.asarray(v, np.float32)
            for p, v in tree_leaves(jax.device_get(jg))}
    for (p, _), g in zip(tree_leaves(tp), grads):
        w = want[p]
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= 1e-5, (p, rel)
    # the cap changes the loss at these weights
    with torch.no_grad():
        free, _ = build_model(dataclasses.replace(
            tcfg, attn_logit_softcap=0.0)).loss(
                tp, {"tokens": torch.from_numpy(toks)})
    assert abs(free.item() - tl.item()) > 1e-4


def test_capped_encoder_matches_jax():
    from repro_torch.serving.engine import _synthetic_frontend
    jcfg, tcfg, jp, tp = _pair("seamless-m4t-large-v2", remat="none")
    scfg = tconfigs.ServeConfig(page_size=8, max_slots=2, max_len=48)
    frames = np.stack([_synthetic_frontend(tcfg, scfg, 0, i)
                       for i in range(2)])
    want = np.asarray(jax.jit(j_build(jcfg).encode)(
        jp, jnp.asarray(frames)), np.float32)
    with torch.no_grad():
        got = build_model(tcfg).encode(tp, torch.as_tensor(frames))
        free = build_model(dataclasses.replace(
            tcfg, attn_logit_softcap=0.0)).encode(tp,
                                                  torch.as_tensor(frames))
    got, free = got.float().numpy(), free.float().numpy()
    top = np.maximum(np.abs(want).max(-1, keepdims=True), 2.0 ** -14)
    ulp = np.exp2(np.floor(np.log2(top)) - 7)
    assert (np.abs(got - want) <= 2 * ulp + 2.0 ** -14).all()
    assert not (np.abs(free - want) <= 2 * ulp + 2.0 ** -14).all()
