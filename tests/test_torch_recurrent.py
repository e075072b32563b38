"""The state-slot families' modules on the CPU against the JAX package:
reduced mamba2-780m (SSD) and recurrentgemma-2b (RG-LRU + a local-attention
ring of window 32).

1. ``ssd_chunked`` and ``ssm_block`` (with and without ``length_mask`` and
   ``init_state``, S not a multiple of the chunk) in fp32: relative error
   (max |port - JAX| over max |JAX|) within 1e-5.
2. The RG-LRU scan (``rglru.associative_scan``, the port of
   ``jax.lax.associative_scan``'s recursion) fed the same fp32 ``a``, ``b``
   as JAX's scan: ``h`` bit-equal (the running product of the ``a``s too,
   once its fp32 subnormals are flushed to zero as XLA's CPU backend
   flushes them); ``rglru_block`` in fp32 within 1e-5.
3. Both decode blocks in fp32 within 1e-5, their in-place cache writes
   equal to the caches JAX returns within 1e-5.
4. The state-slot prefill (``prefill_paged`` into a ``StateSlotPool``) of
   prompts shorter than ``conv_width - 1``: the conv taps zero where JAX's
   are, and the hybrid ring past a wrap (prompts longer than the window)
   against JAX's ``_prefill_state_slots``, within 2^-5 of the largest
   |value|: eight bf16 epsilons, for values that went through two bf16
   layers (a key in the wrong ring slot is off by its whole size).
5. The static prefill + decode of both archs against the JAX model,
   teacher-forced along the port's greedy tokens: the dual gate (max
   |dlogit| <= 0.25, no greedy mismatch where the JAX margin exceeds twice
   the observed error), decoding past the ring's wrap.

Parameters are drawn with numpy from a seed (``seeded_params``), not with
``repro``'s ``init_params``, which depends on PYTHONHASHSEED.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ServeConfig as JServeConfig  # noqa: E402
from repro.configs import get_arch, reduced  # noqa: E402
from repro.models import rglru as j_rglru  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models.attn_backend import \
    prefill_meta as j_prefill_meta  # noqa: E402
from repro.models.registry import build_model as j_build  # noqa: E402
from repro.serving.kv_pool import StateSlotPool as JStateSlotPool  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402
from repro_torch.models.attn_backend import (meta_to_device,  # noqa: E402
                                             prefill_meta)
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.registry import build_model, init_cache  # noqa: E402
from repro_torch.serving import StateSlotPool, dual_gate  # noqa: E402
from test_torch_engine import seeded_params  # noqa: E402
from test_torch_window_engine import _jax_static_logits  # noqa: E402

TOL = 0.25
REL = 1e-5
ARCHS = ["mamba2-780m", "recurrentgemma-2b"]


from _torch_common import one_thread  # noqa: E402, F401


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = reduced(get_arch(request.param))
    tcfg = tconfigs.reduced(tconfigs.get_arch(request.param))
    jparams = seeded_params(jcfg, 0)
    tparams = params_from_numpy(tcfg, jax.device_get(jparams))
    return jcfg, tcfg, jparams, tparams


def _rel(test, ref):
    test = np.asarray(test, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(test - ref)) / np.max(np.abs(ref)))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _fp32_block(tree, group="blocks", key="ssm"):
    """Layer 0's block parameters of a numpy-able tree, as fp32 numpy."""
    return {k: np.asarray(v[0], np.float32)
            for k, v in jax.device_get(tree[group][key]).items()}


# ------------------------------------------------------------------- SSD

@pytest.mark.parametrize("s,with_init", [(45, False), (64, True),
                                         (7, False)])
def test_ssd_chunked_matches_jax_fp32(s, with_init):
    """Chunk 16: 45 is two chunks and a padded third, 64 four whole chunks,
    7 a single short chunk."""
    rng = np.random.RandomState(s)
    b, h, p, n = 2, 3, 8, 16
    xd = rng.randn(b, s, h, p).astype(np.float32)
    dtA = -rng.uniform(0.05, 1.5, (b, s, h)).astype(np.float32)
    B = rng.randn(b, s, n).astype(np.float32)
    C = rng.randn(b, s, n).astype(np.float32)
    s0 = rng.randn(b, h, p, n).astype(np.float32) if with_init else None
    jy, jf = jax.jit(j_ssm.ssd_chunked, static_argnums=4)(
        *map(jnp.asarray, (xd, dtA, B, C)), 16,
        None if s0 is None else jnp.asarray(s0))
    ty, tf = ssm.ssd_chunked(*map(_t, (xd, dtA, B, C)), 16,
                             None if s0 is None else _t(s0))
    assert ty.dtype == tf.dtype == torch.float32
    assert _rel(ty, jy) < REL and _rel(tf, jf) < REL


@pytest.mark.parametrize("masked,with_init", [(False, False), (True, False),
                                              (True, True)])
def test_ssm_block_matches_jax_fp32(masked, with_init):
    """The whole SSD block (projections, convs, scan, gated norm) in fp32
    at the reduced config's chunk of 32, S = 45; with a length mask the
    final state is the state after each row's last real position."""
    jcfg = reduced(get_arch("mamba2-780m"))
    tcfg = tconfigs.reduced(tconfigs.get_arch("mamba2-780m"))
    p = _fp32_block(seeded_params(jcfg, 2))
    rng = np.random.RandomState(3)
    S = 45
    x = rng.randn(2, S, jcfg.d_model).astype(np.float32)
    mask = np.arange(S)[None, :] < np.array([[S], [29]])
    s0 = rng.randn(2, jcfg.ssm_n_heads, jcfg.ssm_head_dim,
                   jcfg.ssm_state).astype(np.float32) if with_init else None
    jy, jf = jax.jit(functools.partial(j_ssm.ssm_block, jcfg))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        init_state=None if s0 is None else jnp.asarray(s0),
        length_mask=jnp.asarray(mask) if masked else None)
    ty, tf = ssm.ssm_block(
        tcfg, {k: _t(v) for k, v in p.items()}, _t(x),
        init_state=None if s0 is None else _t(s0),
        length_mask=torch.as_tensor(mask) if masked else None)
    assert _rel(ty, jy) < REL and _rel(tf, jf) < REL
    if masked:
        # the masked row's final state is the state at its 29th token
        _, f29 = ssm.ssm_block(
            tcfg, {k: _t(v) for k, v in p.items()}, _t(x[1:, :29]),
            init_state=None if s0 is None else _t(s0[1:]))
        assert _rel(tf[1:], f29) < REL


# ---------------------------------------------------------------- RG-LRU

def _jax_scan(a, b):
    def combine(left, right):          # rglru.rglru_block's combine
        al, bl = left
        ar, br = right
        return al * ar, ar * bl + br
    return jax.lax.associative_scan(combine, (jnp.asarray(a),
                                              jnp.asarray(b)), axis=1)


@pytest.mark.parametrize("s", [1, 100])
def test_rglru_scan_bit_equal_to_jax(s):
    """The same fp32 a, b (the gates of a random input) through the port's
    scan and JAX's eager ``associative_scan`` (jitted, XLA fuses its
    multiply-adds): bit for bit.  The recursion meets even and odd lengths
    (100, 50, 25, 12, 6, 3), so both of its even-fill branches."""
    jcfg = reduced(get_arch("recurrentgemma-2b"))
    tcfg = tconfigs.reduced(tconfigs.get_arch("recurrentgemma-2b"))
    p = params_from_numpy(tcfg, jax.device_get(seeded_params(jcfg, 1)))
    p = {k: v[0] for k, v in p["rec_blocks"]["rec"].items()}
    rng = np.random.RandomState(s)
    u = torch.from_numpy(rng.randn(2, s, jcfg.d_rnn).astype(np.float32))
    a, b = (t.numpy() for t in rglru.gates(p, u.to(torch.bfloat16)))
    ja, jh = _jax_scan(a, b)
    ta, th = rglru.associative_scan(_t(a), _t(b))
    assert np.array_equal(np.asarray(jh), th.numpy())
    tiny = np.finfo(np.float32).tiny
    ta = ta.numpy()
    assert np.array_equal(np.asarray(ja), np.where(np.abs(ta) < tiny, 0, ta))


@pytest.mark.parametrize("masked,with_init", [(False, False), (True, True)])
def test_rglru_block_matches_jax_fp32(masked, with_init):
    jcfg = reduced(get_arch("recurrentgemma-2b"))
    tcfg = tconfigs.reduced(tconfigs.get_arch("recurrentgemma-2b"))
    p = _fp32_block(seeded_params(jcfg, 1), "rec_blocks", "rec")
    rng = np.random.RandomState(4)
    S = 45
    x = rng.randn(2, S, jcfg.d_model).astype(np.float32)
    mask = np.arange(S)[None, :] < np.array([[S], [20]])
    s0 = rng.randn(2, jcfg.d_rnn).astype(np.float32) if with_init else None
    jy, jf = jax.jit(functools.partial(j_rglru.rglru_block, jcfg))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        init_state=None if s0 is None else jnp.asarray(s0),
        length_mask=jnp.asarray(mask) if masked else None)
    ty, tf = rglru.rglru_block(
        tcfg, {k: _t(v) for k, v in p.items()}, _t(x),
        init_state=None if s0 is None else _t(s0),
        length_mask=torch.as_tensor(mask) if masked else None)
    assert _rel(ty, jy) < REL and _rel(tf, jf) < REL


# ----------------------------------------------------------- decode blocks

@pytest.mark.parametrize("name", ARCHS)
def test_decode_blocks_match_jax_fp32(name):
    """Four steps of each decode block from a random cache, in fp32: the
    outputs and the in-place cache writes against JAX's returned caches."""
    jcfg = reduced(get_arch(name))
    tcfg = tconfigs.reduced(tconfigs.get_arch(name))
    rng = np.random.RandomState(5)
    B = 3
    if name == "mamba2-780m":
        p = _fp32_block(seeded_params(jcfg, 2))
        j_block, t_block = j_ssm.ssm_decode_block, ssm.ssm_decode_block
        defs = ssm.ssm_cache_defs(tcfg, B)
    else:
        p = _fp32_block(seeded_params(jcfg, 1), "rec_blocks", "rec")
        j_block, t_block = j_rglru.rglru_decode_block, \
            rglru.rglru_decode_block
        defs = rglru.rglru_cache_defs(tcfg, B)
    cache = {k: rng.randn(*d.shape).astype(np.float32)
             for k, d in defs.items()}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    tc = {k: _t(v) for k, v in cache.items()}
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: _t(v) for k, v in p.items()}
    j_step = jax.jit(functools.partial(j_block, jcfg))
    for _ in range(4):
        x = rng.randn(B, jcfg.d_model).astype(np.float32)
        jy, jc = j_step(jp, jnp.asarray(x), jc)
        ty = t_block(tcfg, tp, _t(x), tc)
        assert _rel(ty, jy) < REL
        for k in cache:
            assert _rel(tc[k], jc[k]) < REL, k


# ----------------------------------------------------- state-slot prefill

def _slot_prefill(jcfg, tcfg, jparams, tparams, prompts, max_len):
    """Prefill ``prompts`` (one row each, right-padded to a page multiple)
    into slots 2, 0, ... of a 3-slot state pool in JAX and in the port;
    returns (JAX state tree as numpy, port state tree, JAX logits, port
    logits)."""
    ps, B = 8, len(prompts)
    T = -(-max(len(p) for p in prompts) // ps) * ps
    toks = np.zeros((B, T), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    slots = np.array([2, 0, 1][:B], np.int32)
    start = np.zeros((B,), np.int32)
    n_tail = np.array([len(p) for p in prompts], np.int32)
    tables = np.zeros((B, 1), np.int32)
    jscfg = JServeConfig(page_size=ps, max_slots=3, max_len=max_len)
    jpool = JStateSlotPool(jcfg, jscfg)
    jmeta = {k: jnp.asarray(v) for k, v in j_prefill_meta(
        jcfg, ps, tables, slots, start, n_tail, T).items()}
    jl, _, jstate = jax.jit(j_build(jcfg).prefill_paged)(
        jparams, {}, jpool.state, jmeta, jnp.asarray(toks))
    tpool = StateSlotPool(tcfg, tconfigs.ServeConfig(
        page_size=ps, max_slots=3, max_len=max_len))
    meta = meta_to_device(prefill_meta(tcfg, ps, tables, slots, start,
                                       n_tail, T), "cpu")
    with torch.no_grad():
        tl, _, tstate = build_model(tcfg).prefill_paged(
            tparams, {}, tpool.state, meta, torch.as_tensor(toks))
    return jax.device_get(jstate), tstate, np.asarray(jl, np.float32), \
        tl.float().numpy()


def test_conv_tail_of_short_prompts(arch):
    """Prompts of 1 and 2 tokens (conv_width - 1 = 3): each row's conv taps
    hold zeros before its prompt, exactly where JAX's do, and its tokens
    after them; slot 1, which no row targets, stays zero."""
    jcfg, tcfg, jparams, tparams = arch
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, jcfg.vocab, size=n).tolist() for n in (1, 2)]
    jstate, tstate, jl, tl = _slot_prefill(jcfg, tcfg, jparams, tparams,
                                           prompts, 48)
    ssm_arch = jcfg.family == "ssm"
    group = "blocks" if ssm_arch else "rec_blocks"
    for k in ("conv_x", "conv_B", "conv_C") if ssm_arch else ("conv",):
        j = np.asarray(jstate[group][k], np.float32)
        t = tstate[group][k].float().numpy()
        assert np.array_equal(j == 0, t == 0), k
        assert not t[:, 1].any()                       # no row targets it
        assert not t[:, 2, :2].any() and t[:, 2, 2].any()   # 1 token
        assert not t[:, 0, :1].any() and t[:, 0, 1].any()   # 2 tokens
        assert np.max(np.abs(j - t)) <= 2 ** -7 * np.max(np.abs(j)), k
    rep = dual_gate([jl], [tl], [jl.argmax(-1)], tol=TOL)
    assert rep["ok"], rep["max_logit_err"]


def test_hybrid_ring_past_a_wrap():
    """Prompts of 45 and 33 tokens into a ring of 32 (window 32): each row's
    last 32 keys at ring slots t % 32, and the recurrent states, equal to
    JAX's within 2^-5 of the largest |value|."""
    jcfg = reduced(get_arch("recurrentgemma-2b"))
    tcfg = tconfigs.reduced(tconfigs.get_arch("recurrentgemma-2b"))
    assert jcfg.attn_window == tcfg.attn_window == 32
    jparams = seeded_params(jcfg, 0)
    tparams = params_from_numpy(tcfg, jax.device_get(jparams))
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, jcfg.vocab, size=n).tolist() for n in (45, 33)]
    jstate, tstate, jl, tl = _slot_prefill(jcfg, tcfg, jparams, tparams,
                                           prompts, 64)
    assert tstate["attn_blocks"]["k"].shape[2] == 32
    for k in ("k", "v"):
        j = np.asarray(jstate["attn_blocks"][k], np.float32)
        t = tstate["attn_blocks"][k].float().numpy()
        assert np.max(np.abs(j - t)) <= 2 ** -5 * np.max(np.abs(j)), k
    assert _rel(tstate["rec_blocks"]["state"],
                jstate["rec_blocks"]["state"]) <= 2 ** -5
    rep = dual_gate([jl], [tl], [jl.argmax(-1)], tol=TOL)
    assert rep["ok"], rep["max_logit_err"]


# ------------------------------------------------------ static path vs JAX

def test_static_prefill_and_decode_match_jax(arch):
    """A 40-token prompt (past the hybrid's window of 32), 30 greedy
    tokens: the port's static path held to the JAX model's by the dual
    gate along the port's tokens; every token the port emits is JAX's
    greedy token wherever JAX's margin is above twice the error, at
    least half of them."""
    jcfg, tcfg, jparams, tparams = arch
    max_len = 80
    prompt = np.random.RandomState(8).randint(1, jcfg.vocab,
                                              size=40).tolist()
    tm = build_model(tcfg)
    with torch.no_grad():
        logits, cache = tm.prefill(
            tparams, {"tokens": torch.as_tensor([prompt])})
        pos = cache.pop("pos")
        fresh = init_cache(tcfg, 1, max_len, "cpu")
        tree_map(lambda f, c: f[tuple(slice(0, n) for n in c.shape)]
                 .copy_(c), fresh, cache)
        cache = {**fresh, "pos": pos}
        out, tokens = [logits[0].float().numpy()], []
        for _ in range(30):
            tokens.append(int(out[-1].argmax()))
            logits, cache = tm.decode(tparams, cache,
                                      torch.as_tensor(tokens[-1:]))
            out.append(logits[0].float().numpy())
    if jcfg.family == "hybrid":
        assert cache["attn_blocks"]["k"].shape[2] == 32     # wrapped ring
    jl = _jax_static_logits(jcfg, jparams, prompt, tokens, max_len)
    rep = dual_gate([jl], [np.stack(out[:-1])], [tokens], tol=TOL)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}
    assert rep["high_margin_tokens"] >= len(tokens) // 2


def test_state_slot_defs_are_the_cache_without_pos(arch):
    """The state pool's layout is the static cache's at ``max_slots`` rows
    (slot axis 1 of every layer-stacked leaf), leaf for leaf as JAX's."""
    jcfg, tcfg, _, _ = arch
    tm, jm = build_model(tcfg), j_build(jcfg)
    tdefs = tm.state_slot_defs(3, 64)
    jdefs = jm.state_slot_defs(3, 64)
    tpaths = {p: d.shape for p, d in tree_leaves(tdefs)}
    jpaths = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  jdefs, is_leaf=lambda x: hasattr(x, "init"))[0]}
    assert tpaths == jpaths
    assert all(shape[1] == 3 for shape in tpaths.values())
    assert tm.paged_cache_defs(5, 8) == {} and tm.cache_spec().checkpointable
