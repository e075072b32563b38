"""Mixture-of-Experts in the port, on the CPU, against the JAX package.

1. ``models.moe.moe_apply`` / ``moe_decode_apply`` against
   ``repro.models.moe``'s on the same numpy inputs in fp32, within 1e-5:
   random routers (deepseek-v2's shape with a shared expert, dbrx's
   without), a planted router that sends every token to one expert so
   capacity drops tokens, planted equal gates (every tie broken toward the
   lower index, as ``jax.lax.top_k`` breaks it), and decode at B = 16
   where capacity binds.
2. dbrx-132b (MoE on GQA attention, layernorm, no dense layer), reduced:
   the continuous engine against the JAX engine with the same seeded
   parameters (exact tokens and the dual gate, max |dlogit| <= 0.25),
   prefix cache and chunked prefill on; and a verify step (every token
   kept: the JAX package's ``cap = Q``) against the JAX verify step by the
   dual gate, with row j equal to the port's decode step at ``pos + j``
   bit for bit.  The bf16 MoE is not exact against JAX token by token in
   general: the two frameworks round some bf16 elementwise steps (the
   expert activation) at other points, and a router near a tie can send a
   token to another expert, which the dual gate absorbs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ServeConfig as JServeConfig  # noqa: E402
from repro.configs import get_arch, reduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.attn_backend import prefill_meta as j_prefill_meta  # noqa: E402
from repro.models.attn_backend import verify_meta as j_verify_meta  # noqa: E402
from repro.models.registry import build_model as j_build  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving.kv_pool import PagedKVPool as JPool  # noqa: E402
from repro.serving.quant_verify import replay_logits as j_replay  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.attn_backend import (  # noqa: E402
    decode_meta, meta_to_device, prefill_meta, verify_meta)
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import (Engine, PagedKVPool, dual_gate,  # noqa: E402
                                 replay_logits)
from test_torch_engine import seeded_params  # noqa: E402

ATOL = 1e-5
TOL = 0.25


from _torch_common import one_thread  # noqa: E402, F401


def _cfgs(arch, **kw):
    """The JAX and the port's reduced config of ``arch``, with ``kw``."""
    return (dataclasses.replace(reduced(get_arch(arch)), **kw),
            dataclasses.replace(tconfigs.reduced(tconfigs.get_arch(arch)),
                                **kw))


def _params(jcfg, rng):
    """fp32 MoE leaves drawn with numpy, as (jax, torch) trees."""
    p = {k: (rng.randn(*d.shape) / np.sqrt(d.shape[-2])).astype(np.float32)
         for k, d in jmoe.moe_defs(jcfg).items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _both(jcfg, tcfg, jp, tp, x, **kw):
    jo, ja = jmoe.moe_apply(jcfg, jp, jnp.asarray(x), **kw)
    to, ta = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x), **kw)
    return (np.asarray(jo), float(ja)), (to.numpy(), float(ta))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "dbrx-132b"])
@pytest.mark.parametrize("G,S", [(1, 8), (3, 40)])
def test_moe_apply_matches_jax(arch, G, S):
    jcfg, tcfg = _cfgs(arch, n_experts=8)
    rng = np.random.RandomState(G * 100 + S)
    jp, tp = _params(jcfg, rng)
    x = rng.randn(G, S, jcfg.d_model).astype(np.float32)
    (jo, ja), (to, ta) = _both(jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(to, jo, rtol=0, atol=ATOL)
    assert abs(ta - ja) <= ATOL


def test_planted_router_drops_over_capacity():
    """Every token's first choice is expert 0, so expert 0 takes only its
    top-C tokens by gate and drops the rest: the same tokens on both
    sides."""
    jcfg, tcfg = _cfgs("dbrx-132b", n_experts=8)
    rng = np.random.RandomState(1)
    jp, tp = _params(jcfg, rng)
    router = np.zeros_like(np.asarray(jp["router"]))
    router[:, 0] = 1.0
    router[:, 1:] = 0.05 * rng.randn(router.shape[0], router.shape[1] - 1)
    jp["router"], tp["router"] = jnp.asarray(router), torch.from_numpy(router)
    S = 40
    x = np.abs(rng.randn(1, S, jcfg.d_model)).astype(np.float32)
    assert tmoe.capacity(tcfg, S) < S
    (jo, ja), (to, ta) = _both(jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(to, jo, rtol=0, atol=ATOL)
    assert abs(ta - ja) <= ATOL
    # tokens were dropped: a capacity of S routes every token and differs
    full, _ = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x), cap=S)
    assert np.abs(full.numpy() - to).max() > 1e-3


def test_planted_equal_gates_break_ties_like_jax():
    """A zero router gives every expert the same probability: top-k takes
    the lowest expert indices and every expert's capacity keeps the lowest
    token indices, in JAX's tie order."""
    jcfg, tcfg = _cfgs("dbrx-132b", n_experts=8)
    rng = np.random.RandomState(2)
    jp, tp = _params(jcfg, rng)
    zero = np.zeros_like(np.asarray(jp["router"]))
    jp["router"], tp["router"] = jnp.asarray(zero), torch.from_numpy(zero)
    S = 40
    x = rng.randn(2, S, jcfg.d_model).astype(np.float32)
    (jo, _), (to, _) = _both(jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(to, jo, rtol=0, atol=ATOL)
    vals, idx = tmoe.top_k(torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]]), 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]
    # every token picks experts 0 and 1 at equal gates; each keeps tokens
    # 0..C-1 and drops the rest, which get no expert output at all
    C = tmoe.capacity(tcfg, S)
    kept, _ = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x[:, :C]), cap=C)
    np.testing.assert_allclose(to[:, :C], kept.numpy(), rtol=0, atol=ATOL)
    assert C < S and not to[:, C:].any()


def test_decode_at_b16_where_capacity_binds():
    """At decode the B tokens are one group: with 16 experts top-2, B = 16
    gives a capacity of 8 < 16, so an expert that more than 8 tokens choose
    (a router leaning to expert 0) drops some of them, as in JAX."""
    jcfg, tcfg = _cfgs("deepseek-v2-236b", n_experts=16)
    assert tmoe.capacity(tcfg, 16) == 8
    rng = np.random.RandomState(3)
    jp, tp = _params(jcfg, rng)
    router = np.array(jp["router"])
    router[:, 0] += 0.5
    jp["router"], tp["router"] = jnp.asarray(router), torch.from_numpy(router)
    x = np.abs(rng.randn(16, jcfg.d_model)).astype(np.float32)
    jo = np.asarray(jmoe.moe_decode_apply(jcfg, jp, jnp.asarray(x)))
    to = tmoe.moe_decode_apply(tcfg, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(to, jo, rtol=0, atol=ATOL)
    full, _ = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x)[None], cap=16)
    assert np.abs(full[0].numpy() - to).max() > 1e-3       # capacity bound


# ----------------------------------------------------------------- dbrx

SCFG = dict(page_size=8, max_slots=4, max_len=64, prefix_cache=True,
            prefill_chunk_tokens=16)


@pytest.fixture(scope="module")
def dbrx():
    jcfg, tcfg = _cfgs("dbrx-132b")
    jparams = seeded_params(jcfg, 0)
    tparams = params_from_numpy(tcfg, jax.device_get(jparams))
    assert tparams["blocks"]["moe"]["router"].dtype == torch.float32
    rng = np.random.RandomState(0)
    shared = rng.randint(1, jcfg.vocab, size=16).tolist()
    prompts = [shared + rng.randint(1, jcfg.vocab, size=n).tolist()
               for n in (3, 17, 30, 1)]
    return jcfg, tcfg, jparams, tparams, prompts, [6, 9, 4, 12]


def test_dbrx_engine_matches_jax_engine(dbrx):
    """Prefix cache and chunked prefill on: the port's tokens are the JAX
    engine's (exact at this size) and pass the dual gate against the JAX
    replay.  (The static baseline routes a whole prompt as one group, so
    it drops other tokens than the engine's chunks wherever capacity
    binds: ``test_torch_mla`` compares engine and static where it does
    not.)"""
    jcfg, tcfg, jparams, tparams, prompts, budgets = dbrx
    eng = Engine(tcfg, tconfigs.ServeConfig(**SCFG), tparams, device="cpu")
    with torch.no_grad():
        results, m = eng.run_offline(prompts, budgets)
    tokens = [r.tokens for r in results]
    assert m["cached_tokens"] > 0 and m["chunked_prefill_steps"] > 0
    jeng = JEngine(jcfg, JServeConfig(**SCFG), jparams)
    assert tokens == [r.tokens for r in jeng.run_offline(prompts, budgets)[0]]
    pick = [1, 2]
    jscfg, tscfg = JServeConfig(**SCFG), tconfigs.ServeConfig(**SCFG)
    jl = [j_replay(jcfg, jscfg, jparams, prompts[i], tokens[i],
                   kv_dtype="bf16") for i in pick]
    with torch.no_grad():
        tl = [replay_logits(tcfg, tscfg, tparams, prompts[i], tokens[i])
              for i in pick]
    rep = dual_gate(jl, tl, [tokens[i] for i in pick], tol=TOL)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def test_dbrx_verify_rows_keep_every_token(dbrx):
    """Two rows prefilled into both frameworks' pools, then one verify step
    (four and two drafts after the JAX prefill's greedy token): the port's
    prefill and verify logits pass the dual gate against JAX's (``cap =
    Q``), and every live row j equals the port's decode step at ``pos +
    j`` bit for bit (two slots: the decode step drops no token either)."""
    jcfg, tcfg, jparams, tparams, _, _ = dbrx
    ps, Q = 8, 5
    kw = dict(page_size=ps, max_slots=2, max_len=48)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, tcfg.vocab, size=n).tolist() for n in (13, 7)]
    drafts = [rng.randint(1, tcfg.vocab, size=4).tolist(),
              rng.randint(1, tcfg.vocab, size=2).tolist()]
    pool = PagedKVPool(tcfg, tconfigs.ServeConfig(**kw))
    jpool = JPool(jcfg, JServeConfig(**kw))
    tables = np.zeros((2, pool.table_width), np.int32)
    for b in range(2):
        pages = pool.alloc(pool.pages_for(len(prompts[b]) + Q))
        tables[b, :len(pages)] = pages
    T = 16
    toks = np.zeros((2, T), np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    n_tail = np.asarray([len(p) for p in prompts], np.int32)
    pargs = (ps, tables, np.arange(2, dtype=np.int32),
             np.zeros(2, np.int32), n_tail, T)
    model, jmodel = build_model(tcfg), j_build(jcfg)
    with torch.no_grad():
        tl, kv, _ = model.prefill_paged(
            tparams, pool.kv, {}, meta_to_device(prefill_meta(tcfg, *pargs),
                                                 "cpu"),
            torch.from_numpy(toks))
    jl, jkv, _ = jax.jit(jmodel.prefill_paged)(
        jparams, jpool.kv, {}, j_prefill_meta(jcfg, *pargs), toks)
    jl = np.asarray(jl, np.float32)
    first = jl.argmax(-1)
    rep = dual_gate([r[None] for r in jl],
                    [r[None] for r in tl.float().numpy()],
                    [[t] for t in first], tol=TOL)
    assert rep["ok"], rep
    vt = np.zeros((2, Q), np.int32)
    n_q = np.asarray([1 + len(d) for d in drafts], np.int32)
    for b in range(2):
        vt[b, 0] = first[b]
        vt[b, 1:n_q[b]] = drafts[b]
    vargs = (ps, tables, n_tail, n_q, Q)
    jv, _, _ = jax.jit(jmodel.verify_paged)(
        jparams, jkv, {}, j_verify_meta(jcfg, *vargs), vt)
    with torch.no_grad():
        tv, kv, _ = model.verify_paged(
            tparams, kv, {}, meta_to_device(verify_meta(tcfg, *vargs), "cpu"),
            torch.from_numpy(vt))
    jv, tv = np.asarray(jv, np.float32), tv.float().numpy()
    ref = [jv[b, :n_q[b]] for b in range(2)]
    rep = dual_gate(ref, [tv[b, :n_q[b]] for b in range(2)],
                    [r.argmax(-1) for r in ref], tol=TOL)
    assert rep["ok"], rep
    with torch.no_grad():
        for j in range(Q):
            dec, kv, _ = model.decode_paged(
                tparams, kv, {}, meta_to_device(
                    decode_meta(tcfg, ps, tables, (n_tail + j).astype(
                        np.int32)), "cpu"), torch.from_numpy(vt[:, j]))
            for b in np.nonzero(j < n_q)[0]:
                np.testing.assert_array_equal(dec.float().numpy()[b],
                                              tv[b, j])
