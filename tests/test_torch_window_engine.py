"""The sliding-window family end to end on the CPU: reduced starcoder2-7b
and command-r-plus-104b (window 32) in the port against the JAX package.

1. The static path (``DecoderLM.prefill`` into a ring of ``min(window,
   max_len)`` entries, ``decode`` at ring slot ``pos % L``) against the JAX
   model, teacher-forced along the port's greedy tokens: the dual gate of
   ``serving/quant_verify.py`` (max |dlogit| <= 0.25, no greedy mismatch
   where the JAX margin exceeds twice the observed error), plus exact
   tokens wherever the JAX top two logits are not tied (for these seeded
   parameters command-r-plus-104b meets one exact bf16 tie, where the two
   frameworks' argmax may pick either token; starcoder2-7b meets none).
2. The continuous-batching engine (page rings, chunked prefill smaller than
   the window, prompts longer than the window, prefix cache requested and
   disabled as in JAX) against the JAX engine: the dual gate, and exact
   tokens up to the first position where the JAX margin lies within twice
   the observed logit error (a parting the dual gate allows); and token for
   token against the port's own static baseline.
3. Speculation (K = 4) equal to the non-speculative engine, and to the
   JAX speculative engine up to such a low-margin parting, with drafts
   rejected across ring wraps; the int8 engine equal to the JAX int8
   engine up to such a parting; allocation O(window).

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
from repro.models.registry import build_model as j_build  # noqa: E402
from repro.models.registry import init_cache as j_init_cache  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving.quant_verify import replay_logits as j_replay  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.cache_spec import window_pages  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import (Engine, dual_gate,  # noqa: E402
                                 generate_static, replay_logits)
from test_torch_engine import seeded_params  # noqa: E402

TOL = 0.25
ARCHS = ["starcoder2-7b", "command-r-plus-104b"]
# window 32 (reduced); chunks of 16 < window; the ring is window_pages(32,
# 8) = 5 pages of 8 (6 with speculation's slack page)
SCFG = dict(page_size=8, max_slots=3, max_len=96, prefix_cache=True,
            prefill_chunk_tokens=16)


from _torch_common import one_thread  # noqa: E402, F401


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = reduced(get_arch(request.param))
    tcfg = tconfigs.reduced(tconfigs.get_arch(request.param))
    assert jcfg.sliding_window == tcfg.sliding_window == 32
    jparams = seeded_params(jcfg, 0)
    tparams = params_from_numpy(tcfg, jax.device_get(jparams))
    return jcfg, tcfg, jparams, tparams


def _prompts(vocab, seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=n).tolist() for n in lens]


@functools.lru_cache(maxsize=None)
def _jax_static_steps(jcfg):
    jm = j_build(jcfg)
    return jax.jit(jm.prefill), jax.jit(jm.decode)


def _jax_static_logits(jcfg, jparams, prompt, tokens, max_len):
    """The JAX model's static path (jitted prefill into its window ring,
    then decode) teacher-forced along ``tokens``: the logits that predicted
    each of them, fp32 [len(tokens), vocab]."""
    prefill, decode = _jax_static_steps(jcfg)
    logits, cache = prefill(jparams,
                            {"tokens": jnp.asarray([prompt], jnp.int32)})
    fresh = j_init_cache(jcfg, 1, max_len)
    cache = jax.tree.map(
        lambda f, c: c if f.shape == c.shape else jnp.pad(
            c, [(0, fs - cs) for fs, cs in zip(f.shape, c.shape)]),
        fresh, cache)
    out = [np.asarray(logits[0], np.float32)]
    for tok in tokens[:-1]:
        logits, cache = decode(jparams, cache, jnp.asarray([tok], jnp.int32))
        out.append(np.asarray(logits[0], np.float32))
    return np.stack(out)


def _assert_equal_or_low_margin(jcfg, tcfg, jparams, tparams, prompts,
                                tokens, jtokens, scfg):
    """Port tokens equal the JAX engine's, or each request's streams part
    first at a low-margin position: replayed along the port's tokens up to
    there (the JAX static path for bf16 pages, the JAX paged replay for
    int8), the two frameworks pass the dual gate, so the JAX top-two margin
    at the parting token is within twice the observed logit error."""
    for p, t, jt in zip(prompts, tokens, jtokens):
        if t == jt:
            continue
        d = next(i for i, (a, b) in enumerate(zip(t, jt)) if a != b)
        if scfg.get("kv_dtype", "bf16") == "int8":
            jl = j_replay(jcfg, JServeConfig(**scfg), jparams, p, t[:d + 1],
                          kv_dtype="int8")
        else:
            jl = _jax_static_logits(jcfg, jparams, p, t[:d + 1],
                                    scfg["max_len"])
        with torch.no_grad():
            tl = replay_logits(tcfg, tconfigs.ServeConfig(**scfg), tparams,
                               p, t[:d + 1])
        rep = dual_gate([jl], [tl], [t[:d + 1]], tol=TOL)
        assert rep["ok"] and jl[d].argmax() == jt[d], (d, rep["max_logit_err"])


def _serve(tcfg, tparams, prompts, budgets, proposer=None, **kw):
    eng = Engine(tcfg, tconfigs.ServeConfig(**{**SCFG, **kw}), tparams,
                 device="cpu")
    if proposer is not None:
        eng.proposer = proposer
    with torch.no_grad():
        res, m = eng.run_offline(prompts, budgets)
    return eng, [r.tokens for r in res], m


def test_static_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, jparams, tparams = arch
    toks = np.array(_prompts(tcfg.vocab, 1, [45, 45]), np.int32)
    jm, tm = j_build(jcfg), build_model(tcfg)
    jl, jc = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    j_decode = jax.jit(jm.decode)
    with torch.no_grad():
        tl, tc = tm.prefill(tparams, {"tokens": torch.as_tensor(toks)})
        # both caches hold the ring of the last 32 positions
        assert tc["blocks"]["k"].shape[2] == jc["blocks"]["k"].shape[2] == 32
        ref, test, gen = [np.asarray(jl, np.float32)], [tl.float().numpy()], []
        for _ in range(40):                     # decode wraps the ring
            cur = test[-1].argmax(-1).astype(np.int32)
            gen.append(cur)
            jl, jc = j_decode(jparams, jc, jnp.asarray(cur))
            tl, tc = tm.decode(tparams, tc, torch.as_tensor(cur))
            ref.append(np.asarray(jl, np.float32))
            test.append(tl.float().numpy())
    tokens = np.stack(gen, 1)                   # [B, 40] port greedy tokens
    ref, test = np.stack(ref[:-1], 1), np.stack(test[:-1], 1)
    rep = dual_gate(list(ref), list(test), list(tokens), tol=TOL)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}
    top2 = np.sort(ref, -1)[..., -2:]
    tied = top2[..., 1] == top2[..., 0]
    assert ((ref.argmax(-1) == tokens) | tied).all()


def test_engine_matches_jax_engine_and_static(arch):
    jcfg, tcfg, jparams, tparams = arch
    prompts = _prompts(tcfg.vocab, 2, [40, 9, 57, 33])
    budgets = [30, 12, 20, 25]
    eng, tokens, m = _serve(tcfg, tparams, prompts, budgets)
    assert eng.radix is None                    # rings are not cacheable
    assert eng.pool.table_width == window_pages(32, 8)
    assert m["chunked_prefill_steps"] > 0
    jeng = JEngine(jcfg, JServeConfig(**SCFG), jparams)
    jtokens = [r.tokens for r in jeng.run_offline(prompts, budgets)[0]]
    _assert_equal_or_low_margin(jcfg, tcfg, jparams, tparams, prompts,
                                tokens, jtokens, SCFG)
    with torch.no_grad():
        ref, _ = generate_static(tcfg, tparams, prompts, budgets,
                                 tconfigs.ServeConfig(**SCFG))
    assert tokens == ref
    # the port's paged replay along its own tokens against the JAX static
    # path teacher-forced along the same tokens (jitted; the JAX paged
    # replay runs eagerly, seconds a token), for the two prompts longer
    # than the window
    pick = [2, 0]
    jl = [_jax_static_logits(jcfg, jparams, prompts[i], tokens[i],
                             SCFG["max_len"]) for i in pick]
    with torch.no_grad():
        tl = [replay_logits(tcfg, tconfigs.ServeConfig(**SCFG), tparams,
                            prompts[i], tokens[i]) for i in pick]
    rep = dual_gate(jl, tl, [tokens[i] for i in pick], tol=TOL)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


class _PartOracle:
    """Drafts the true continuation with every draft token from index
    ``keep`` on corrupted: each verify step accepts ``keep`` drafts and
    rejects the rest, whose K/V land in ring slots past the new position."""

    def __init__(self, k, keep, prompts, continuations, vocab):
        self.k, self.keep, self.vocab = k, keep, vocab
        self.plan = [(list(p), list(c))
                     for p, c in zip(prompts, continuations)]

    def propose(self, tokens):
        toks = list(tokens)
        for p, cont in self.plan:
            if toks[:len(p)] == p:
                g = len(toks) - len(p)
                d = cont[g:g + self.k]
                return d[:self.keep] + [(t + 1) % self.vocab
                                        for t in d[self.keep:]]
        return []


def test_speculative_engine_rejects_across_ring_wraps(arch):
    """K = 4 over a 6-page ring of 48 slots: n-gram drafts on repetitive
    prompts equal the non-speculative and the JAX speculative engines; with
    drafts that are accepted in part, positions run to 110, so rejected
    drafts land in ring slots across two wraps and are overwritten next
    step, and the stream still equals the non-speculative one."""
    jcfg, tcfg, jparams, tparams = arch
    rng = np.random.RandomState(3)
    motif = rng.randint(1, tcfg.vocab, size=5).tolist()
    prompts = [(motif * 10)[:38]] + _prompts(tcfg.vocab, 4, [30, 50])
    budgets = [24, 30, 18]
    kw = dict(max_len=112)
    eng, tokens, m = _serve(tcfg, tparams, prompts, budgets,
                            speculate_tokens=4, **kw)
    assert eng.pool.table_width == window_pages(32, 8) + 1
    assert m["spec_proposed"] > 0 and m["spec_accepted"] > 0
    _, plain, _ = _serve(tcfg, tparams, prompts, budgets, **kw)
    assert tokens == plain
    jeng = JEngine(jcfg, JServeConfig(speculate_tokens=4, **{**SCFG, **kw}),
                   jparams)
    jres, jm = jeng.run_offline(prompts, budgets)
    jtokens = [r.tokens for r in jres]
    _assert_equal_or_low_margin(jcfg, tcfg, jparams, tparams, prompts,
                                tokens, jtokens, {**SCFG, **kw})
    if tokens == jtokens:
        assert (m["spec_proposed"], m["spec_accepted"]) == \
            (jm["spec_proposed"], jm["spec_accepted"])
    long = _prompts(tcfg.vocab, 5, [60, 45])
    _, conts, _ = _serve(tcfg, tparams, long, 50, **kw)
    for keep in (1, 2):
        eng, tokens, m = _serve(
            tcfg, tparams, long, 50, speculate_tokens=4, **kw,
            proposer=_PartOracle(4, keep, long, conts, tcfg.vocab))
        assert tokens == conts
        assert m["spec_accepted"] > 0
        assert m["spec_proposed"] > m["spec_accepted"]
        assert eng.pool.conservation_ok()


def test_int8_engine_matches_jax_int8_engine(arch):
    jcfg, tcfg, jparams, tparams = arch
    prompts = _prompts(tcfg.vocab, 6, [44, 13, 36])
    budgets = [28, 14, 20]
    eng, tokens, _ = _serve(tcfg, tparams, prompts, budgets, kv_dtype="int8")
    assert "k_scale" in eng.pool.kv
    jeng = JEngine(jcfg, JServeConfig(kv_dtype="int8", **SCFG), jparams)
    jtokens = [r.tokens for r in jeng.run_offline(prompts, budgets)[0]]
    _assert_equal_or_low_margin(jcfg, tcfg, jparams, tparams, prompts,
                                tokens, jtokens, {**SCFG, "kv_dtype": "int8"})


def test_windowed_allocation_is_o_window(arch):
    """A request holds at most ``window_pages`` pages however long it
    generates: the pool could not cover unbounded growth, yet nothing is
    preempted and tokens stay exact through the ring wrap (the port of
    ``tests/test_serving_families.py::test_windowed_allocation_is_o_window``,
    with seeded parameters)."""
    _, tcfg, _, tparams = arch
    ps, slots = 8, 3
    horizon = window_pages(tcfg.sliding_window, ps)
    scfg = tconfigs.ServeConfig(page_size=ps, max_slots=slots, max_len=64,
                                num_pages=slots * horizon + 1)
    # 44 > ring span: the prefill itself wraps; budgets decode past the ring
    prompts = _prompts(tcfg.vocab, 7, [10, 44, 25])
    budgets = [50, 18, 30]
    eng = Engine(tcfg, scfg, tparams, device="cpu")
    assert eng.pool.table_width == horizon
    with torch.no_grad():
        results, _ = eng.run_offline(prompts, budgets)
        ref, _ = generate_static(tcfg, tparams, prompts, budgets, scfg)
    assert all(r.n_preemptions == 0 for r in results)
    assert [r.tokens for r in results] == ref
    assert eng.pool.num_allocated == 0 and eng.pool.conservation_ok()


@pytest.mark.parametrize("extra", [[], ["--speculate-tokens", "4"],
                                   ["--kv-dtype", "int8"]])
def test_cli_windowed_verify_on_cpu(capsys, extra):
    tokens = tserve.main([
        "--device", "cpu", "--reduced", "--arch", "starcoder2-7b",
        "--requests", "4", "--mixed", "--prompt-len", "48", "--gen", "24",
        "--prefill-chunk-tokens", "16", "--verify", *extra])
    assert len(tokens) == 4
    assert "verify OK" in capsys.readouterr().out
