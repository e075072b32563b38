"""The port's continuous-batching engine on the CPU (reference backend).

1. Against its own static baseline: token for token, with the radix prefix
   cache and chunked prefill on (the check ``launch/serve.py --verify``
   runs), and through the CLI itself.
2. Against the JAX engine with the same parameters and prompts: the dual
   gate of ``serving/quant_verify.py`` along the port's tokens (see
   ``tests/test_torch_model.py`` for the bound and for why the parameters
   are drawn with numpy), plus exact tokens, which hold for these seeded
   parameters.
3. Pool conservation after a drain, and the parts of the JAX engine that
   are not ported yet refusing clearly instead of serving something else.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ServeConfig as JServeConfig  # noqa: E402
from repro.configs import get_arch, reduced  # noqa: E402
from repro.models.params import ParamDef as JParamDef  # noqa: E402
from repro.models.registry import build_model as j_build  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving.quant_verify import replay_logits as j_replay  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (Engine, dual_gate,  # noqa: E402
                                 generate_static, replay_logits)

TOL = 0.25
SCFG = dict(page_size=8, max_slots=4, max_len=64, prefix_cache=True,
            prefill_chunk_tokens=16)


@pytest.fixture(scope="module")
def setup():
    jcfg = reduced(get_arch("qwen2-0.5b"))
    tcfg = tconfigs.reduced(tconfigs.get_arch("qwen2-0.5b"))
    jparams = seeded_params(jcfg, 0)
    tparams = params_from_numpy(tcfg, jax.device_get(jparams))
    rng = np.random.RandomState(0)
    shared = rng.randint(1, jcfg.vocab, size=20).tolist()
    prompts = [shared + rng.randint(1, jcfg.vocab, size=n).tolist()
               for n in (3, 17, 30, 1, 9, 24)]
    budgets = [6, 9, 4, 12, 7, 5]
    return jcfg, tcfg, jparams, tparams, prompts, budgets


def seeded_params(jcfg, seed):
    """The JAX model's parameter tree drawn with numpy from ``seed`` by the
    rules of ``repro.models.params`` (``init_params`` itself folds in
    ``hash(path)``, which changes with PYTHONHASHSEED from one process to
    the next), as JAX arrays of each leaf's dtype (bf16, or fp32 for the
    recurrent families' ``A_log``, ``D`` and ``lam``): the same values in
    every run."""
    rng = np.random.RandomState(seed)

    def draw(d):
        if d.init in ("zeros", "ones"):
            return jnp.full(d.shape, d.init == "ones", d.dtype)
        if d.init.startswith("const:"):
            return jnp.full(d.shape, float(d.init[6:]), d.dtype)
        scale = 0.02 if d.init == "embed" \
            else 1.0 / np.sqrt(max(1, int(np.prod(d.shape[:-1]))))
        return jnp.asarray(rng.randn(*d.shape) * scale, d.dtype)
    return jax.tree.map(draw, j_build(jcfg).param_defs(),
                        is_leaf=lambda x: isinstance(x, JParamDef))


def _run(tcfg, tparams, prompts, budgets, **kw):
    eng = Engine(tcfg, tconfigs.ServeConfig(**{**SCFG, **kw}), tparams,
                 device="cpu")
    with torch.no_grad():
        results, metrics = eng.run_offline(prompts, budgets)
    return eng, [r.tokens for r in results], metrics


def test_engine_matches_static_with_cache_and_chunking(setup):
    _, tcfg, _, tparams, prompts, budgets = setup
    eng, tokens, m = _run(tcfg, tparams, prompts, budgets)
    assert m["cached_tokens"] > 0 and m["chunked_prefill_steps"] > 0
    assert m["attn_backend"] == "reference" and m["device"] == "cpu"
    with torch.no_grad():
        ref, _ = generate_static(tcfg, tparams, prompts, budgets,
                                 tconfigs.ServeConfig(**SCFG))
    assert tokens == ref
    assert [len(t) for t in tokens] == budgets


def test_engine_matches_jax_engine(setup):
    jcfg, tcfg, jparams, tparams, prompts, budgets = setup
    _, tokens, _ = _run(tcfg, tparams, prompts, budgets)
    jeng = JEngine(jcfg, JServeConfig(**SCFG), jparams)
    jtokens = [r.tokens for r in jeng.run_offline(prompts, budgets)[0]]
    assert tokens == jtokens                       # exact at this size
    jscfg, tscfg = JServeConfig(**SCFG), tconfigs.ServeConfig(**SCFG)
    # the JAX replay runs eagerly (seconds a request): gate two requests,
    # a cache hit whose tail spans a chunk boundary and a short one
    pick = [1, 2]
    ref = [j_replay(jcfg, jscfg, jparams, prompts[i], tokens[i],
                    kv_dtype="bf16") for i in pick]
    with torch.no_grad():
        test = [replay_logits(tcfg, tscfg, tparams, prompts[i], tokens[i])
                for i in pick]
    rep = dual_gate(ref, test, [tokens[i] for i in pick], tol=TOL)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def test_pool_conserved_after_drain(setup):
    _, tcfg, _, tparams, prompts, budgets = setup
    eng, _, _ = _run(tcfg, tparams, prompts, budgets)
    pool = eng.pool
    assert pool.conservation_ok()
    # after the drain only the radix cache still owns pages, once each
    assert set(pool.refcounts) == set(eng.radix.cached_pages)
    assert all(r == 1 for r in pool.refcounts.values())
    eng.radix.reset()
    assert pool.num_allocated == 0 and pool.conservation_ok()


def test_cancel_queued_and_live_requests(setup):
    _, tcfg, _, tparams, prompts, budgets = setup
    eng = Engine(tcfg, tconfigs.ServeConfig(**{**SCFG, "max_slots": 2}),
                 tparams, device="cpu")
    with torch.no_grad():
        for p, m in zip(prompts[:4], budgets[:4]):
            eng.add_request(p, m)
        eng.step()
        eng.step()
        assert eng.cancel(0) and eng.cancel(3) and not eng.cancel(99)
        while eng.step():
            pass
        res = {r.rid: r for r in eng.collect()}
        ref, _ = generate_static(tcfg, tparams, prompts[1:3], budgets[1:3],
                                 tconfigs.ServeConfig(**SCFG))
    assert res[0].error == res[3].error == "cancelled"
    assert [res[1].tokens, res[2].tokens] == ref
    assert eng.pool.conservation_ok()


def test_cli_verify_on_cpu(capsys):
    tokens = tserve.main([
        "--device", "cpu", "--arch", "qwen2-0.5b", "--reduced", "--engine",
        "continuous", "--requests", "8", "--mixed", "--prompt-len", "64",
        "--prefix-cache", "--shared-prefix", "2", "--prefill-chunk-tokens",
        "32", "--verify"])
    assert len(tokens) == 8
    assert "verify OK: 8 requests" in capsys.readouterr().out


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="cuda"):
        tserve.main(["--arch", "qwen2-0.5b", "--reduced", "--requests", "1"])
    cfg = tconfigs.reduced(tconfigs.get_arch("qwen2-0.5b"))
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(cfg, tconfigs.ServeConfig())


@pytest.mark.parametrize("kw,item", [
    (dict(default_deadline_s=1.0), "item 9"),
    (dict(default_ttft_deadline_s=0.5), "item 9"),
    (dict(admission_control=True), "item 9"),
    (dict(attn_backend="hopper"), None),
])
def test_unported_modes_refuse(kw, item):
    """``hopper`` on the CPU refuses; the deadline and admission-control
    modes, which refused until item 9 was ported, now build an engine that
    stamps deadlines on queued requests and calibrates its controller."""
    cfg = tconfigs.reduced(tconfigs.get_arch("qwen2-0.5b"))
    scfg = tconfigs.ServeConfig(**{**SCFG, **kw})
    if item is None:                 # hopper launches CUDA kernels only
        with pytest.raises(ValueError, match="hopper"):
            Engine(cfg, scfg, device="cpu")
        return
    eng = Engine(cfg, scfg, device="cpu")
    assert (eng.admission is not None) == scfg.admission_control
    eng.add_request([1, 2, 3], 2)
    (req,) = eng.sched.queue
    assert (req.deadline is not None) == bool(scfg.default_deadline_s)
    assert (req.ttft_deadline is not None) \
        == bool(scfg.default_ttft_deadline_s)


def test_unported_families_refuse():
    """The vlm and enc-dec families serve since ROADMAP item 14; their
    training loss (item 14b) is what still refuses."""
    for name in ("llava-next-34b", "seamless-m4t-large-v2"):
        cfg = tconfigs.reduced(tconfigs.get_arch(name))
        eng = Engine(cfg, tconfigs.ServeConfig(), device="cpu")
        with pytest.raises(NotImplementedError, match="item 14b"):
            eng.model.loss(eng.params, {"tokens": torch.ones(
                (1, 8), dtype=torch.long)})


@pytest.mark.parametrize("top,delta,ok", [
    (40.0, 0.25, True),     # one ulp in [32, 64)
    (70.0, 0.5, True),      # one ulp in [64, 128): 0.25 absolute would fail
    (40.0, 0.75, False),    # three ulps
])
def test_dual_gate_row_ulp_bound(top, delta, ok):
    """Gate 1 in bf16 ulps of each token's largest |logit| scales with the
    logits: one ulp passes at any magnitude, three fail."""
    ref = np.array([[top, 1.0, -3.0], [2.0, 0.5, 0.0]], np.float32)
    test = ref.copy()
    test[0, 1] += delta
    rep = dual_gate([ref], [test], [[0, 0]], tol=TOL, tol_row_ulps=2.0)
    assert rep["max_logit_err_row_ulps"] == delta / 2.0 ** (
        np.floor(np.log2(top)) - 7)
    assert rep["ok"] is ok
    assert dual_gate([ref], [test], [[0, 0]], tol=TOL)["ok"] is (delta <= TOL)
