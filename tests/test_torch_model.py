"""The port's dense decoder against ``repro``'s, with the same parameters.

Parameters are drawn with numpy from a seed by ``repro``'s init rules (the
round-trip test uses ``repro.models.registry.init_params`` itself) and cross
into torch through ``repro_torch.models.convert.params_from_numpy`` (bf16
through fp32, exact).  Both models then see the same token sequences, teacher-forced,
and their logits are held to the dual gate of ``serving/quant_verify.py``
(``repro_torch.serving.parity.dual_gate``): max |dlogit| within ``TOL``, and
the greedy token equal at every position whose top-2 margin exceeds twice
the observed error.  XLA and torch round bf16 GEMMs after summing in
different orders, so logits may differ by a few bf16 ulps; ``TOL`` is the
bound ``quant_verify`` uses for bf16-vs-int8 (0.25), far above that.
The JAX steps are jitted here only to keep the test fast.  At
this size the greedy tokens come out identical, and the tests assert it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ServeConfig, get_arch, reduced  # noqa: E402
from repro.models.registry import build_model as j_build  # noqa: E402
from repro.models.registry import init_params as j_init  # noqa: E402
from repro.models.attn_backend import decode_meta as j_decode_meta  # noqa: E402
from repro.models.attn_backend import prefill_meta as j_prefill_meta  # noqa: E402
from repro.models.params import ParamDef as JParamDef  # noqa: E402
from repro.serving.kv_pool import PagedKVPool as j_pool  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import dual_gate, replay_logits  # noqa: E402

TOL = 0.25


@pytest.fixture(scope="module", params=["qwen2-0.5b", "minitron-4b"])
def models(request):
    """qwen2 (gated SiLU MLP, QKV bias, RMSNorm, tied embeddings) and
    minitron (plain relu^2 MLP, LayerNorm, separate LM head), reduced."""
    jcfg = reduced(get_arch(request.param))
    tcfg = tconfigs.reduced(tconfigs.get_arch(request.param))
    jparams = seeded_params(jcfg, 0)
    tparams = params_from_numpy(tcfg, jax.device_get(jparams))
    return jcfg, tcfg, jparams, tparams


def seeded_params(jcfg, seed):
    """The JAX model's parameter tree drawn with numpy from ``seed`` by the
    rules of ``repro.models.params`` (``init_params`` itself folds in
    ``hash(path)``, which changes with PYTHONHASHSEED from one process to
    the next), as bf16 JAX arrays: the same values in every run."""
    rng = np.random.RandomState(seed)

    def draw(d):
        if d.init in ("zeros", "ones"):
            return jnp.full(d.shape, d.init == "ones", jnp.bfloat16)
        scale = 0.02 if d.init == "embed" \
            else 1.0 / np.sqrt(max(1, int(np.prod(d.shape[:-1]))))
        return jnp.asarray(rng.randn(*d.shape) * scale, jnp.bfloat16)
    return jax.tree.map(draw, j_build(jcfg).param_defs(),
                        is_leaf=lambda x: isinstance(x, JParamDef))


def _gate(ref, test, tokens):
    rep = dual_gate([ref], [test], [tokens], tol=TOL)
    assert rep["ok"], rep
    assert rep["greedy_equal_tokens"] == len(tokens)       # exact here
    return rep


def test_params_from_numpy_round_trip(models):
    jcfg, tcfg, _, _ = models
    jtree = jax.device_get(j_init(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(tcfg, jtree)
    flat = dict(tree_leaves(tparams))
    jflat = dict(tree_leaves(jtree))
    assert set(flat) == set(jflat)
    for path, t in flat.items():
        a = np.asarray(jflat[path], np.float32)
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.float().numpy(), a, err_msg=path)


def test_params_from_numpy_rejects_foreign_trees(models):
    jcfg, tcfg, jparams, _ = models
    tree = jax.device_get(jparams)
    with pytest.raises(KeyError):
        params_from_numpy(tcfg, {**tree, "extra": {"w": np.zeros(2)}})
    bad = dataclasses.replace(tcfg, d_ff=tcfg.d_ff * 2)
    with pytest.raises(ValueError):
        params_from_numpy(bad, tree)


def test_static_prefill_and_decode_logits(models):
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, jcfg.vocab, size=(1, 13)).astype(np.int32)
    jm, tm = j_build(jcfg), build_model(tcfg)
    j_prefill, j_decode = jax.jit(jm.prefill), jax.jit(jm.decode)
    jl, jc = j_prefill(jparams, {"tokens": jnp.asarray(prompt)})
    with torch.no_grad():
        tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(prompt)})
    # grow both contiguous caches to 24 positions, then decode 10 steps
    # feeding the JAX greedy tokens to both
    jc = jax.tree.map(lambda a: a if a.ndim < 2 else jnp.pad(
        a, [(0, 0), (0, 0), (0, 11)] + [(0, 0)] * (a.ndim - 3)), jc)
    for name in ("k", "v"):
        tc["blocks"][name] = torch.nn.functional.pad(
            tc["blocks"][name], (0, 0, 0, 0, 0, 11))
    ref, test, toks = [np.asarray(jl[0], np.float32)], [tl[0].float().numpy()], []
    for _ in range(10):
        tok = int(np.argmax(ref[-1]))
        toks.append(tok)
        jl, jc = j_decode(jparams, jc, jnp.asarray([tok], jnp.int32))
        with torch.no_grad():
            tl, tc = tm.decode(tparams, tc, torch.tensor([tok]))
        ref.append(np.asarray(jl[0], np.float32))
        test.append(tl[0].float().numpy())
    toks.append(int(np.argmax(ref[-1])))
    _gate(np.stack(ref), np.stack(test), toks)


def _jax_paged_greedy(jcfg, jscfg, jparams, prompt, n_new):
    """Greedy generation through the JAX model's paged steps (jitted), one
    request in a fresh bf16 pool: returns (logits [n_new, V], tokens) —
    ``quant_verify.replay_logits`` with the argmax fed back."""
    model = j_build(jcfg)
    pool = j_pool(jcfg, dataclasses.replace(jscfg, max_slots=1))
    pages = pool.alloc(pool.pages_for(len(prompt) + n_new))
    table = pool.new_table()
    table[:len(pages)] = pages
    tables = table[None, :]
    ps, T = jscfg.page_size, len(prompt)
    Tp = -(-T // ps) * ps
    meta = j_prefill_meta(jcfg, ps, tables, np.array([0]),
                          np.array([0], np.int32), np.array([T], np.int32),
                          Tp)
    toks = np.zeros((1, Tp), np.int32)
    toks[0, :T] = prompt
    logits, kv, _ = jax.jit(model.prefill_paged)(jparams, pool.kv, {}, meta,
                                                 toks)
    decode = jax.jit(model.decode_paged)
    out, gen = [np.asarray(logits[0], np.float32)], []
    for i in range(n_new - 1):
        gen.append(int(np.argmax(out[-1])))
        meta = j_decode_meta(jcfg, ps, tables, np.array([T + i], np.int32))
        logits, kv, _ = decode(jparams, kv, {}, meta,
                               np.array([gen[-1]], np.int32))
        out.append(np.asarray(logits[0], np.float32))
    gen.append(int(np.argmax(out[-1])))
    return np.stack(out), gen


@pytest.mark.parametrize("page_size,prompt_len", [(16, 37), (8, 16)])
def test_paged_prefill_and_decode_logits(models, page_size, prompt_len):
    """prefill_paged + decode_paged through the port's reference backend
    against the JAX model's paged steps, teacher-forced along the JAX
    model's greedy tokens."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.RandomState(page_size)
    prompt = rng.randint(1, jcfg.vocab, size=prompt_len).tolist()
    kw = dict(page_size=page_size, max_slots=1, max_len=64)
    ref, gen = _jax_paged_greedy(jcfg, ServeConfig(**kw), jparams, prompt,
                                 12)
    with torch.no_grad():
        test = replay_logits(tcfg, tconfigs.ServeConfig(**kw), tparams,
                             prompt, gen)
    _gate(ref, test, gen)
