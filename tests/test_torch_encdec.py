"""The enc-dec family (reduced seamless-m4t-large-v2: 2 encoder + 2 decoder
layers, d 128, 4 query / 2 KV heads of 32, QKV biases, LayerNorm, a ReLU
MLP) in the port against ``repro.models.encdec`` and the JAX engine.

Parameters are drawn with numpy (``test_torch_engine.seeded_params``) and
cross into torch leaf to leaf.  The frames come from the port's numpy draw
``repro_torch.serving.engine._synthetic_frontend``; the JAX engine draws
its own with ``jax.random``, which torch cannot reproduce, so a module
fixture monkeypatches ``repro.serving.engine._synthetic_frontend`` to the
port's function for this module's tests (the JAX engine's ``_extras`` and
its ``generate_static`` both call that module-level name).  No file of the
JAX package changes.

Tolerances.  bf16 activations on both sides, rounded by XLA and by torch
after sums in different orders: the encoder output within 2 bf16 ulps of
each row's largest |JAX value|; the non-causal core and cross-attention,
one attend, within 1 ulp of the row's largest |value| (plus 2^-14).
Logits are held to the dual gate of ``serving.parity`` (max |dlogit| <=
0.25, no greedy mismatch where JAX's top-two margin exceeds twice the
observed error), and at this size the greedy tokens come out equal and the
tests assert it (33 of 33 for the engine's six requests).  The JAX engine,
its static baseline and its jitted steps run once a module.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.serving.engine as jengine  # noqa: E402
from repro.configs import ServeConfig as JServeConfig  # noqa: E402
from repro.configs import get_arch, reduced  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models.params import init_tree as j_init_tree  # noqa: E402
from repro.models.registry import build_model as j_build  # noqa: E402
from repro.models.registry import init_cache as j_init_cache  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import (Engine, StateSlotPool,  # noqa: E402
                                 dual_gate, generate_static, replay_logits,
                                 speculation_k)
from repro_torch.serving.engine import _synthetic_frontend  # noqa: E402
from test_torch_engine import seeded_params  # noqa: E402

TOL = 0.25
ARCH = "seamless-m4t-large-v2"
SCFG = dict(page_size=8, max_slots=4, max_len=48)
LENS = (4, 30, 11, 7, 22, 15)
BUDGETS = [6, 4, 8, 5, 7, 3]
CHUNK = 16              # 30 and 22 take a continuation chunk


@pytest.fixture(autouse=True)
def one_thread():
    """The reduced model runs thousands of small ops: one torch thread
    keeps them cheap when the suite runs in several processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shared_frontend():
    """The JAX engine and its static path draw frontend inputs with the
    port's numpy function while this module runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "_synthetic_frontend", _synthetic_frontend)
        yield


def prompts_for(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(1, vocab, size=n).tolist() for n in LENS]


def frontend_key(cfg):
    return "frames" if cfg.enc_dec else "image_embeds"


def jax_static_logits(jcfg, jparams, scfg, prompt, frontend, tokens):
    """The JAX model's static path (the jitted bucketed prefill of its
    ``generate_static``, then ``decode``) teacher-forced along ``tokens``
    with ``frontend`` as the request's frames or image embeddings: the
    logits that predicted each token, fp32 [len(tokens), vocab]."""
    prefill, _ = jengine._static_steps(jcfg)
    decode = _jax_decode(jcfg)
    n_img = jcfg.n_image_tokens
    T = len(prompt)
    toks = np.zeros((1, scfg.bucket_of(T)), np.int32)
    toks[0, :T] = prompt
    batch = {"tokens": jnp.asarray(toks),
             frontend_key(jcfg): jnp.asarray(frontend[None])}
    logits, cache = prefill(jparams, batch, jnp.asarray([n_img + T - 1]))
    if jcfg.enc_dec:
        fresh = j_init_tree(j_build(jcfg).cache_defs(
            1, scfg.max_len, enc_len=scfg.enc_len), jax.random.PRNGKey(0))
    else:
        fresh = j_init_cache(jcfg, 1, n_img + scfg.max_len)
    cache = jax.tree.map(
        lambda f, c: c if f.shape == c.shape else jnp.pad(
            c, [(0, fs - cs) for fs, cs in zip(f.shape, c.shape)]),
        fresh, cache)
    cache["pos"] = jnp.asarray([n_img + T], jnp.int32)
    out = [np.asarray(logits[0], np.float32)]
    for tok in tokens[:-1]:
        logits, cache = decode(jparams, cache, jnp.asarray([tok], jnp.int32))
        out.append(np.asarray(logits[0], np.float32))
    return np.stack(out)


_DECODES = {}


def _jax_decode(jcfg):
    if jcfg not in _DECODES:
        _DECODES[jcfg] = jax.jit(j_build(jcfg).decode)
    return _DECODES[jcfg]


def family_setup(arch, scfg, budgets):
    """(jcfg, tcfg, jparams, tparams, prompts, JAX engine tokens) for
    ``arch`` reduced, the JAX engine run once."""
    jcfg = dataclasses.replace(reduced(get_arch(arch)), remat="none")
    tcfg = tconfigs.reduced(tconfigs.get_arch(arch))
    jparams = seeded_params(jcfg, 0)
    tparams = params_from_numpy(tcfg, jax.device_get(jparams))
    prompts = prompts_for(jcfg.vocab)
    jeng = jengine.Engine(jcfg, JServeConfig(**scfg), jparams)
    jtokens = [r.tokens for r in jeng.run_offline(prompts, budgets)[0]]
    return jcfg, tcfg, jparams, tparams, prompts, jtokens


@pytest.fixture(scope="module")
def setup(shared_frontend):
    return family_setup(ARCH, {**SCFG, "prefill_chunk_tokens": CHUNK},
                        BUDGETS)


def _serve(tcfg, tparams, prompts, budgets, **kw):
    eng = Engine(tcfg, tconfigs.ServeConfig(**{**SCFG, **kw}), tparams,
                 device="cpu")
    with torch.no_grad():
        results, metrics = eng.run_offline(prompts, budgets)
    return eng, [r.tokens for r in results], metrics


def _within_ulps(test, ref, n):
    """Every element of ``test`` within ``n`` bf16 ulps of the largest
    |ref| in its row (the last axis), plus 2^-14."""
    ref, test = np.asarray(ref, np.float32), np.asarray(test, np.float32)
    top = np.maximum(np.abs(ref).max(-1, keepdims=True), 2.0 ** -14)
    ulp = np.exp2(np.floor(np.log2(top)) - 7)
    return bool((np.abs(test - ref) <= n * ulp + 2.0 ** -14).all())


def _frames(tcfg, n):
    scfg = tconfigs.ServeConfig(**SCFG)
    return np.stack([_synthetic_frontend(tcfg, scfg, 0, i) for i in range(n)])


def test_encode_matches_jax(setup):
    jcfg, tcfg, jparams, tparams, *_ = setup
    frames = _frames(tcfg, 2)
    want = jax.jit(j_build(jcfg).encode)(jparams, jnp.asarray(frames))
    with torch.no_grad():
        got = build_model(tcfg).encode(tparams, torch.as_tensor(frames))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 128)
    assert _within_ulps(got.float().numpy(), want, 2)


@pytest.mark.parametrize("Sq,Sk,G", [(5, 16, 2), (24, 7, 1)])
def test_noncausal_core_and_cross_attention_match_jax(setup, Sq, Sk, G):
    """The non-causal chunked core at Sq != Sk (several query blocks), and
    ``cross_attention_block`` with the layer's biases, against JAX's."""
    jcfg, tcfg, jparams, tparams, *_ = setup
    rng = np.random.RandomState(Sq)
    K, D = 2, 32
    q, k, v = (rng.randn(2, n, h, D).astype(np.float32)
               for n, h in ((Sq, K * G), (Sk, K), (Sk, K)))
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jattention.chunked_attention(*bf, causal=False, q_block=8)
    got = tattention.chunked_attention(
        *(torch.as_tensor(np.asarray(a, np.float32)).bfloat16() for a in bf),
        scale=1.0 / np.sqrt(D), q_block=8, causal=False)
    assert _within_ulps(got.float().numpy(), want, 1)
    x = rng.randn(2, Sq, 128).astype(np.float32)
    enc = rng.randn(2, Sk, 128).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["dec_blocks"]["cross_attn"])
    want = jattention.cross_attention_block(
        jcfg, jp, jnp.asarray(x, jnp.bfloat16), jnp.asarray(enc,
                                                            jnp.bfloat16))
    tp = {n: a[0] for n, a in tparams["dec_blocks"]["cross_attn"].items()}
    assert "bq" in tp and "bk" in tp and "bv" in tp
    with torch.no_grad():
        got = tattention.cross_attention_block(
            tcfg, tp, torch.as_tensor(x).bfloat16(),
            tattention.cross_kv(tp, torch.as_tensor(enc).bfloat16()))
    assert _within_ulps(got.float().numpy(), want, 1)


def test_static_prefill_and_decode_match_jax(setup):
    """The port's static path (``generate_static`` at batch 1) gives the
    JAX engine's tokens (which equal the JAX static path's), and its
    logits pass the dual gate against JAX's static path teacher-forced
    along them."""
    jcfg, tcfg, jparams, tparams, prompts, jtokens = setup
    scfg = tconfigs.ServeConfig(**SCFG)
    with torch.no_grad():
        tokens, _ = generate_static(tcfg, tparams, prompts, BUDGETS, scfg)
    assert tokens == jtokens
    i = 1                                           # the 30-token prompt
    frames = _synthetic_frontend(tcfg, scfg, 0, i)
    ref = jax_static_logits(jcfg, jparams, JServeConfig(**SCFG), prompts[i],
                            frames, tokens[i])
    model = build_model(tcfg)
    batch = {"tokens": torch.as_tensor([prompts[i]]),
             "frames": torch.as_tensor(frames[None])}
    with torch.no_grad():
        logits, cache = model.prefill(tparams, batch)
        assert cache["cross"]["k"].shape == (2, 1, scfg.enc_len, 2, 32)
        fresh = model.cache_defs(1, SCFG["max_len"], enc_len=scfg.enc_len)
        assert fresh["self"]["k"].shape == (2, 1, SCFG["max_len"], 2, 32)
        from repro_torch.models.registry import init_cache
        full = init_cache(tcfg, 1, SCFG["max_len"], "cpu",
                          enc_len=scfg.enc_len)
        for g in ("self", "cross"):
            for n in ("k", "v"):
                c = cache[g][n]
                full[g][n][:, :, :c.shape[2]] = c
        full["pos"] = cache["pos"]
        test = [logits[0].float().numpy()]
        for tok in tokens[i][:-1]:
            logits, full = model.decode(tparams, full, torch.tensor([tok]))
            test.append(logits[0].float().numpy())
    rep = dual_gate([ref], [np.stack(test)], [tokens[i]], tol=TOL)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def test_paged_prefill_continuation_and_decode_match_jax(setup):
    """Paged serving steps, one request: its 30-token prompt prefilled in
    chunks of 16 (the second through ``prefill_paged_cont``: no encoder,
    the pinned cross rows read back) then decoded, against the same prompt
    prefilled whole; both against JAX's static path by the dual gate, the
    chunked and the whole prompt's logits within one bf16 ulp of each
    row's largest |logit|, and the cross K/V the first chunk pinned equal
    to the whole prompt's bit for bit."""
    from repro_torch.models.attn_backend import (decode_meta,
                                                 meta_to_device,
                                                 prefill_meta)
    from repro_torch.models.steps import make_serve_step
    from repro_torch.serving import PagedKVPool
    jcfg, tcfg, jparams, tparams, prompts, jtokens = setup
    scfg = tconfigs.ServeConfig(**{**SCFG, "max_slots": 1})
    i = 1
    prompt, gen = prompts[i], jtokens[i]
    frames = _synthetic_frontend(tcfg, scfg, 0, i)
    extras = {"frames": torch.as_tensor(frames[None]).bfloat16()}
    first = make_serve_step(tcfg, "prefill_paged")
    cont = make_serve_step(tcfg, "prefill_paged_cont")
    decode = build_model(tcfg).decode_paged
    runs = {}
    for cut in (len(prompt), CHUNK):
        pool = PagedKVPool(tcfg, scfg)
        state = StateSlotPool(tcfg, scfg).state
        table = pool.new_table()
        pages = pool.alloc(pool.pages_for(len(prompt) + len(gen)))
        table[:len(pages)] = pages
        tables = table[None]
        out = []
        with torch.no_grad():
            for n0 in range(0, len(prompt), cut):
                chunk = prompt[n0:n0 + cut]
                T = -(-len(chunk) // 8) * 8
                toks = np.zeros((1, T), np.int32)
                toks[0, :len(chunk)] = chunk
                meta = meta_to_device(prefill_meta(
                    tcfg, 8, tables, np.zeros(1, np.int32),
                    np.array([n0], np.int32),
                    np.array([len(chunk)], np.int32), T), "cpu")
                step = first if n0 == 0 else cont
                logits, pool.kv, state = step(
                    tparams, pool.kv, state, meta, torch.as_tensor(toks),
                    extras if n0 == 0 else {})
            out.append(logits[0].float().numpy())
            for j, tok in enumerate(gen[:-1]):
                meta = meta_to_device(decode_meta(
                    tcfg, 8, tables, np.array([len(prompt) + j], np.int32)),
                    "cpu")
                logits, pool.kv, state = decode(tparams, pool.kv, state, meta,
                                                torch.tensor([tok]))
                out.append(logits[0].float().numpy())
        runs[cut] = (np.stack(out), state)
    whole, chunked = runs[len(prompt)][0], runs[CHUNK][0]
    for g in ("k", "v"):
        assert torch.equal(runs[CHUNK][1]["cross"][g],
                           runs[len(prompt)][1]["cross"][g])
    assert _within_ulps(chunked, whole, 1)
    ref = jax_static_logits(jcfg, jparams, JServeConfig(**SCFG), prompt,
                            frames, gen)
    rep = dual_gate([ref, ref], [whole, chunked], [gen, gen], tol=TOL)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}
    assert rep["greedy_equal_tokens"] == 2 * len(gen)


def test_engine_matches_jax_engine(setup):
    """The port's engine (chunk budget 16: two prompts take a continuation
    chunk) emits the JAX engine's tokens, and two requests replayed along
    them pass the dual gate against the JAX static path."""
    jcfg, tcfg, jparams, tparams, prompts, jtokens = setup
    eng, tokens, m = _serve(tcfg, tparams, prompts, BUDGETS,
                            prefill_chunk_tokens=CHUNK)
    assert m["chunked_prefill_steps"] > 0
    assert tokens == jtokens
    assert sum(map(len, tokens)) == 33
    scfg = tconfigs.ServeConfig(**SCFG)
    pick = [1, 4]
    fronts = [_synthetic_frontend(tcfg, scfg, 0, i) for i in pick]
    ref = [jax_static_logits(jcfg, jparams, JServeConfig(**SCFG),
                             prompts[i], f, tokens[i])
           for i, f in zip(pick, fronts)]
    with torch.no_grad():
        test = [replay_logits(tcfg, scfg, tparams, prompts[i], tokens[i],
                              frontend=f) for i, f in zip(pick, fronts)]
    rep = dual_gate(ref, test, [tokens[i] for i in pick], tol=TOL)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def test_chunked_prompt_equals_unchunked(setup):
    """Chunk budgets of 8 and 16 (continuation chunks that run no encoder)
    give the unchunked engine's tokens and the JAX engine's."""
    _, tcfg, _, tparams, prompts, jtokens = setup
    _, whole, m0 = _serve(tcfg, tparams, prompts, BUDGETS)
    assert m0["chunked_prefill_steps"] == 0
    for chunk in (8, CHUNK):
        _, tokens, m = _serve(tcfg, tparams, prompts, BUDGETS,
                              prefill_chunk_tokens=chunk)
        assert m["chunked_prefill_steps"] > 0
        assert tokens == whole == jtokens


def test_slot_bytes_and_preemption_replay(setup):
    """A slot pins 2 x n_dec_layers x enc_len x K x D bf16 values; a
    preempted request gives its slot back, replays its prompt (encoding
    its frames again) and ends with the baseline's tokens, and the drain
    leaves no page and no slot held."""
    _, tcfg, _, tparams, prompts, jtokens = setup
    scfg = tconfigs.ServeConfig(**{**SCFG, "prefill_chunk_tokens": CHUNK})
    eng = Engine(tcfg, scfg, tparams, device="cpu")
    assert eng.states.slot_nbytes == 2 * 2 * scfg.enc_len * 2 * 32 * 2
    defs = build_model(tconfigs.get_arch(ARCH)).state_slot_defs(1, 64, enc_len=4096)
    assert defs["cross"]["k"].shape == (24, 1, 4096, 16, 64)
    encoded = []
    model_encode = eng.model.__class__.encode

    def counting_encode(self, params, frames):
        encoded.append(frames.shape[0])
        return model_encode(self, params, frames)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eng.model.__class__, "encode", counting_encode)
        for p, b in zip(prompts, BUDGETS):
            eng.add_request(p, b)
        preempted = None
        with torch.no_grad():
            while eng.step():
                s = eng.sched.slots[1]
                if preempted is None and s is not None \
                        and len(s.req.generated) == 2:
                    preempted = s.req.rid
                    eng.sched.preempt(1)
    res = sorted(eng.collect(), key=lambda r: r.rid)
    assert preempted is not None and res[preempted].n_preemptions == 1
    assert [r.tokens for r in res] == jtokens
    assert eng.metrics.value("engine.state_restores") == 0
    # one encode a first chunk: six admissions plus the replay
    assert len(encoded) == eng.metrics.value("engine.prefill_steps") \
        - eng.metrics.value("engine.chunked_prefill_steps")
    assert sum(encoded) >= len(prompts) + 1
    assert eng.pool.conservation_ok() and eng.pool.num_allocated == 0
    assert eng.states.num_claimed == 0


def test_speculation_is_off_and_cli_verifies(setup, capsys):
    """enc-dec serves non-speculatively (``speculation_k`` = 0) with the
    JAX CLI's notice, and the CLI's ``--verify`` passes with continuation
    chunks, bf16 and int8 pages (the latter by the dual gate)."""
    _, tcfg, _, tparams, prompts, jtokens = setup
    scfg = tconfigs.ServeConfig(**{**SCFG, "speculate_tokens": 4})
    assert speculation_k(tcfg, build_model(tcfg).cache_spec(), scfg) == 0
    eng, tokens, m = _serve(tcfg, tparams, prompts, BUDGETS,
                            speculate_tokens=4)
    assert eng.spec_k == 0 and "spec_tokens" not in m and tokens == jtokens
    base = ["--device", "cpu", "--reduced", "--arch", ARCH, "--requests",
            "4", "--mixed", "--prompt-len", "40", "--gen", "6", "--verify"]
    tserve.main(base + ["--prefill-chunk-tokens", "16",
                        "--speculate-tokens", "4"])
    out = capsys.readouterr().out
    assert "speculation disabled for seamless-m4t-large-v2" in out
    assert "verify OK" in out and "continuation chunks" in out
    tserve.main(base + ["--kv-dtype", "int8"])
    assert "dual gate passed" in capsys.readouterr().out
