"""The vlm family (reduced llava-next-34b: 2 layers, d 128, 4 query / 2 KV
heads of 32, an image prefix of 8 patch embeddings of width 64 projected by
``vision_proj``) in the port against ``repro.models.transformer`` and the
JAX engine.

Parameters are drawn with numpy and the image embeddings with the port's
``_synthetic_frontend``, monkeypatched into the JAX engine module for this
module's tests (see ``test_torch_encdec``, whose helpers this file shares).
``prefill_meta`` equals the JAX function's key by key, with an image
prefix and without (a plain and a sliding-window arch).  The image-prefix
embedding is one bf16 product each side: within one bf16 ulp of each row's
largest |JAX value|.  Logits are held to the dual gate (max |dlogit| <=
0.25, no greedy mismatch where JAX's top-two margin exceeds twice the
observed error), and the greedy tokens come out equal to the JAX engine's
(33 of 33) and the tests assert it.  A vlm prompt is never chunked and its
prefix is not cacheable (the JAX rules), its pages count the image prefix,
and n-gram speculation leaves its greedy stream unchanged.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ServeConfig as JServeConfig  # noqa: E402
from repro.configs import get_arch, reduced  # noqa: E402
from repro.models.attn_backend import prefill_meta as j_prefill_meta  # noqa: E402
from repro.models.registry import build_model as j_build  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.attn_backend import prefill_meta  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import (Engine, PagedKVPool,  # noqa: E402
                                 dual_gate, generate_static, replay_logits)
from repro_torch.serving.engine import _synthetic_frontend  # noqa: E402
from test_torch_encdec import (BUDGETS, SCFG, _within_ulps,  # noqa: E402
                               family_setup, jax_static_logits, one_thread,
                               shared_frontend)

TOL = 0.25
ARCH = "llava-next-34b"
N_IMG = 8
_ = (one_thread, shared_frontend)      # fixtures used by this module


@pytest.fixture(scope="module")
def setup(shared_frontend):
    return family_setup(ARCH, SCFG, BUDGETS)


def _serve(tcfg, tparams, prompts, budgets, **kw):
    eng = Engine(tcfg, tconfigs.ServeConfig(**{**SCFG, **kw}), tparams,
                 device="cpu")
    with torch.no_grad():
        results, metrics = eng.run_offline(prompts, budgets)
    return eng, [r.tokens for r in results], metrics


def _image(tcfg, rid):
    return _synthetic_frontend(tcfg, tconfigs.ServeConfig(**SCFG), 0, rid)


def test_image_prefix_embedding_matches_jax(setup):
    """``image_embeds @ vision_proj`` before the text embeddings, as JAX's
    ``_embed_inputs`` builds the hidden sequence."""
    jcfg, tcfg, jparams, tparams, prompts, _ = setup
    img = np.stack([_image(tcfg, 0), _image(tcfg, 1)])
    toks = np.array([prompts[0][:4], prompts[3][:4]], np.int32)
    want, mask = j_build(jcfg)._embed_inputs(
        jparams, {"tokens": jnp.asarray(toks),
                  "image_embeds": jnp.asarray(img)})
    assert not bool(np.asarray(mask)[:, :N_IMG].any())
    model = build_model(tcfg)
    assert tparams["vision_proj"].shape == (64, 128)
    with torch.no_grad():
        got = model._with_image(
            tparams, tparams["embed"]["tok"][torch.as_tensor(toks).long()],
            {"image_embeds": torch.as_tensor(img)})
    assert got.shape == (2, N_IMG + 4, 128)
    assert _within_ulps(got.float().numpy(), want, 1)
    assert np.array_equal(got[:, N_IMG:].float().numpy(),
                          np.asarray(want[:, N_IMG:], np.float32))


@pytest.mark.parametrize("arch", ["llava-next-34b", "qwen2-0.5b",
                                  "starcoder2-7b"])
def test_prefill_meta_matches_jax_key_by_key(arch):
    """The port's ``prefill_meta`` lays its write targets over the hidden
    width ``n_image_tokens + T`` (8 + 16 for llava, 16 without a prefix,
    a 4-page ring for the windowed arch) as JAX's does, key by key."""
    jcfg = reduced(get_arch(arch))
    tcfg = tconfigs.reduced(tconfigs.get_arch(arch))
    assert tcfg.n_image_tokens == (N_IMG if arch == ARCH else 0)
    rng = np.random.RandomState(3)
    B, width, T, ps = 3, 6, 16, 8
    tables = rng.randint(1, 40, size=(B, width)).astype(np.int32)
    slots = np.array([0, 2, 4], np.int32)
    start = np.array([0, 8, 24], np.int32) if not tcfg.n_image_tokens \
        else np.zeros(B, np.int32)
    n_tail = np.array([16, 5, 11], np.int32)
    want = j_prefill_meta(jcfg, ps, tables, slots, start, n_tail, T)
    got = prefill_meta(tcfg, ps, tables, slots, start, n_tail, T)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert got["write_page"].shape == (B, tcfg.n_image_tokens + T)


def test_static_prefill_and_decode_match_jax(setup):
    """The port's ``generate_static`` (positions offset by the prefix, the
    cache grown to n_img + max_len) gives the JAX engine's tokens, and its
    logits pass the dual gate against JAX's static path."""
    jcfg, tcfg, jparams, tparams, prompts, jtokens = setup
    scfg = tconfigs.ServeConfig(**SCFG)
    with torch.no_grad():
        tokens, _ = generate_static(tcfg, tparams, prompts, BUDGETS, scfg)
    assert tokens == jtokens
    i = 1
    model = build_model(tcfg)
    img = _image(tcfg, i)
    with torch.no_grad():
        logits, cache = model.prefill(
            tparams, {"tokens": torch.as_tensor([prompts[i]]),
                      "image_embeds": torch.as_tensor(img[None])})
        assert int(cache["pos"][0]) == N_IMG + len(prompts[i])
        test = replay_logits(tcfg, scfg, tparams, prompts[i], tokens[i],
                             frontend=img)
    ref = jax_static_logits(jcfg, jparams, JServeConfig(**SCFG), prompts[i],
                            img, tokens[i])
    # the static prefill's logits and the paged replay's, both by the gate
    rep = dual_gate([ref[:1], ref], [logits.float().numpy(), test],
                    [tokens[i][:1], tokens[i]], tol=TOL)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def test_engine_matches_jax_engine(setup):
    jcfg, tcfg, jparams, tparams, prompts, jtokens = setup
    _, tokens, m = _serve(tcfg, tparams, prompts, BUDGETS)
    assert tokens == jtokens and sum(map(len, tokens)) == 33
    scfg = tconfigs.ServeConfig(**SCFG)
    pick = [2, 4]
    ref = [jax_static_logits(jcfg, jparams, JServeConfig(**SCFG),
                             prompts[i], _image(tcfg, i), tokens[i])
           for i in pick]
    with torch.no_grad():
        test = [replay_logits(tcfg, scfg, tparams, prompts[i], tokens[i],
                              frontend=_image(tcfg, i)) for i in pick]
    rep = dual_gate(ref, test, [tokens[i] for i in pick], tol=TOL)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def test_no_chunking_and_prefix_cache_refused(setup, capsys):
    """A chunk budget and the prefix cache are both asked for: the prompt
    is never chunked, the cache is refused with the JAX warning, and the
    tokens are the JAX engine's."""
    _, tcfg, _, tparams, prompts, jtokens = setup
    eng, tokens, m = _serve(tcfg, tparams, prompts, BUDGETS,
                            prefill_chunk_tokens=8, prefix_cache=True)
    assert "WARNING: prefix cache disabled for llava-next-34b" \
        in capsys.readouterr().out
    assert eng.radix is None and eng.sched.chunk == 0
    assert m["chunked_prefill_steps"] == 0 and tokens == jtokens
    assert not build_model(tcfg).cache_spec().prefix_cacheable


def test_pages_count_the_image_prefix(setup):
    """Pages, table width and a slot's first decode position all count
    the 8 image positions before the text."""
    _, tcfg, _, tparams, prompts, _ = setup
    scfg = tconfigs.ServeConfig(**SCFG)
    pool = PagedKVPool(tcfg, scfg)
    assert pool.spec.prefix_tokens == N_IMG
    assert pool.table_width == -(-(N_IMG + SCFG["max_len"]) // 8)
    for n in (1, 8, 9, 30):
        assert pool.pages_for(n) == -(-(N_IMG + n) // 8)
    eng = Engine(tcfg, scfg, tparams, device="cpu")
    eng.add_request(prompts[1], 2)
    adm = eng.sched.try_admit()
    assert len(adm.pages) == -(-(N_IMG + len(prompts[1])) // 8)
    assert eng.sched.slots[adm.slot_idx].pos == N_IMG + len(prompts[1])


def test_ngram_stream_equals_plain_and_cli_verifies(setup, capsys):
    """n-gram speculation (K = 4: verify positions past the prefix) gives
    the plain stream on the reference backend, and the CLI's ``--verify``
    passes with speculation and with int8 pages."""
    _, tcfg, _, tparams, prompts, jtokens = setup
    # repeated prompts give the n-gram proposer drafts to verify
    rep = [(p[:6] * 4)[:20] for p in prompts]
    _, plain, _ = _serve(tcfg, tparams, rep, BUDGETS)
    eng, spec, m = _serve(tcfg, tparams, rep, BUDGETS, speculate_tokens=4)
    assert eng.spec_k == 4 and m["spec_proposed"] > 0
    assert spec == plain
    base = ["--device", "cpu", "--reduced", "--arch", ARCH, "--requests",
            "4", "--mixed", "--prompt-len", "24", "--gen", "8", "--verify"]
    tserve.main(base + ["--speculate-tokens", "4"])
    out = capsys.readouterr().out
    assert "speculation: K=4" in out and "verify OK" in out
    tserve.main(base + ["--kv-dtype", "int8"])
    assert "dual gate passed" in capsys.readouterr().out
