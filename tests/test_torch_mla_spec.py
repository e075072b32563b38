"""MLA speculative decoding and int8 latent pages in the port, on the CPU.

1. *Latent verify core* -- ``mla_paged_verify_plain`` (kernel K7's plain
   version and the reference backend's MLA verify core) against the Pallas
   ``mla_paged_verify_fwd`` in interpret mode, Q = 1, 3 and 5, ragged live
   query counts and an idle row (position 0, null table), bf16 pages and
   int8 pages quantized by the port's ``quantize_int8``: each element
   within one bf16 ulp of the largest magnitude in its row, never below
   2^-14 (the rule of ``test_torch_kernels``); dead query rows are exact
   zeros on both sides.  At one live query it is the plain K5, bit for bit.
2. *Model step* -- reduced deepseek-v2's ``verify_paged``: row j equals the
   decode step at ``pos + j`` bit for bit on the reference backend, bf16
   and int8 pages.
3. *Engine* -- n-gram speculation (K = 4) on reduced deepseek-v2 emits the
   port's non-speculative tokens and ``generate_static``'s; the
   speculative run and an int8 run each pass the dual gate against the JAX
   package's replay (reference backend) along their tokens; the int8 pool
   holds kv_lora + rope int8 values and two bf16 scales a token and layer.
4. *CLI* -- ``--kv-dtype int8 --verify`` and ``--speculate-tokens 4
   --verify`` on deepseek-v2.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ServeConfig as JServeConfig  # noqa: E402
from repro.kernels.paged_attention.kernel import (  # noqa: E402
    mla_paged_verify_fwd)
from repro.serving.quant_verify import replay_logits as j_replay  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    mla_paged_decode_plain, mla_paged_verify, mla_paged_verify_plain)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.attn_backend import (  # noqa: E402
    decode_meta, meta_to_device, prefill_meta, verify_meta)
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import (Engine, PagedKVPool, dual_gate,  # noqa: E402
                                 generate_static, replay_logits)
from test_torch_kernels import _bf16, _within_one_ulp  # noqa: E402
from test_torch_mla import ARCH, SCFG, TOL, _pools, setup  # noqa: E402,F401

# ------------------------------------------------------- latent verify core


from _torch_common import one_thread  # noqa: E402, F401


def _verify_case(rng, Q, int8, ps=8, H=4, L=32, R=16, width=5):
    """B = 4 rows: an idle row (position 0, null table, one live query) and
    three at random positions whose Q-token window fits the table span, with
    random live-query counts 1..Q."""
    B = 4
    pos = np.concatenate([[0], rng.randint(1, width * ps - Q, size=B - 1)])
    n_q = np.concatenate([[1], rng.randint(1, Q + 1, size=B - 1)])
    lengths = list(pos + Q)
    lengths[0] = 0
    jp, tp, tables = _pools(rng, lengths, ps, L, R, width, int8)
    (qj, qt), (qrj, qrt) = (_bf16(rng.randn(B, Q, H, L)),
                            _bf16(rng.randn(B, Q, H, R)))
    return (qj, qrj) + jp, (qt, qrt) + tp, tables, pos.astype(np.int32), \
        n_q.astype(np.int32)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("Q", [1, 3, 5])
def test_mla_verify_plain_matches_pallas(Q, int8):
    rng = np.random.RandomState(10 * Q + int8)
    (qj, qrj, cj, rj, csj, rsj), (qt, qrt, ct, rt, cst, rst), tables, pos, \
        n_q = _verify_case(rng, Q, int8)
    scale = 1.0 / math.sqrt(48)
    ref = np.asarray(mla_paged_verify_fwd(
        qj, qrj, cj, rj, jnp.asarray(tables), jnp.asarray(pos),
        jnp.asarray(n_q), scale=scale, ckv_scale=csj, krope_scale=rsj,
        interpret=True), np.float32)
    args = (qt, qrt, ct, rt, torch.from_numpy(tables), torch.from_numpy(pos),
            torch.from_numpy(n_q))
    kw = dict(scale=scale, ckv_scale=cst, krope_scale=rst)
    got = mla_paged_verify_plain(*args, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    g = got.float().numpy()
    assert _within_one_ulp(g, ref)
    for b in range(len(pos)):                    # dead rows are exact zeros
        assert not g[b, n_q[b]:].any() and not ref[b, n_q[b]:].any()
    # the wrapper runs the plain version for CPU tensors, and counts nothing
    n = mla_paged_verify.launches
    assert torch.equal(mla_paged_verify(*args, **kw), got)
    assert mla_paged_verify.launches == n


@pytest.mark.parametrize("int8", [False, True])
def test_mla_verify_with_one_live_query_is_decode(int8):
    rng = np.random.RandomState(70 + int8)
    _, (qt, qrt, ct, rt, cst, rst), tables, pos, _ = _verify_case(rng, 5,
                                                                  int8)
    t, p = torch.from_numpy(tables), torch.from_numpy(pos)
    kw = dict(scale=0.2, ckv_scale=cst, krope_scale=rst)
    got = mla_paged_verify_plain(qt, qrt, ct, rt, t, p, torch.ones_like(p),
                                 **kw)
    want = mla_paged_decode_plain(qt[:, 0].contiguous(),
                                  qrt[:, 0].contiguous(), ct, rt, t, p, **kw)
    torch.testing.assert_close(got[:, 0], want, rtol=0, atol=0)
    assert not got[:, 1:].float().abs().sum()


# --------------------------------------------------------------- model step

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_mla_verify_rows_equal_decode_rows(setup, kv_dtype):
    """Two rows prefilled into one pool, one verify step with four and two
    drafts, then Q decode steps fed the same tokens: every live row j of the
    verify logits equals the decode step's at pos + j bit for bit."""
    _, tcfg, _, tparams, _, _ = setup
    ps, Q = 8, 5
    pool = PagedKVPool(tcfg, tconfigs.ServeConfig(
        page_size=ps, max_slots=2, max_len=48, kv_dtype=kv_dtype))
    rng = np.random.RandomState(5)
    lens = np.asarray([13, 7], np.int32)
    tables = np.zeros((2, pool.table_width), np.int32)
    T = 16
    toks = np.zeros((2, T), np.int32)
    for b, n in enumerate(lens):
        pages = pool.alloc(pool.pages_for(int(n) + Q))
        tables[b, :len(pages)] = pages
        toks[b, :n] = rng.randint(1, tcfg.vocab, size=n)
    n_q = np.asarray([5, 3], np.int32)
    vt = rng.randint(1, tcfg.vocab, size=(2, Q)).astype(np.int32)
    vt[1, 3:] = 0
    model = build_model(tcfg)
    with torch.no_grad():
        _, kv, _ = model.prefill_paged(
            tparams, pool.kv, {}, meta_to_device(prefill_meta(
                tcfg, ps, tables, np.arange(2, dtype=np.int32),
                np.zeros(2, np.int32), lens, T), "cpu"),
            torch.from_numpy(toks))
        tv, kv, _ = model.verify_paged(
            tparams, kv, {}, meta_to_device(verify_meta(
                tcfg, ps, tables, lens, n_q, Q), "cpu"),
            torch.from_numpy(vt))
        assert tv.shape == (2, Q, tcfg.vocab_padded)
        equal = 0
        for j in range(Q):
            dec, kv, _ = model.decode_paged(
                tparams, kv, {}, meta_to_device(
                    decode_meta(tcfg, ps, tables, lens + j), "cpu"),
                torch.from_numpy(vt[:, j]))
            for b in np.nonzero(j < n_q)[0]:
                equal += int(torch.equal(dec[b], tv[b, j]))
    assert equal == int(n_q.sum())


# ------------------------------------------------------------------- engine

def _serve(tcfg, tparams, prompts, budgets, **kw):
    eng = Engine(tcfg, tconfigs.ServeConfig(**{**SCFG, **kw}), tparams,
                 device="cpu")
    with torch.no_grad():
        results, m = eng.run_offline(prompts, budgets)
    return eng, [r.tokens for r in results], m


def _gate_against_jax(setup, tokens, kv_dtype):
    """The dual gate of the port's replay along ``tokens`` against the JAX
    package's replay (reference backend) with the same seeded parameters
    and pool dtype, on request 1: a prefix-cache hit whose tail spans a
    chunk.  (The JAX replay runs eagerly, ~2 s a token on the CPU, so one
    request.)"""
    jcfg, tcfg, jparams, tparams, prompts, _ = setup
    jscfg, tscfg = JServeConfig(**SCFG), tconfigs.ServeConfig(**SCFG)
    ref = [j_replay(jcfg, jscfg, jparams, prompts[1], tokens[1],
                    kv_dtype=kv_dtype)]
    with torch.no_grad():
        test = [replay_logits(tcfg, tscfg, tparams, prompts[1], tokens[1],
                              kv_dtype=kv_dtype)]
    return dual_gate(ref, test, [tokens[1]], tol=TOL)


def test_mla_speculative_engine_matches_plain_and_static(setup):
    _, tcfg, _, tparams, prompts, budgets = setup
    eng, tokens, m = _serve(tcfg, tparams, prompts, budgets,
                            speculate_tokens=4)
    assert eng.spec_k == 4 and m["spec_proposed"] > 0
    assert m["cached_tokens"] > 0 and m["chunked_prefill_steps"] > 0
    assert eng.pool.conservation_ok()
    _, plain, _ = _serve(tcfg, tparams, prompts, budgets)
    assert tokens == plain
    with torch.no_grad():
        ref, _ = generate_static(tcfg, tparams, prompts, budgets,
                                 tconfigs.ServeConfig(**SCFG))
    assert tokens == ref
    rep = _gate_against_jax(setup, tokens, "bf16")
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def test_mla_int8_engine_passes_the_dual_gate_against_jax(setup):
    """int8 latent pages without and with speculation: the speculative
    stream equals the plain int8 stream, and that stream passes the dual
    gate against the JAX int8 replay."""
    _, tcfg, _, tparams, prompts, budgets = setup
    eng, tokens, m = _serve(tcfg, tparams, prompts, budgets,
                            kv_dtype="int8")
    assert [len(t) for t in tokens] == budgets
    assert m["cached_tokens"] > 0 and eng.pool.conservation_ok()
    assert {"ckv_scale", "krope_scale"} <= set(eng.pool.kv)
    # kv_lora + rope int8 values and two bf16 scales a token and layer
    assert eng.pool.kv_bytes_per_token == \
        tcfg.n_layers * (tcfg.kv_lora_rank + tcfg.rope_head_dim + 4)
    eng, spec, m = _serve(tcfg, tparams, prompts, budgets, kv_dtype="int8",
                          speculate_tokens=4)
    assert m["spec_proposed"] > 0 and eng.pool.conservation_ok()
    assert spec == tokens
    rep = _gate_against_jax(setup, tokens, "int8")
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


# ---------------------------------------------------------------------- CLI

@pytest.mark.parametrize("flags,says", [
    (["--kv-dtype", "int8"], "dual gate passed for 6 requests"),
    (["--speculate-tokens", "4"], "verify OK: 6 requests"),
])
def test_cli_serves_deepseek_int8_and_speculative(capsys, flags, says):
    tokens = tserve.main([
        "--device", "cpu", "--arch", ARCH, "--reduced", "--requests", "6",
        "--mixed", "--prompt-len", "48", "--prefix-cache", "--shared-prefix",
        "2", "--prefill-chunk-tokens", "16", *flags, "--verify"])
    assert len(tokens) == 6
    assert says in capsys.readouterr().out
