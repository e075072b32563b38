"""Speculative decoding in the port, on the CPU, against the JAX package.

1. *Verify core* — ``paged_verify_plain`` (the plain version of kernel K3
   and the reference backend's verify core) against the Pallas
   ``paged_verify_fwd`` in interpret mode, held as the other kernel tests
   are: each element within one bf16 ulp of the largest magnitude in its
   row, never below 2^-14; dead query rows are exact zeros on both sides.
   With one query it is the decode core.
2. *Verify metadata* — write targets, dead rows to the null page, and
   ring (sliding window) write targets wrapping modulo the table width.
3. *Model step* — ``DecoderLM.verify_paged`` against the JAX model's, with
   the same numpy-seeded parameters: dual gate (max |dlogit| <= 0.25) and
   exact greedy tokens, which hold at this size; and row j of the verify
   logits equals the decode step's at ``pos + j`` bit for bit.
4. *Engine* — the speculative engine's tokens equal the JAX speculative
   engine's, the non-speculative engine's and ``generate_static``'s, with
   the prefix cache and chunked prefill on, bf16 and int8; planted oracle
   and anti-oracle proposers accept all and nothing with identical
   streams; full-accept steps cross page boundaries; a rejected draft
   never reaches the radix cache.
5. *CLI* — ``launch.serve --speculate-tokens 4 --verify``.
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
from repro.kernels.paged_attention.kernel import paged_verify_fwd  # noqa: E402
from repro.models.attn_backend import prefill_meta as j_prefill_meta  # noqa: E402
from repro.models.attn_backend import verify_meta as j_verify_meta  # noqa: E402
from repro.models.registry import build_model as j_build  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving.kv_pool import PagedKVPool as JPool  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_plain, paged_verify, paged_verify_plain)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.attn_backend import (  # noqa: E402
    decode_meta, meta_to_device, prefill_meta, verify_meta)
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import (Engine, PagedKVPool, dual_gate,  # noqa: E402
                                 generate_static)
from test_torch_engine import seeded_params  # noqa: E402
from test_torch_kernels import (_bf16, _pool_and_tables,  # noqa: E402
                                _within_one_ulp)

TOL = 0.25


from _torch_common import one_thread  # noqa: E402, F401


@pytest.fixture(scope="module")
def setup():
    jcfg = reduced(get_arch("qwen2-0.5b"))
    tcfg = tconfigs.reduced(tconfigs.get_arch("qwen2-0.5b"))
    jparams = seeded_params(jcfg, 0)
    tparams = params_from_numpy(tcfg, jax.device_get(jparams))
    return jcfg, tcfg, jparams, tparams


def _prompts(vocab, rng, n=4):
    """Repetitive prompts (prompt lookup's best case, so drafts are really
    accepted) alternating with iid-random ones (accept ~0)."""
    out = []
    for i in range(n):
        if i % 2 == 0:
            motif = rng.randint(1, vocab, size=4).tolist()
            out.append((motif * 5)[:18])
        else:
            out.append(rng.randint(1, vocab, size=12).tolist())
    return out


def _serve(tcfg, tparams, prompts, budgets, proposer=None, **kw):
    eng = Engine(tcfg, tconfigs.ServeConfig(**kw), tparams, device="cpu")
    if proposer is not None:
        eng.proposer = proposer(eng.spec_k)
    with torch.no_grad():
        res, m = eng.run_offline(prompts, budgets)
    return eng, [r.tokens for r in res], m


# --------------------------------------------------------------- verify core

VERIFY_CASES = [
    # (ps, K, G, D, width)
    (8, 2, 2, 32, 5),       # GQA 2:1
    (16, 1, 6, 64, 3),      # MQA
    (4, 4, 1, 16, 6),       # MHA, small pages
    (16, 2, 7, 64, 3),      # qwen2-0.5b's head layout
]


def _verify_case(rng, ps, K, G, D, width, Q):
    B = 4
    # row 0 is the fresh-sequence case (pos 0, one query); the others sit
    # where their Q-token window still fits the table span
    pos = np.concatenate([[0], rng.randint(1, width * ps - Q, size=B - 1)])
    n_q = np.concatenate([[1], rng.randint(1, Q + 1, size=B - 1)])
    (kj, kt), (vj, vt), tables = _pool_and_tables(rng, pos + Q, ps, K, D,
                                                  width)
    qj, qt = _bf16(rng.randn(B, Q, K * G, D))
    return (qj, kj, vj, qt, kt, vt, tables, pos.astype(np.int32),
            n_q.astype(np.int32))


@pytest.mark.parametrize("Q", [1, 2, 5])
@pytest.mark.parametrize("ps,K,G,D,width", VERIFY_CASES)
def test_paged_verify_plain_matches_pallas(ps, K, G, D, width, Q):
    rng = np.random.RandomState(ps * 10 + G + Q)
    qj, kj, vj, qt, kt, vt, tables, pos, n_q = _verify_case(
        rng, ps, K, G, D, width, Q)
    B, H, scale = len(pos), K * G, 1.0 / math.sqrt(D)
    ref = paged_verify_fwd(
        qj.reshape(B, Q, K, G, D).transpose(0, 2, 1, 3, 4), kj, vj,
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(n_q),
        scale=scale, interpret=True)
    ref = np.asarray(ref, np.float32).transpose(0, 2, 1, 3, 4) \
        .reshape(B, Q, H, D)
    got = paged_verify_plain(qt, kt, vt, torch.from_numpy(tables),
                             torch.from_numpy(pos), torch.from_numpy(n_q),
                             scale=scale)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Q, H, D)
    got = got.float().numpy()
    assert _within_one_ulp(got, ref)
    for b in range(B):                    # dead rows are exact zeros
        assert not got[b, n_q[b]:].any() and not ref[b, n_q[b]:].any()


@pytest.mark.parametrize("int8", [False, True])
def test_verify_with_one_query_is_decode(int8):
    from repro_torch.models.attention import quantize_int8
    rng = np.random.RandomState(40 + int8)
    _, _, _, qt, kt, vt, tables, pos, _ = _verify_case(rng, 8, 2, 2, 32, 5, 1)
    kw = dict(scale=0.2)
    if int8:
        (kt, kw["k_scale"]), (vt, kw["v_scale"]) = (quantize_int8(kt),
                                                    quantize_int8(vt))
    t, p = torch.from_numpy(tables), torch.from_numpy(pos)
    got = paged_verify_plain(qt, kt, vt, t, p, torch.ones_like(p), **kw)
    want = paged_decode_plain(qt[:, 0], kt, vt, t, p, **kw)
    torch.testing.assert_close(got[:, 0], want, rtol=0, atol=0)


def test_verify_wrapper_runs_the_plain_version_on_cpu():
    rng = np.random.RandomState(7)
    _, _, _, qt, kt, vt, tables, pos, n_q = _verify_case(rng, 8, 2, 2, 32, 5,
                                                         3)
    args = (qt, kt, vt, torch.from_numpy(tables), torch.from_numpy(pos),
            torch.from_numpy(n_q))
    n0 = paged_verify.launches
    torch.testing.assert_close(paged_verify(*args, scale=0.2),
                               paged_verify_plain(*args, scale=0.2),
                               rtol=0, atol=0)
    assert paged_verify.launches == n0    # counts kernel launches only


# ------------------------------------------------------------ verify meta

def test_verify_meta_write_targets_and_dead_rows(setup):
    _, tcfg, _, _ = setup
    tables = np.asarray([[3, 5, 7], [4, 6, 8]], np.int32)
    pos = np.asarray([5, 0], np.int32)
    n_q = np.asarray([3, 1], np.int32)
    meta = verify_meta(tcfg, 4, tables, pos, n_q, 3)
    # row 0: positions 5, 6, 7 all land in table column 1 -> page 5
    np.testing.assert_array_equal(meta["write_page"][0], [5, 5, 5])
    np.testing.assert_array_equal(meta["write_off"][0], [1, 2, 3])
    # row 1: only query 0 is live; the dead tail routes to the null page
    np.testing.assert_array_equal(meta["write_page"][1], [4, 0, 0])
    jmeta = j_verify_meta(reduced(get_arch("qwen2-0.5b")), 4, tables, pos,
                          n_q, 3)
    for k in meta:
        np.testing.assert_array_equal(meta[k], np.asarray(jmeta[k]))


def test_verify_meta_ring_waits_for_the_window_slice(setup):
    """The window slice has landed: a ring's verify writes wrap modulo the
    table width (positions 7 and 8 of a 2-page ring of 4-token pages land
    in its second page, then back in its first), as the JAX meta does."""
    _, tcfg, _, _ = setup
    cfg = dataclasses.replace(tcfg, sliding_window=8)
    args = (4, np.asarray([[11, 13]], np.int32), np.asarray([7], np.int32),
            np.asarray([2], np.int32), 2)
    meta = verify_meta(cfg, *args)
    np.testing.assert_array_equal(meta["write_page"], [[13, 11]])
    np.testing.assert_array_equal(meta["write_off"], [[3, 0]])
    jmeta = j_verify_meta(dataclasses.replace(reduced(get_arch("qwen2-0.5b")),
                                              sliding_window=8), *args)
    for k in meta:
        np.testing.assert_array_equal(meta[k], np.asarray(jmeta[k]))


# --------------------------------------------------------------- model step

def test_verify_paged_logits_match_jax(setup):
    """Two rows prefilled into both frameworks' pools, then one verify step
    with four and two drafts: the live rows' logits pass the dual gate with
    exact greedy tokens, and every row j equals the port's own decode
    logits at pos + j (one-token steps fed the same tokens)."""
    jcfg, tcfg, jparams, tparams = setup
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
    first = np.argmax(np.asarray(jl, np.float32), -1)
    assert (first == tl.float().numpy().argmax(-1)).all()
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
    test = [tv[b, :n_q[b]] for b in range(2)]
    greedy = [r.argmax(-1) for r in ref]
    rep = dual_gate(ref, test, greedy, tol=TOL)
    assert rep["ok"], rep
    assert rep["greedy_equal_tokens"] == int(n_q.sum())     # exact here
    # row j is the decode step at pos + j: replay the same tokens one step
    # at a time (each decode rewrites the K/V the verify wrote, unchanged)
    with torch.no_grad():
        for j in range(Q):
            pos = n_tail + j
            live = j < n_q
            dec, kv, _ = model.decode_paged(
                tparams, kv, {}, meta_to_device(
                    decode_meta(tcfg, ps, tables, pos.astype(np.int32)),
                    "cpu"), torch.from_numpy(vt[:, j]))
            dec = dec.float().numpy()
            for b in np.nonzero(live)[0]:
                np.testing.assert_array_equal(dec[b], tv[b, j])


# ------------------------------------------------------------------- engine

SPEC = dict(page_size=8, max_slots=2, max_len=48, prefix_cache=True,
            prefill_chunk_tokens=8)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_speculative_engine_matches_jax_and_non_speculative(setup, kv_dtype):
    """The speculative engine (K = 4, prefix cache and chunked prefill on)
    emits exactly the JAX speculative engine's tokens and the port's own
    non-speculative engine's; bf16 runs also equal ``generate_static``."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.RandomState(61)
    fam = (rng.randint(1, tcfg.vocab, size=4).tolist() * 5)[:18]
    prompts = [fam + rng.randint(1, tcfg.vocab, size=n).tolist()
               for n in (4, 9, 2)] + _prompts(tcfg.vocab, rng, 2)
    budgets = [10, 7, 12, 9, 6]
    kw = dict(SPEC, kv_dtype=kv_dtype)
    eng, tokens, m = _serve(tcfg, tparams, prompts, budgets,
                            speculate_tokens=4, **kw)
    assert eng.spec_k == 4 and m["spec_tokens"] == 4
    assert m["spec_proposed"] > 0 and m["spec_accepted"] > 0
    assert m["cached_tokens"] > 0 and m["chunked_prefill_steps"] > 0
    assert eng.pool.conservation_ok()
    _, plain, _ = _serve(tcfg, tparams, prompts, budgets, **kw)
    assert tokens == plain
    jeng = JEngine(jcfg, JServeConfig(speculate_tokens=4, **kw), jparams)
    jres, jm = jeng.run_offline(prompts, budgets)
    assert tokens == [r.tokens for r in jres]
    assert (m["spec_proposed"], m["spec_accepted"]) == \
        (jm["spec_proposed"], jm["spec_accepted"])
    if kv_dtype == "bf16":
        with torch.no_grad():
            ref, _ = generate_static(tcfg, tparams, prompts, budgets,
                                     tconfigs.ServeConfig(**SPEC))
        assert tokens == ref


class _Oracle:
    """Planted proposer: drafts the true greedy continuation (learned from
    a baseline run), matched to the request by its prompt."""

    def __init__(self, k, prompts, continuations):
        self.k = k
        self.plan = [(list(p), list(c))
                     for p, c in zip(prompts, continuations)]

    def propose(self, tokens):
        toks = list(tokens)
        for p, cont in self.plan:
            if toks[:len(p)] == p:
                g = len(toks) - len(p)
                return cont[g:g + self.k]
        return []


class _AntiOracle(_Oracle):
    """Drafts guaranteed-wrong tokens: every draft position differs from
    the true continuation, so greedy verify rejects all of them."""

    def __init__(self, k, prompts, continuations, vocab):
        super().__init__(k, prompts, continuations)
        self.vocab = vocab

    def propose(self, tokens):
        return [(t + 1) % self.vocab for t in super().propose(tokens)]


def test_oracle_accepts_everything_anti_oracle_accepts_nothing(setup):
    _, tcfg, _, tparams = setup
    rng = np.random.RandomState(65)
    prompts = [rng.randint(1, tcfg.vocab, size=int(n)).tolist()
               for n in rng.randint(6, 13, size=3)]
    base = dict(page_size=8, max_slots=2, max_len=32)
    _, conts, _ = _serve(tcfg, tparams, prompts, 8, **base)
    _, tokens, m = _serve(
        tcfg, tparams, prompts, 8, speculate_tokens=3,
        proposer=lambda k: _Oracle(k, prompts, conts), **base)
    assert tokens == conts
    assert m["spec_proposed"] > 0
    assert m["spec_accepted"] == m["spec_proposed"]
    assert m["spec_accept_rate"] == 1.0
    _, tokens, m = _serve(
        tcfg, tparams, prompts, 8, speculate_tokens=3,
        proposer=lambda k: _AntiOracle(k, prompts, conts, tcfg.vocab),
        **base)
    assert tokens == conts
    assert m["spec_proposed"] > 0 and m["spec_accepted"] == 0


def test_full_accept_page_boundary_growth(setup):
    """With the oracle every step emits K + 1 = 4 tokens into 4-token
    pages, so each step's writes cross a page boundary: the scheduler must
    have granted pages for pos .. pos + K before the step."""
    _, tcfg, _, tparams = setup
    rng = np.random.RandomState(66)
    prompts = [rng.randint(1, tcfg.vocab, size=10).tolist()
               for _ in range(2)]
    base = dict(page_size=4, max_slots=2, max_len=32)
    _, conts, _ = _serve(tcfg, tparams, prompts, 12, **base)
    eng, tokens, m = _serve(
        tcfg, tparams, prompts, 12, speculate_tokens=3,
        proposer=lambda k: _Oracle(k, prompts, conts), **base)
    assert tokens == conts
    assert m["spec_accepted"] == m["spec_proposed"] > 0
    assert eng.pool.conservation_ok()


def test_rejected_draft_never_reaches_the_radix_cache(setup):
    """Prompt length 10 with 4-token pages puts the first verify step's
    rejected drafts at positions 11..13, across the boundary at 12.  The
    port writes the pool in place, so those K/V stay in their pages after
    the rejection; later identical prompts restore from the radix cache,
    and their streams equal the uncached baseline only if no published
    page held a rejected draft."""
    _, tcfg, _, tparams = setup
    rng = np.random.RandomState(67)
    fam = rng.randint(1, tcfg.vocab, size=10).tolist()
    prompts = [list(fam) for _ in range(4)]
    base = dict(page_size=4, max_slots=2, max_len=32)
    _, conts, _ = _serve(tcfg, tparams, prompts, 8, **base)
    eng, tokens, m = _serve(
        tcfg, tparams, prompts, 8, speculate_tokens=3, prefix_cache=True,
        proposer=lambda k: _AntiOracle(k, prompts, conts, tcfg.vocab),
        **base)
    assert m["cached_tokens"] > 0          # the cache actually restored
    assert m["spec_proposed"] > 0 and m["spec_accepted"] == 0
    assert tokens == conts
    # only prompt pages were published, and they hold prompt tokens alone
    assert len(eng.radix.cached_pages) == len(fam) // 4


def test_cli_speculative_verify_on_cpu(capsys):
    tokens = tserve.main([
        "--device", "cpu", "--arch", "qwen2-0.5b", "--reduced",
        "--requests", "6", "--mixed", "--prompt-len", "48",
        "--speculate-tokens", "4", "--prefix-cache", "--shared-prefix", "2",
        "--prefill-chunk-tokens", "32", "--verify"])
    out = capsys.readouterr().out
    assert len(tokens) == 6
    assert "speculation: K=4" in out and "verify OK: 6 requests" in out


def test_verify_rows_equal_decode_rows_at_full_width():
    """At qwen2-0.5b's full width (d_model 896, d_ff 4864; 2 layers, a 4096
    vocab) on the CPU, row j of a verify step over 8 slots equals the
    decode step at pos + j bit for bit, all 40 rows: the verify step runs
    its projections, MLP and LM head at the decode step's M = 8, where one
    product of M = 40 rows rounds some rows otherwise than M = 8 does."""
    from repro_torch.models.registry import init_params
    tcfg = tconfigs.reduced(tconfigs.get_arch("qwen2-0.5b"), d_model=896,
                            n_heads=14, n_kv_heads=2, head_dim=64,
                            d_ff=4864, vocab=4096)
    params = init_params(tcfg, 0, "cpu")
    ps, Q, B = 16, 5, 8
    pool = PagedKVPool(tcfg, tconfigs.ServeConfig(page_size=ps, max_slots=B,
                                                  max_len=64))
    rng = np.random.RandomState(11)
    lens = rng.randint(9, 40, size=B).astype(np.int32)
    tables = np.zeros((B, pool.table_width), np.int32)
    T = 48
    toks = np.zeros((B, T), np.int32)
    for b, n in enumerate(lens):
        pages = pool.alloc(pool.pages_for(int(n) + Q))
        tables[b, :len(pages)] = pages
        toks[b, :n] = rng.randint(1, tcfg.vocab, size=n)
    model = build_model(tcfg)
    vt = rng.randint(1, tcfg.vocab, size=(B, Q)).astype(np.int32)
    with torch.no_grad():
        _, kv, _ = model.prefill_paged(
            params, pool.kv, {}, meta_to_device(prefill_meta(
                tcfg, ps, tables, np.arange(B, dtype=np.int32),
                np.zeros(B, np.int32), lens, T), "cpu"),
            torch.from_numpy(toks))
        tv, kv, _ = model.verify_paged(
            params, kv, {}, meta_to_device(verify_meta(
                tcfg, ps, tables, lens, np.full(B, Q, np.int32), Q), "cpu"),
            torch.from_numpy(vt))
        equal = 0
        for j in range(Q):
            dec, kv, _ = model.decode_paged(
                params, kv, {}, meta_to_device(
                    decode_meta(tcfg, ps, tables, lens + j), "cpu"),
                torch.from_numpy(vt[:, j]))
            equal += int((dec == tv[:, j]).all(-1).sum())
    assert equal == B * Q
