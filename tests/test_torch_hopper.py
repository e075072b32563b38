"""The Hopper kernels and the ``hopper`` backend on the card.

Every test here needs an NVIDIA card with ``nvcc`` (the kernels have no CPU
or interpret mode), carries the ``cuda`` marker and skips elsewhere.  The
file imports no jax, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_hopper.py

Bounds: each element of a kernel's output agrees with its plain version
within one bf16 ulp of the largest magnitude in its row (one head of one
token), never below 2^-14.  Both take fp32 sums of the same bf16 operands
in another order; where two sums differ in their last bit a probability can
round to its other bf16 neighbour, moving the row by up to an ulp of its
larger terms, so an element that cancels to near 0 is not held to its own
ulp.  K3 (verify) with one live query per row equals K1 (decode) bit for
bit, bf16 and int8, in ring mode too; K1, K3 and K4 on one window of K/V
in a ring of n pages and in one of n + 1 give equal bits; K1's, K3's and
K4's rows of one request alone equal its rows in the batch.  K5 (MLA decode),
K6 (MLA prefill) and K7 (MLA verify), bf16 and int8, are held to their
plain versions by the same one-ulp rule, at rows across split edges and
of over 1000 keys; K7 with one live query equals K5 bit for bit, and
K5's and K7's rows of one request alone equal its rows in the batch; K6's
stage A gives the plain einsum's bf16 K/V bit for bit
(int8: hi + lo within 2^-16 of the row), and K6's rows are equal bit for
bit however a prompt is chunked and whatever else is in the batch.  K9
(the training forward's causal flash attention) is held to its plain
version by the one-ulp rule in bf16 and within 1e-5 in fp32; in bf16 at
head dim 64 and 128 a request alone gives its rows in the batch, and the
causal rows of a call at S' < S equal those at S, bit for bit;
its backward (torch ops) to autograd through the plain version within
1e-5 relative L2, and a small fp32 qwen2-0.5b's loss and gradients on the
hopper backend to the reference backend's within 1e-5 and 1e-4.  The hopper engine passes the dual gate against the reference
engine (``serving.parity``, max |dlogit| <= 0.25), with and without
speculation and int8 pages, dense, sliding-window and MLA.  The state-slot
engines (no kernel on their path) restore preempted requests into other
slots bit for bit.  K1-K4 in their logit-softcap mode (cap 30, scores at
and past the cap) are held to their capped plain versions by the same
one-ulp rule and apart from the uncapped ones, K3 at one query equal to
K1 bit for bit; a capped small qwen2-0.5b passes the dual gate (its
speculative stream equal to the plain one), and its training forward on
hopper launches K9 no time and equals the reference backend's bit for
bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ServeConfig, get_arch, reduced  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    mla_paged_decode, mla_paged_decode_plain, mla_paged_verify,
    mla_paged_verify_plain, paged_decode, paged_decode_plain, paged_verify,
    paged_verify_plain)
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    MLA_SPLIT_PAGES)
from repro_torch.kernels.ragged_prefill import (  # noqa: E402
    mla_build_kv, mla_build_kv_plain, mla_ragged_prefill,
    mla_ragged_prefill_plain, ragged_prefill, ragged_prefill_plain,
    windowed_prefill, windowed_prefill_plain)
from repro_torch.kernels.rbm_cd import (  # noqa: E402
    gemm_sigmoid, gemm_sigmoid_plain)
from repro_torch.models.attention import (  # noqa: E402
    dequant_int8, gather_pages, quantize_int8)
from repro_torch.models.registry import init_params  # noqa: E402
from repro_torch.serving import Engine, dual_gate, replay_logits  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Hopper kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


def _within_one_ulp(got, want):
    """Every element of ``got`` within one bf16 ulp of the largest |want|
    in its row (the last axis), never below 2^-14."""
    a = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7).clamp_min(2.0 ** -14)
    return bool(((got.float() - want.float()).abs() <= ulp).all().item())


def _pool(rng, lengths, ps, K, D, width, device):
    need = [-(-n // ps) for n in lengths]
    P = sum(need) + 2
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((len(lengths), width), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    k = torch.from_numpy(rng.randn(P, ps, K, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(P, ps, K, D).astype(np.float32))
    return (k.bfloat16().to(device), v.bfloat16().to(device),
            torch.from_numpy(tables).to(device))


# K2's shapes: (G, D, page size); K1 takes pages of up to 16 tokens
K2_CASES = [(7, 64, 16), (2, 32, 16), (3, 128, 16), (1, 64, 8),
            (12, 128, 32), (12, 64, 8), (1, 32, 32)]


def _prefill_matches_plain(rng, k, v, t, G, D, kw, device):
    """K2 on 24-token chunks at starts 270 (mid-page), 0, 0 and 40, and on
    a 1-token chunk at start 0, against its plain version."""
    K = k.shape[2]
    qp = torch.from_numpy(rng.randn(4, 24, K * G, D).astype(np.float32)) \
        .bfloat16().to(device)
    st = torch.tensor([270, 0, 0, 40], dtype=torch.int32, device=device)
    m0 = ragged_prefill.launches
    got = ragged_prefill(qp, k, v, t, st, **kw)
    want = ragged_prefill_plain(qp, k, v, t, st, **kw)
    assert ragged_prefill.launches == m0 + 1
    assert _within_one_ulp(got, want)
    q1, st0 = qp[:1, :1].contiguous(), st[1:2].contiguous()
    assert _within_one_ulp(ragged_prefill(q1, k, v, t[:1], st0, **kw),
                           ragged_prefill_plain(q1, k, v, t[:1], st0, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("G,D,ps", K2_CASES)
def test_kernels_match_plain(cuda, G, D, ps):
    rng = np.random.RandomState(G)
    K = 2
    k, v, t = _pool(rng, [300, 17, 1, 64], ps, K, D, -(-320 // ps), cuda)
    if ps <= 16:
        q = torch.from_numpy(rng.randn(4, K * G, D).astype(np.float32)) \
            .bfloat16().to(cuda)
        pos = torch.tensor([299, 16, 0, 63], dtype=torch.int32, device=cuda)
        n0 = paged_decode.launches
        got = paged_decode(q, k, v, t, pos, scale=D ** -0.5)
        want = paged_decode_plain(q, k, v, t, pos, scale=D ** -0.5)
        assert paged_decode.launches == n0 + 1
        assert _within_one_ulp(got, want)
    _prefill_matches_plain(rng, k, v, t, G, D, dict(scale=D ** -0.5), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("int8", [False, True])
def test_prefill_rows_equal_across_a_chunk_split(cuda, D, int8):
    """A 300-token prompt's rows from K2 as one chunk equal, bit for bit,
    the same rows from chunks [0, 96) and [96, 300) over the same pool:
    a row's result depends only on its q, its keys and its position."""
    rng = np.random.RandomState(D + int8)
    K, G, ps = 2, 7, 16
    k, v, t = _pool(rng, [300], ps, K, D, 20, cuda)
    kw = dict(scale=D ** -0.5)
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = _int8(k, v)
    q = torch.from_numpy(rng.randn(1, 300, K * G, D).astype(np.float32)) \
        .bfloat16().to(cuda)
    at = lambda s: torch.tensor([s], dtype=torch.int32, device=cuda)  # noqa
    one = ragged_prefill(q, k, v, t, at(0), **kw)
    two = torch.cat([ragged_prefill(q[:, :96].contiguous(), k, v, t, at(0),
                                    **kw),
                     ragged_prefill(q[:, 96:].contiguous(), k, v, t, at(96),
                                    **kw)], dim=1)
    assert torch.equal(one, two)
    assert _within_one_ulp(one, ragged_prefill_plain(q, k, v, t, at(0),
                                                     **kw))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 14, 64, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(5, 16, 2, 64, dtype=torch.bfloat16, device=cuda)
    t = torch.zeros(2, 3, dtype=torch.int64, device=cuda)     # not int32
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tables"):
        paged_decode(q, k, k, t, pos, scale=0.125)
    with pytest.raises(ValueError, match="unsupported"):
        paged_decode(q[..., :48].contiguous(), k[..., :48].contiguous(),
                     k[..., :48].contiguous(), t.int(), pos, scale=0.125)


@pytest.mark.cuda
def test_hopper_engine_passes_the_dual_gate(cuda):
    cfg = reduced(get_arch("qwen2-0.5b"), n_heads=14, n_kv_heads=2,
                  head_dim=64, d_model=896)
    params = init_params(cfg, 0, cuda)
    rng = np.random.RandomState(0)
    shared = rng.randint(1, cfg.vocab, size=32).tolist()
    prompts = [shared + rng.randint(1, cfg.vocab, size=n).tolist()
               for n in (8, 90, 40)]
    kw = dict(page_size=16, max_slots=4, max_len=160, prefix_cache=True,
              prefill_chunk_tokens=48)
    with torch.no_grad():
        n0 = paged_decode.launches
        hop = Engine(cfg, ServeConfig(attn_backend="hopper", **kw), params,
                     device=cuda).run_offline(prompts, 8)[0]
        assert paged_decode.launches > n0
        tokens = [r.tokens for r in hop]
        ref = [replay_logits(cfg, ServeConfig(**kw), params, p, tk,
                             attn_backend="reference")
               for p, tk in zip(prompts, tokens)]
        test = [replay_logits(cfg, ServeConfig(**kw), params, p, tk,
                              attn_backend="hopper")
                for p, tk in zip(prompts, tokens)]
    rep = dual_gate(ref, test, tokens, tol=0.25)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def _int8(k, v):
    """(k8, v8, k_scale, v_scale): the pools quantized by the port's
    ``quantize_int8``."""
    (k8, ks), (v8, vs) = quantize_int8(k), quantize_int8(v)
    return k8, v8, ks, vs


def _verify_inputs(rng, Q, G, D, device):
    ps, K = 16, 2
    pos = np.array([299, 16, 0, 60, 47], np.int32)
    n_q = np.array([Q, max(Q - 2, 1), 1, Q, 2 if Q > 1 else 1], np.int32)
    k, v, t = _pool(rng, pos + Q, ps, K, D, 20, device)
    q = torch.from_numpy(rng.randn(len(pos), Q, K * G, D)
                         .astype(np.float32)).bfloat16().to(device)
    return (q, k, v, t, torch.from_numpy(pos).to(device),
            torch.from_numpy(n_q).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("Q,G,D", [(5, 7, 64), (3, 2, 32), (1, 7, 64),
                                   (5, 12, 128)])
@pytest.mark.parametrize("int8", [False, True])
def test_verify_kernel_matches_plain(cuda, Q, G, D, int8):
    rng = np.random.RandomState(Q * 10 + G)
    q, k, v, t, pos, n_q = _verify_inputs(rng, Q, G, D, cuda)
    kw = dict(scale=D ** -0.5)
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = _int8(k, v)
    n0 = paged_verify.launches
    got = paged_verify(q, k, v, t, pos, n_q, **kw)
    want = paged_verify_plain(q, k, v, t, pos, n_q, **kw)
    assert paged_verify.launches == n0 + 1
    assert _within_one_ulp(got, want)
    dead = torch.arange(Q, device=cuda)[None, :] >= n_q[:, None]
    assert (got[dead] == 0).all() and (want[dead] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_verify_with_one_live_query_is_decode_bit_for_bit(cuda, int8):
    rng = np.random.RandomState(5)
    q, k, v, t, pos, _ = _verify_inputs(rng, 5, 7, 64, cuda)
    kw = dict(scale=0.125)
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = _int8(k, v)
    ones = torch.ones_like(pos)
    got = paged_verify(q, k, v, t, pos, ones, **kw)
    dec = paged_decode(q[:, 0].contiguous(), k, v, t, pos, **kw)
    assert torch.equal(got[:, 0], dec)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_rows_alone_equal_rows_in_the_batch(cuda, window, int8):
    """K1 and K3 split a row's keys over blocks (256-key splits of 16
    absolute pages) and merge the partials in split order, so a request's
    rows alone equal its rows in the batch bit for bit; positions 255 and
    256 sit on both sides of a split boundary, 300 and 330 span two
    splits (causal; window 64 over a 6-page ring of 96 slots)."""
    rng = np.random.RandomState(17 + int8 + window)
    ps, K, G, D, Q = 16, 2, 7, 64, 5
    pos = [255, 256, 300 if not window else 330, 17]
    if window:
        k, v, t = _ring_inputs(rng, 4, 6, ps, K, D, cuda)
    else:
        k, v, t = _pool(rng, [p + Q for p in pos], ps, K, D, 24, cuda)
    kw = dict(scale=D ** -0.5, window=window)
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = _int8(k, v)
    q = torch.from_numpy(rng.randn(4, Q, K * G, D).astype(np.float32)) \
        .bfloat16().to(cuda)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    n_q = torch.tensor([1, 5, 3, 2], dtype=torch.int32, device=cuda)
    q1 = q[:, 0].contiguous()
    ver = paged_verify(q, k, v, t, pos_t, n_q, **kw)
    dec = paged_decode(q1, k, v, t, pos_t, **kw)
    assert _within_one_ulp(ver, paged_verify_plain(q, k, v, t, pos_t, n_q,
                                                   **kw))
    assert _within_one_ulp(dec, paged_decode_plain(q1, k, v, t, pos_t, **kw))
    for b in range(4):
        one = slice(b, b + 1)
        assert torch.equal(paged_verify(q[one], k, v, t[one], pos_t[one],
                                        n_q[one], **kw), ver[one])
        assert torch.equal(paged_decode(q1[one], k, v, t[one], pos_t[one],
                                        **kw), dec[one])


@pytest.mark.cuda
@pytest.mark.parametrize("G,D,ps", K2_CASES)
def test_int8_kernels_match_plain(cuda, G, D, ps):
    rng = np.random.RandomState(G + 1)
    K = 2
    k, v, t = _pool(rng, [300, 17, 1, 64], ps, K, D, -(-320 // ps), cuda)
    k8, v8, ks, vs = _int8(k, v)
    kw = dict(scale=D ** -0.5, k_scale=ks, v_scale=vs)
    if ps <= 16:
        q = torch.from_numpy(rng.randn(4, K * G, D).astype(np.float32)) \
            .bfloat16().to(cuda)
        pos = torch.tensor([299, 16, 0, 63], dtype=torch.int32, device=cuda)
        assert _within_one_ulp(paged_decode(q, k8, v8, t, pos, **kw),
                               paged_decode_plain(q, k8, v8, t, pos, **kw))
    _prefill_matches_plain(rng, k8, v8, t, G, D, kw, cuda)


@pytest.mark.cuda
def test_wrappers_refuse_a_wrong_scale_operand(cuda):
    rng = np.random.RandomState(9)
    q, k, v, t, pos, n_q = _verify_inputs(rng, 2, 7, 64, cuda)
    k8, v8, ks, vs = _int8(k, v)
    for bad in (ks.float(), ks[..., :1].contiguous()):
        with pytest.raises(ValueError, match="k_scale|scale pages"):
            paged_verify(q, k8, v8, t, pos, n_q, scale=0.125, k_scale=bad,
                         v_scale=vs)
        with pytest.raises(ValueError, match="k_scale|scale pages"):
            paged_decode(q[:, 0].contiguous(), k8, v8, t, pos, scale=0.125,
                         k_scale=bad, v_scale=vs)
        with pytest.raises(ValueError, match="k_scale|scale pages"):
            ragged_prefill(q, k8, v8, t, pos, scale=0.125, k_scale=bad,
                           v_scale=vs)
    with pytest.raises(ValueError, match="k_pages"):     # bf16 payload
        paged_verify(q, k, v, t, pos, n_q, scale=0.125, k_scale=ks,
                     v_scale=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_speculative_hopper_engine_passes_the_dual_gate(cuda, kv_dtype):
    cfg = reduced(get_arch("qwen2-0.5b"), n_heads=14, n_kv_heads=2,
                  head_dim=64, d_model=896)
    params = init_params(cfg, 0, cuda)
    rng = np.random.RandomState(1)
    motif = rng.randint(1, cfg.vocab, size=6).tolist()
    prompts = [(motif * 8)[:40], rng.randint(1, cfg.vocab, size=30).tolist()]
    kw = dict(page_size=16, max_slots=2, max_len=96, kv_dtype=kv_dtype)
    with torch.no_grad():
        n0, d0 = paged_verify.launches, paged_decode.launches
        eng = Engine(cfg, ServeConfig(attn_backend="hopper",
                                      speculate_tokens=4, **kw), params,
                     device=cuda)
        res, m = eng.run_offline(prompts, 16)
        assert paged_verify.launches > n0 and paged_decode.launches == d0
        assert m["spec_proposed"] > 0
        tokens = [r.tokens for r in res]
        ref = [replay_logits(cfg, ServeConfig(**kw), params, p, tk,
                             attn_backend="reference")
               for p, tk in zip(prompts, tokens)]
        test = [replay_logits(cfg, ServeConfig(**kw), params, p, tk,
                              attn_backend="hopper")
                for p, tk in zip(prompts, tokens)]
    rep = dual_gate(ref, test, tokens, tol=0.25)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def _ring_inputs(rng, B, n_ring, ps, K, D, device):
    """Random pages and B disjoint rings of ``n_ring`` shuffled pages."""
    P = B * n_ring + 1
    tables = (rng.permutation(P - 1) + 1).reshape(B, n_ring).astype(np.int32)
    k = torch.from_numpy(rng.randn(P, ps, K, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(P, ps, K, D).astype(np.float32))
    return (k.bfloat16().to(device), v.bfloat16().to(device),
            torch.from_numpy(tables).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("G,D,slack", [(9, 128, 0), (9, 128, 1), (2, 32, 1),
                                        (12, 128, 1)])
@pytest.mark.parametrize("int8", [False, True])
def test_ring_kernels_match_plain(cuda, G, D, slack, int8):
    """K1 and K3 in ring mode (window 64 over a ring of window_pages(64,
    16) pages, plus a slack page) against their plain versions, and K3
    with one live query per row against K1 bit for bit; at G = 12 K3's
    60 rows go to two blocks."""
    rng = np.random.RandomState(G + D + slack)
    ps, K, window, Q = 16, 4, 64, 5
    n_ring = 5 + slack
    ring = n_ring * ps
    k, v, t = _ring_inputs(rng, 4, n_ring, ps, K, D, cuda)
    kw = dict(scale=D ** -0.5, window=window)
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = _int8(k, v)
    pos = torch.tensor([5, ring - 1, ring + 37, 3 * ring + 100],
                       dtype=torch.int32, device=cuda)
    q = torch.from_numpy(rng.randn(4, K * G, D).astype(np.float32)) \
        .bfloat16().to(cuda)
    n0 = paged_decode.launches
    got = paged_decode(q, k, v, t, pos, **kw)
    assert paged_decode.launches == n0 + 1
    assert _within_one_ulp(got, paged_decode_plain(q, k, v, t, pos, **kw))
    qv = torch.from_numpy(rng.randn(4, Q, K * G, D).astype(np.float32)) \
        .bfloat16().to(cuda)
    n_q = torch.tensor([1, 3, 5, 2], dtype=torch.int32, device=cuda)
    got = paged_verify(qv, k, v, t, pos, n_q, **kw)
    assert _within_one_ulp(got, paged_verify_plain(qv, k, v, t, pos, n_q,
                                                   **kw))
    one = paged_verify(qv, k, v, t, pos, torch.ones_like(n_q), **kw)
    dec = paged_decode(qv[:, 0].contiguous(), k, v, t, pos, **kw)
    assert torch.equal(one[:, 0], dec)


@pytest.mark.cuda
@pytest.mark.parametrize("G,D", [(9, 128), (2, 32), (12, 128)])
@pytest.mark.parametrize("int8", [False, True])
def test_windowed_prefill_kernel_matches_plain(cuda, G, D, int8):
    """K4 against its plain version: chunks at start 0 (empty ring), inside
    the first window, past a ring wrap on a page edge (208) and mid-page
    (333), neither a multiple of 64, and one with padding rows; G = 9 and
    G = 12 (command-r) straddle 64-row tiles; then the last request alone,
    a B = 1 call."""
    rng = np.random.RandomState(G * D + int8)
    ps, K, window, T = 16, 4, 64, 48
    n_ring = 6
    k, v, t = _ring_inputs(rng, 5, n_ring, ps, K, D, cuda)
    kw = dict(scale=D ** -0.5, window=window)
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = _int8(k, v)

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)) \
            .bfloat16().to(cuda)
    q, kn, vn = rand(5, T, K * G, D), rand(5, T, K, D), rand(5, T, K, D)
    st = torch.tensor([0, 32, 208, 400, 333], dtype=torch.int32,
                      device=cuda)
    nl = torch.tensor([T, T, 21, T, T], dtype=torch.int32, device=cuda)
    n0 = windowed_prefill.launches
    got = windowed_prefill(q, kn, vn, k, v, t, st, nl, **kw)
    want = windowed_prefill_plain(q, kn, vn, k, v, t, st, nl, **kw)
    assert windowed_prefill.launches == n0 + 1
    assert _within_one_ulp(got, want)
    assert (got[2, 21:] == 0).all() and (want[2, 21:] == 0).all()
    one = [x[4:] for x in (q, kn, vn, t, st, nl)]
    got = windowed_prefill(*one[:3], k, v, *one[3:], **kw)
    assert _within_one_ulp(got, windowed_prefill_plain(*one[:3], k, v,
                                                       *one[3:], **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_windowed_prefill_rows_alone_equal_rows_in_the_batch(cuda, int8):
    """K4 anchors its ring tiles at absolute pages and its fresh tiles at
    chunk token 0, so a row depends only on its q, its keys and its
    position: each request alone gives its rows in the batch bit for bit
    (G = 9 straddles 64-row tiles; window 64 < T = 80 puts the window's
    edge among the fresh keys; one chunk has padding rows)."""
    rng = np.random.RandomState(29 + int8)
    ps, K, G, D, window, T = 16, 2, 9, 128, 64, 80
    k, v, t = _ring_inputs(rng, 4, 6, ps, K, D, cuda)
    kw = dict(scale=D ** -0.5, window=window)
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = _int8(k, v)

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)) \
            .bfloat16().to(cuda)
    q, kn, vn = rand(4, T, K * G, D), rand(4, T, K, D), rand(4, T, K, D)
    st = torch.tensor([0, 208, 333, 90], dtype=torch.int32, device=cuda)
    nl = torch.tensor([T, 50, T, T], dtype=torch.int32, device=cuda)
    got = windowed_prefill(q, kn, vn, k, v, t, st, nl, **kw)
    assert _within_one_ulp(got, windowed_prefill_plain(q, kn, vn, k, v, t,
                                                       st, nl, **kw))
    for b in range(4):
        one = slice(b, b + 1)
        assert torch.equal(windowed_prefill(q[one], kn[one], vn[one], k, v,
                                            t[one], st[one], nl[one], **kw),
                           got[one])


@pytest.mark.cuda
def test_verify_refuses_more_rows_than_a_block_holds(cuda):
    """K3 splits a (request, KV head)'s rows over blocks by query token, so
    one token's G rows must fit a block: G = 49 > 48 raises, while
    command-r-plus-104b's G = 12 at Q = 5 (60 rows, two blocks) runs."""
    rng = np.random.RandomState(3)
    k, v, t = _ring_inputs(rng, 1, 5, 16, 1, 128, cuda)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    q = torch.zeros(1, 1, 49, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        paged_verify(q, k, v, t, pos, pos + 1, scale=0.1, window=64)
    q = torch.zeros(1, 5, 12, 128, dtype=torch.bfloat16, device=cuda)
    out = paged_verify(q, k, v, t, pos, pos + 5, scale=0.1, window=64)
    assert out.shape == q.shape


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,spec", [("bf16", 0), ("bf16", 4),
                                           ("int8", 0)])
def test_windowed_hopper_engine_passes_the_dual_gate(cuda, kv_dtype, spec):
    """Reduced starcoder2-7b (window 32, head dim 128, G = 9) on the hopper
    backend: K4 for every prefill chunk, K1 or K3 in ring mode for every
    decode step, held to the reference replay by the dual gate."""
    cfg = reduced(get_arch("starcoder2-7b"), n_heads=36, n_kv_heads=4,
                  head_dim=128, d_model=512)
    params = init_params(cfg, 0, cuda)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, cfg.vocab, size=n).tolist()
               for n in (20, 75, 41)]
    kw = dict(page_size=16, max_slots=3, max_len=112, kv_dtype=kv_dtype,
              prefill_chunk_tokens=32, speculate_tokens=spec)
    with torch.no_grad():
        n0 = windowed_prefill.launches
        d0, v0 = paged_decode.launches, paged_verify.launches
        res, _ = Engine(cfg, ServeConfig(attn_backend="hopper", **kw), params,
                        device=cuda).run_offline(prompts, 24)
        assert windowed_prefill.launches > n0
        assert (paged_verify.launches > v0) if spec \
            else (paged_decode.launches > d0)
        tokens = [r.tokens for r in res]
        ref = [replay_logits(cfg, ServeConfig(**kw), params, p, tk,
                             attn_backend="reference")
               for p, tk in zip(prompts, tokens)]
        test = [replay_logits(cfg, ServeConfig(**kw), params, p, tk,
                              attn_backend="hopper")
                for p, tk in zip(prompts, tokens)]
    rep = dual_gate(ref, test, tokens, tol=0.25)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def _k8_inputs(device, M, K, N, transposed, dtype):
    rng = np.random.RandomState(M + K + N)
    x = torch.from_numpy(rng.rand(M, K).astype(np.float32)).to(device, dtype)
    w = torch.from_numpy((0.1 * rng.randn(N, K) if transposed
                          else 0.1 * rng.randn(K, N)).astype(np.float32))
    w = w.to(device, dtype)
    w = w.T if transposed else w
    b = torch.from_numpy(0.1 * rng.randn(N).astype(np.float32)) \
        .to(device, dtype)
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,transposed", [
    (100, 784, 1000, False), (100, 1000, 784, True), (37, 200, 61, False),
    (513, 250, 30, False), (100, 30, 250, True), (1, 30, 10, False),
    (100, 785, 1000, False), (100, 7, 61, True), (60, 20, 30, False),
    (1, 784, 1000, False), (4096, 784, 1000, False),
    (4096, 1000, 784, True), (4096, 784, 30, False),
    (4096, 785, 61, True), (2048, 784, 512, False), (2048, 512, 784, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_sigmoid_kernel_matches_plain(cuda, M, K, N, transposed,
                                           dtype):
    """K8 against its plain version: the paper's layer shapes (the negative
    phase reads a row-major [N, K] weight as the transposed view), ragged
    M, N and K: K not a multiple of 8 (785, 7), K within one 32-wide slice,
    N of 30 and 61, M of 1 (splits as blocks) and 4096 (splits in each
    block), and Fig. 8's CD job at 2048 rows (a cluster of 13 splits a
    tile; W.T over w's TF32 planes).  fp32 within 1e-5 (the two sum K
    products in another order and the sigmoid's slope is at most 1/4);
    bf16 within one bf16 ulp of each row's largest output."""
    x, w, b = _k8_inputs(cuda, M, K, N, transposed, dtype)
    n0 = gemm_sigmoid.launches
    got = gemm_sigmoid(x, w, b)
    want = gemm_sigmoid_plain(x, w, b)
    assert gemm_sigmoid.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (M, N)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert _within_one_ulp(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,transposed", [
    (100, 784, 1000, False), (100, 1000, 784, True),
    (4096, 784, 1000, False), (513, 785, 30, True),
    (2048, 784, 512, False), (2048, 512, 784, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_sigmoid_bits_repeat_and_rows_alone(cuda, M, K, N,
                                                 transposed, dtype):
    """K8 sums in a fixed order without atomics: a second call on the same
    inputs gives the same bits, and a row computed alone (its splits as
    blocks of their own) the bits of its row in the batch (the split plan
    depends on N and K only)."""
    x, w, b = _k8_inputs(cuda, M, K, N, transposed, dtype)
    got = gemm_sigmoid(x, w, b)
    assert torch.equal(got, gemm_sigmoid(x, w, b))
    for r in (0, M // 2, M - 1):
        assert torch.equal(gemm_sigmoid(x[r:r + 1], w, b)[0], got[r])


# ------------------------------------------- ring sums in position order

def _ring_pages(hist, tables, ps, upto):
    """Pages holding, in each row's ring of ``tables`` [B, n] pages, the
    newest ``n * ps`` positions up to ``upto[b]`` of ``hist[b]`` ([B, N,
    K, D], one entry per absolute position) at slot ``a mod (n * ps)``, as
    the engine writes them."""
    B, n = tables.shape
    pages = hist.new_zeros((int(tables.max()) + 1, ps) + hist.shape[2:])
    for b in range(B):
        a = torch.arange(max(0, upto[b] - n * ps + 1), upto[b] + 1,
                         device=hist.device)
        slot = a % (n * ps)
        pages[tables[b, slot // ps].long(), slot % ps] = hist[b, a]
    return pages


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K3", "K4"])
@pytest.mark.parametrize("int8", [False, True])
def test_ring_kernels_equal_across_ring_lengths(cuda, kernel, int8):
    """One window of K/V in a ring of n pages and in one of n + 1 (the
    speculative pool's slack page), at positions past the wrap: K1, K3 and
    K4 sweep a ring's pages in the order of their absolute positions, so
    the outputs are equal bit for bit."""
    rng = np.random.RandomState(7)
    K, G, D, ps, window = 2, 3, 64, 16, 128
    n0 = window // ps + 1
    pos = [200, 145, 177, 300]
    live = [1, 3, 5, 2] if kernel == "K3" else [32, 32, 20, 32]
    B, T, Q = len(pos), 32, 5
    upto = [p - 1 if kernel == "K4" else p + (live[b] - 1 if kernel == "K3"
                                              else 0)
            for b, p in enumerate(pos)]
    g = torch.Generator(device=cuda).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).bfloat16()
    hk, hv = randn(B, max(upto) + 1, K, D), randn(B, max(upto) + 1, K, D)
    q = randn(B, K * G, D) if kernel == "K1" else \
        randn(B, Q, K * G, D) if kernel == "K3" else randn(B, T, K * G, D)
    kn, vn = randn(B, T, K, D), randn(B, T, K, D)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    live_t = torch.tensor(live, dtype=torch.int32, device=cuda)
    outs = []
    for n in (n0, n0 + 1):
        tables = torch.from_numpy((rng.permutation(B * n) + 1).reshape(
            B, n).astype(np.int32)).to(cuda)
        k, v = (_ring_pages(h, tables, ps, upto) for h in (hk, hv))
        kw = dict(scale=D ** -0.5, window=window)
        if int8:
            k, v, kw["k_scale"], kw["v_scale"] = _int8(k, v)
        if kernel == "K1":
            outs.append(paged_decode(q, k, v, tables, pos_t, **kw))
        elif kernel == "K3":
            outs.append(paged_verify(q, k, v, tables, pos_t, live_t, **kw))
        else:
            outs.append(windowed_prefill(q, kn, vn, k, v, tables, pos_t,
                                         live_t, **kw))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


# ----------------------------------------------------- MLA kernels K5, K6

def _latent(rng, lengths, ps, width, device):
    need = [-(-n // ps) for n in lengths]
    P = sum(need) + 2
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((len(lengths), width), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    ckv = torch.from_numpy(rng.randn(P, ps, 512).astype(np.float32))
    kr = torch.from_numpy(rng.randn(P, ps, 64).astype(np.float32))
    return (ckv.bfloat16().to(device), kr.bfloat16().to(device),
            torch.from_numpy(tables).to(device))


def _mla_positions(ps):
    """Decode positions for K5's cases: a page edge, idle rows (0, the
    null table last), a split's last key, the next split's first and
    second (K5/K7 split a row's keys at ``MLA_SPLIT_PAGES`` absolute
    pages), and a row of 1100 keys whose partials the merge folds in
    order.  Returns (positions, lengths, table width)."""
    w = MLA_SPLIT_PAGES * ps
    pos = [300, ps - 1, w - 1, w, w + 1, 1100, 64, 0]
    lengths = [p + 1 for p in pos]
    lengths[-1] = 0                                        # idle row
    return pos, lengths, -(-1101 // ps) + 2


@pytest.mark.cuda
@pytest.mark.parametrize("H,ps", [(16, 16), (128, 16), (8, 8)])
def test_mla_decode_kernel_matches_plain(cuda, H, ps):
    rng = np.random.RandomState(H + ps)
    pos, lengths, width = _mla_positions(ps)
    ckv, kr, t = _latent(rng, lengths, ps, width, cuda)
    B = len(pos)
    q_eff = torch.from_numpy(rng.randn(B, H, 512).astype(np.float32)) \
        .bfloat16().to(cuda)
    q_rope = torch.from_numpy(rng.randn(B, H, 64).astype(np.float32)) \
        .bfloat16().to(cuda)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    n0 = mla_paged_decode.launches
    got = mla_paged_decode(q_eff, q_rope, ckv, kr, t, pos_t, scale=192 ** -0.5)
    want = mla_paged_decode_plain(q_eff, q_rope, ckv, kr, t, pos_t,
                                  scale=192 ** -0.5)
    assert mla_paged_decode.launches == n0 + 1
    assert _within_one_ulp(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("H,T,starts,n_live", [
    (8, 40, (0, 96, 16), (40, 40, 13)),     # padded q block, a cached prefix
    (4, 256, (0, 512), (256, 200)),          # two q tiles, a partial chunk
])
def test_mla_prefill_kernel_matches_plain(cuda, H, T, starts, n_live):
    rng = np.random.RandomState(H + T)
    ckv, kr, t = _latent(rng, [s + n for s, n in zip(starts, n_live)], 16,
                         -(-(max(starts) + T) // 16), cuda)
    B = len(starts)
    q = torch.from_numpy(rng.randn(B, T, H, 192).astype(np.float32)) \
        .bfloat16().to(cuda)
    w = torch.from_numpy((rng.randn(512, H, 256) / np.sqrt(512)).astype(
        np.float32)).bfloat16().to(cuda)
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    n0 = mla_ragged_prefill.launches
    got = mla_ragged_prefill(q, ckv, kr, w, t, st, nope=128)
    want = mla_ragged_prefill_plain(q, ckv, kr, w, t, st, nope=128)
    assert mla_ragged_prefill.launches == n0 + 1
    assert got.shape == want.shape == (B, T, H, 128)
    assert _within_one_ulp(got, want)


@pytest.mark.cuda
def test_hopper_mla_engine_passes_the_dual_gate(cuda):
    """deepseek-v2's MLA widths (a 512-wide latent, 64-wide rope key, 128
    + 64 query and 128 value dims a head) on a small model: the hopper
    engine, through K5 and K6, against the reference replay."""
    cfg = reduced(get_arch("deepseek-v2-236b"), n_heads=8, d_model=256,
                  kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128)
    params = init_params(cfg, 0, cuda)
    rng = np.random.RandomState(0)
    shared = rng.randint(1, cfg.vocab, size=32).tolist()
    prompts = [shared + rng.randint(1, cfg.vocab, size=n).tolist()
               for n in (8, 90, 40)]
    kw = dict(page_size=16, max_slots=4, max_len=160, prefix_cache=True,
              prefill_chunk_tokens=48)
    with torch.no_grad():
        d0, p0 = mla_paged_decode.launches, mla_ragged_prefill.launches
        hop = Engine(cfg, ServeConfig(attn_backend="hopper", **kw), params,
                     device=cuda).run_offline(prompts, 8)[0]
        assert mla_paged_decode.launches > d0
        assert mla_ragged_prefill.launches > p0
        tokens = [r.tokens for r in hop]
        ref = [replay_logits(cfg, ServeConfig(**kw), params, p, tk,
                             attn_backend="reference")
               for p, tk in zip(prompts, tokens)]
        test = [replay_logits(cfg, ServeConfig(**kw), params, p, tk,
                              attn_backend="hopper")
                for p, tk in zip(prompts, tokens)]
    rep = dual_gate(ref, test, tokens, tol=0.25)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def _int8_latent(ckv, kr):
    """(ckv, krope, scale kwargs) of the int8 pool quantized from a bf16
    one by the port's ``quantize_int8``."""
    (c8, cs), (r8, rs) = quantize_int8(ckv), quantize_int8(kr)
    return c8, r8, dict(ckv_scale=cs, krope_scale=rs)


@pytest.mark.cuda
@pytest.mark.parametrize("H,ps", [(16, 16), (128, 16), (8, 8)])
def test_int8_mla_decode_kernel_matches_plain(cuda, H, ps):
    rng = np.random.RandomState(H + ps + 1)
    pos, lengths, width = _mla_positions(ps)
    ckv, kr, t = _latent(rng, lengths, ps, width, cuda)
    c8, r8, kw = _int8_latent(ckv, kr)
    B = len(pos)
    q_eff = torch.from_numpy(rng.randn(B, H, 512).astype(np.float32)) \
        .bfloat16().to(cuda)
    q_rope = torch.from_numpy(rng.randn(B, H, 64).astype(np.float32)) \
        .bfloat16().to(cuda)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    args = (q_eff, q_rope, c8, r8, t, pos_t)
    got = mla_paged_decode(*args, scale=192 ** -0.5, **kw)
    want = mla_paged_decode_plain(*args, scale=192 ** -0.5, **kw)
    assert got.dtype == torch.bfloat16
    assert _within_one_ulp(got, want)
    with pytest.raises(ValueError, match="come together"):
        mla_paged_decode(*args, scale=1.0, ckv_scale=kw["ckv_scale"])
    odd = torch.empty(kw["ckv_scale"].numel() + 1, dtype=torch.bfloat16,
                      device=cuda)[1:].view_as(kw["ckv_scale"])
    with pytest.raises(ValueError, match="4-byte aligned"):
        mla_paged_decode(*args, scale=1.0, ckv_scale=odd,
                         krope_scale=kw["krope_scale"])


def _mla_verify_case(rng, H, Q, cuda):
    """16-token pages; rows whose queries straddle a split's edge (127,
    128), a row of over 1000 keys, ragged live counts, an idle row."""
    pos = [300, 15, 0, 64, 127 - Q // 2, 128, 1020, 0]
    n_q = [Q, 1, 1, max(1, Q - 2), Q, max(1, Q - 1), Q, 1]
    lengths = [p + Q for p in pos]
    lengths[-1] = 0                                        # idle row
    ckv, kr, t = _latent(rng, lengths, 16, 72, cuda)
    B = len(pos)
    q_eff = torch.from_numpy(rng.randn(B, Q, H, 512).astype(np.float32)) \
        .bfloat16().to(cuda)
    q_rope = torch.from_numpy(rng.randn(B, Q, H, 64).astype(np.float32)) \
        .bfloat16().to(cuda)
    return (q_eff, q_rope, ckv, kr, t,
            torch.tensor(pos, dtype=torch.int32, device=cuda),
            torch.tensor(n_q, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("H,Q", [(128, 5), (16, 3), (8, 1)])
def test_mla_verify_kernel_matches_plain(cuda, H, Q, int8):
    rng = np.random.RandomState(H + Q + int8)
    q_eff, q_rope, ckv, kr, t, pos, n_q = _mla_verify_case(rng, H, Q, cuda)
    kw = {}
    if int8:
        ckv, kr, kw = _int8_latent(ckv, kr)
    args = (q_eff, q_rope, ckv, kr, t, pos, n_q)
    n0 = mla_paged_verify.launches
    got = mla_paged_verify(*args, scale=192 ** -0.5, **kw)
    want = mla_paged_verify_plain(*args, scale=192 ** -0.5, **kw)
    assert mla_paged_verify.launches == n0 + 1
    assert _within_one_ulp(got, want)
    dead = torch.arange(Q, device=cuda)[None, :] >= n_q[:, None]
    assert not got[dead].float().abs().sum().item()       # exact zeros


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kernel,H", [("K5", 128), ("K5", 8), ("K7", 128),
                                      ("K7", 16)])
def test_mla_rows_alone_equal_batch_rows(cuda, kernel, H, int8):
    """K5 and K7 split a row's keys at absolute pages and merge them in
    split order, so a request alone gives its rows in the batch bit for
    bit, however many splits the other requests span."""
    rng = np.random.RandomState(70 + H + int8)
    Q = 5 if kernel == "K7" else 1
    q_eff, q_rope, ckv, kr, t, pos, n_q = _mla_verify_case(rng, H, Q, cuda)
    kw = {}
    if int8:
        ckv, kr, kw = _int8_latent(ckv, kr)

    def call(s):
        if kernel == "K5":
            return mla_paged_decode(q_eff[s, 0].contiguous(),
                                    q_rope[s, 0].contiguous(), ckv, kr,
                                    t[s], pos[s], scale=0.07, **kw)
        return mla_paged_verify(q_eff[s], q_rope[s], ckv, kr, t[s], pos[s],
                                n_q[s], scale=0.07, **kw)
    full = call(slice(None))
    for b in range(q_eff.shape[0]):
        assert torch.equal(call(slice(b, b + 1)), full[b:b + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_mla_verify_with_one_live_query_is_decode_bit_for_bit(cuda, int8):
    rng = np.random.RandomState(90 + int8)
    q_eff, q_rope, ckv, kr, t, pos, _ = _mla_verify_case(rng, 128, 5, cuda)
    kw = {}
    if int8:
        ckv, kr, kw = _int8_latent(ckv, kr)
    one = mla_paged_verify(q_eff, q_rope, ckv, kr, t, pos,
                           torch.ones_like(pos), scale=0.07, **kw)[:, 0]
    dec = mla_paged_decode(q_eff[:, 0].contiguous(),
                           q_rope[:, 0].contiguous(), ckv, kr, t, pos,
                           scale=0.07, **kw)
    assert torch.equal(one, dec)


@pytest.mark.cuda
@pytest.mark.parametrize("H,T,starts,n_live", [
    (8, 40, (0, 96, 16), (40, 40, 13)),     # padded q block, a cached prefix
    (4, 256, (0, 512), (256, 200)),          # two q tiles, a partial chunk
])
def test_int8_mla_prefill_kernel_matches_plain(cuda, H, T, starts, n_live):
    rng = np.random.RandomState(H + T + 1)
    ckv, kr, t = _latent(rng, [s + n for s, n in zip(starts, n_live)], 16,
                         -(-(max(starts) + T) // 16), cuda)
    c8, r8, kw = _int8_latent(ckv, kr)
    B = len(starts)
    q = torch.from_numpy(rng.randn(B, T, H, 192).astype(np.float32)) \
        .bfloat16().to(cuda)
    w = torch.from_numpy((rng.randn(512, H, 256) / np.sqrt(512)).astype(
        np.float32)).bfloat16().to(cuda)
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    n0 = mla_ragged_prefill.launches
    got = mla_ragged_prefill(q, c8, r8, w, t, st, nope=128, **kw)
    want = mla_ragged_prefill_plain(q, c8, r8, w, t, st, nope=128, **kw)
    assert mla_ragged_prefill.launches == n0 + 1
    assert got.shape == want.shape == (B, T, H, 128)
    assert _within_one_ulp(got, want)


def _mla_prefill_case(rng, H, T, starts, n_live, int8, cuda):
    """(q, ckv, krope, wkv_b, tables, start), scale kwargs: latent pages
    for chunks at ``starts`` with ``n_live`` real tokens (table entries
    past them on the null page), int8 quantized from the same values."""
    ckv, kr, t = _latent(rng, [s + n for s, n in zip(starts, n_live)], 16,
                         -(-(max(starts) + T) // 16), cuda)
    kw = {}
    if int8:
        ckv, kr, kw = _int8_latent(ckv, kr)
    q = torch.from_numpy(rng.randn(len(starts), T, H, 192).astype(
        np.float32)).bfloat16().to(cuda)
    w = torch.from_numpy((rng.randn(512, H, 256) / np.sqrt(512)).astype(
        np.float32)).bfloat16().to(cuda)
    return (q, ckv, kr, w, t,
            torch.tensor(starts, dtype=torch.int32, device=cuda)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("H,T,starts", [(8, 40, (0, 96, 16)),
                                        (128, 256, (0, 1792))])
def test_mla_build_kv_matches_the_plain_einsum(cuda, H, T, starts, int8):
    """K6's stage A on the card: bf16 K/V bit-equal to the plain einsum's
    (fp64 sums, one rounding to fp32, then to bf16) over every built key;
    int8 hi + lo within 2^-16 of each row's largest |x| of the fp32 einsum
    x (hi + lo keeps 16 bits of the kernel's own fp32 x, so they are within
    2^-17 |x| of it); one launch counted."""
    rng = np.random.RandomState(H + T + int8)
    (q, ckv, kr, w, t, st), kw = _mla_prefill_case(
        rng, H, T, starts, [T] * len(starts), int8, cuda)
    cs = kw.get("ckv_scale")
    n0 = mla_build_kv.launches
    got = mla_build_kv(ckv, w, t, st, T, nope=128, ckv_scale=cs)
    want = mla_build_kv_plain(ckv, w, t, st, T, ckv_scale=cs)
    assert mla_build_kv.launches == n0 + 1
    assert got.shape == want.shape
    if int8:
        x = torch.einsum("bsl,lhe->bhse", dequant_int8(
            gather_pages(ckv, t), gather_pages(cs, t)), w.float())
    for b, start in enumerate(starts):
        n = min((start + T - 1) // 16 + 1, t.shape[1]) * 16
        g, p = got[b, :, :n], want[b, :, :n]
        if int8:
            y = x[b, :, :n]
            bound = 2.0 ** -16 * y.abs().amax(-1, keepdim=True)
            assert ((g[..., :256].float() + g[..., 256:].float() - y).abs()
                    <= bound).all()
        else:
            assert torch.equal(g, p)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_mla_prefill_rows_alone_equal_rows_in_the_batch(cuda, int8):
    """K6's rows of each request prefilled alone equal its rows in the
    batch, bit for bit."""
    rng = np.random.RandomState(70 + int8)
    args, kw = _mla_prefill_case(rng, 8, 100, (0, 96, 37), (100, 100, 13),
                                 int8, cuda)
    q, ckv, kr, w, t, st = args
    got = mla_ragged_prefill(*args, nope=128, **kw)
    assert _within_one_ulp(got, mla_ragged_prefill_plain(*args, nope=128,
                                                         **kw))
    for b in range(q.shape[0]):
        assert torch.equal(mla_ragged_prefill(
            q[b:b + 1], ckv, kr, w, t[b:b + 1], st[b:b + 1], nope=128, **kw),
            got[b:b + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_mla_prefill_rows_equal_across_a_chunk_split(cuda, int8):
    """A 300-token prompt at start 0 prefilled as one chunk and as chunks
    [0, 52), [52, 200) and [200, 300) over the same post-write pages: K6
    gives the same rows, bit for bit."""
    rng = np.random.RandomState(80 + int8)
    (q, ckv, kr, w, t, _), kw = _mla_prefill_case(rng, 16, 300, (0,),
                                                  (300,), int8, cuda)

    def run(lo, hi):
        return mla_ragged_prefill(
            q[:, lo:hi].contiguous(), ckv, kr, w, t,
            torch.tensor([lo], dtype=torch.int32, device=cuda), nope=128,
            **kw)

    one = run(0, 300)
    assert torch.equal(one, torch.cat([run(0, 52), run(52, 200),
                                       run(200, 300)], 1))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,spec", [("bf16", 4), ("int8", 0),
                                           ("int8", 4)])
def test_speculative_and_int8_hopper_mla_engine_pass_the_dual_gate(
        cuda, kv_dtype, spec):
    """The small deepseek-v2 of ``test_hopper_mla_engine_passes_the_dual_
    gate`` served with K = 4 n-gram speculation (K7 for every verify step,
    K5 never) and/or int8 latent pages, against the reference replay of
    its pool dtype."""
    cfg = reduced(get_arch("deepseek-v2-236b"), n_heads=8, d_model=256,
                  kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128)
    params = init_params(cfg, 0, cuda)
    rng = np.random.RandomState(0)
    shared = rng.randint(1, cfg.vocab, size=32).tolist()
    motif = rng.randint(1, cfg.vocab, size=4).tolist()
    prompts = [shared + rng.randint(1, cfg.vocab, size=n).tolist()
               for n in (8, 90)] + [(motif * 12)[:40]]
    kw = dict(page_size=16, max_slots=4, max_len=160, prefix_cache=True,
              prefill_chunk_tokens=48)
    scfg = ServeConfig(attn_backend="hopper", kv_dtype=kv_dtype,
                       speculate_tokens=spec, **kw)
    with torch.no_grad():
        mla_paged_decode.launches = mla_paged_verify.launches = 0
        hop, m = Engine(cfg, scfg, params, device=cuda).run_offline(
            prompts, 8)
        steps = m["decode_steps"] * cfg.n_layers
        if spec:
            assert mla_paged_verify.launches == steps > 0
            assert mla_paged_decode.launches == 0
        else:
            assert mla_paged_decode.launches == steps > 0
        tokens = [r.tokens for r in hop]
        ref = [replay_logits(cfg, ServeConfig(**kw), params, p, tk,
                             attn_backend="reference", kv_dtype=kv_dtype)
               for p, tk in zip(prompts, tokens)]
        test = [replay_logits(cfg, ServeConfig(**kw), params, p, tk,
                              attn_backend="hopper", kv_dtype=kv_dtype)
                for p, tk in zip(prompts, tokens)]
    rep = dual_gate(ref, test, tokens, tol=0.25)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


# ------------------------------------------------------- K9 (training)

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,G,D,S", [
    ("bfloat16", True, 7, 64, 1000), ("bfloat16", False, 3, 128, 333),
    ("float32", True, 1, 32, 200), ("float32", False, 6, 64, 129),
    ("bfloat16", True, 3, 128, 777)])
def test_flash_kernel_matches_plain(cuda, dtype, causal, G, D, S):
    """K9 against its plain version (one fp32 softmax over every key): bf16
    within one bf16 ulp of the row's max, fp32 within 1e-5; S is never a
    multiple of the kernel's 64-row tiles, so the masked tail runs."""
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    gen = torch.Generator(device="cuda").manual_seed(S)
    K = 2
    q = torch.randn((2, S, K * G, D), generator=gen, device=cuda)
    k = torch.randn((2, S, K, D), generator=gen, device=cuda)
    v = torch.randn((2, S, K, D), generator=gen, device=cuda)
    q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    want = attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert got.dtype == q.dtype and torch.isfinite(got.float()).all()
    if dtype == "float32":
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert _within_one_ulp(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("G,D", [(7, 64), (3, 128)])
def test_flash_rows_alone_and_past_s_are_bit_equal(cuda, G, D):
    """K9's tensor-core body (bf16, head dim 64 and 128), bit for bit: each
    of 4 requests alone gives its rows in the batch, causal and full; and
    the causal rows 0..256 of a call at S = 257 equal rows 0..256 at S =
    320 on the same inputs (keys past 257 zero-filled in one call, real
    and masked in the other; the tiles past a row tile's last token
    skipped)."""
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(G * D)
    B, S, K = 4, 320, 2
    q, k, v = (torch.randn((B, S, n, D), generator=gen,
                           device=cuda).bfloat16() for n in (K * G, K, K))
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal)
        for b in range(B):
            assert torch.equal(flash_attention(
                q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal),
                got[b:b + 1]), (causal, b)
    cut = flash_attention(*(t[:, :257].contiguous() for t in (q, k, v)),
                          causal=True)
    assert torch.equal(cut, flash_attention(q, k, v, causal=True)[:, :257])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradients_match_autograd_of_plain(cuda, causal):
    """``flash_attention_train``'s backward (torch ops by query block, no
    second launch of K9) against autograd through the plain version, fp32:
    within 1e-5 relative L2 (fp32 sums in another order)."""
    from repro_torch.kernels.flash_attention import (
        attention_plain, flash_attention, flash_attention_train)
    gen = torch.Generator(device="cuda").manual_seed(5)
    S, K, G, D = 300, 2, 7, 64
    q = torch.randn((2, S, K * G, D), generator=gen, device=cuda)
    k = torch.randn((2, S, K, D), generator=gen, device=cuda)
    v = torch.randn((2, S, K, D), generator=gen, device=cuda)
    do = torch.randn((2, S, K * G, D), generator=gen, device=cuda)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = flash_attention.launches
    o = flash_attention_train(*qkv, causal=causal, q_block=128)
    got = torch.autograd.grad((o * do).sum(), qkv)
    assert flash_attention.launches == n0 + 1
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        (attention_plain(*qkv, causal=causal) * do).sum(), qkv)
    for name, g, w in zip("qkv", got, want):
        rel = ((g - w).norm() / w.norm()).item()
        assert rel <= 1e-5, (name, rel)


@pytest.mark.cuda
def test_hopper_training_step_matches_reference(cuda):
    """A small qwen2-0.5b (fp32 parameters) on the hopper backend (K9 once a
    layer in the forward) and on the reference backend (the chunked
    attention, fp32 here): the loss within 1e-5 and every gradient within
    1e-4 relative L2 (the same fp32 math, summed in another order); a
    ``make_train_step`` step on hopper launches K9 once a layer."""
    from repro_torch.core.mapreduce import value_and_grad
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import OptConfig, init_opt_state
    cfg = reduced(get_arch("qwen2-0.5b"))
    params = tree_map(lambda t: t.float(), init_params(cfg, 0, cuda))
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (4, 100), device=cuda,
        generator=torch.Generator(device="cuda").manual_seed(0))}
    (hl, _, hg), (rl, _, rg) = (
        value_and_grad(build_model(cfg, b).loss, params, batch)
        for b in ("hopper", "reference"))
    assert abs(hl.item() - rl.item()) <= 1e-5
    for (p, a), (_, b) in zip(tree_leaves(hg), tree_leaves(rg)):
        assert ((a - b).norm() / b.norm().clamp_min(1e-30)).item() <= 1e-4, p
    ocfg = OptConfig(lr=1e-3)
    n0 = flash_attention.launches
    make_train_step(cfg, ocfg, attn_backend="hopper")(
        params, init_opt_state(params, ocfg), batch)
    assert flash_attention.launches - n0 == cfg.n_layers


def _frontend_engine(cuda, **kw):
    cfg = reduced(get_arch("qwen2-0.5b"), n_heads=14, n_kv_heads=2,
                  head_dim=64, d_model=896)
    params = init_params(cfg, 0, cuda)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab, size=n).tolist()
               for n in (8, 40, 23, 61)]
    scfg = ServeConfig(attn_backend="hopper", page_size=16, max_slots=4,
                       max_len=96, **kw)
    return cfg, params, prompts, scfg


@pytest.mark.cuda
def test_pump_equals_step_bit_for_bit(cuda):
    """``Engine.pump()`` (step N+1's plan staged, its upload queued from
    page-locked buffers, while step N's kernels run) gives the tokens of
    ``step()`` bit for bit on the hopper backend, with staged plans used
    and no staging call waiting for the stream."""
    cfg, params, prompts, scfg = _frontend_engine(cuda)
    with torch.no_grad():
        sync = Engine(cfg, scfg, params, device=cuda).run_offline(
            prompts, 24)[0]
        eng = Engine(cfg, scfg, params, device=cuda)
        stage = eng._stage_next

        def strict(pending):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return stage(pending)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        eng._stage_next = strict
        over = eng.run_offline(prompts, 24, overlap=True)[0]
    assert [r.tokens for r in over] == [r.tokens for r in sync]
    staged, used, dropped = (eng.metrics.value(f"engine.overlap_{k}")
                             for k in ("staged", "used", "dropped"))
    assert staged > 0 and used > 0 and used + dropped == staged


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_poisoned_page_flips_only_its_own_row(cuda, kv_dtype):
    """A NaN poison of one slot's newest page (its K/V, or for int8 pages
    its bf16 scales) reaches that row's logits through K1 and K1-int8 —
    its finite flag comes back False — and no other row's."""
    from repro_torch.kernels.paged_attention import paged_decode
    cfg, params, prompts, scfg = _frontend_engine(cuda, kv_dtype=kv_dtype)
    with torch.no_grad():
        eng = Engine(cfg, scfg, params, device=cuda)
        for p in prompts:
            eng.add_request(p, 8)
        while eng.sched.queue or len(eng.sched.decode_ready()) < 4:
            assert eng.step()
        eng.poison_slot(2)
        n0 = paged_decode.launches
        pending = eng._dispatch_next()
        assert pending.kind == "decode"
        ok = pending.out_dev[1].cpu().tolist()
        assert paged_decode.launches - n0 == cfg.n_layers
        eng._finish_step(pending)
    assert ok == [True, True, False, True]
    assert eng.sched.slots[2] is None
    assert eng.metrics.value("engine.quarantined") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mamba2-780m", "recurrentgemma-2b"])
def test_state_slot_engine_checkpoint_restore_on_the_card(cuda, name):
    """Reduced mamba2-780m and recurrentgemma-2b (window 32, prompts past
    it) served on the hopper backend, whose path runs no kernel: every
    token is the single-request replay's greedy token wherever that
    replay's top-two margin exceeds 0.5 (twice the dual gate's 0.25); the
    requests of slots 0 and 1 preempted mid-decode and restored into each
    other's slots give the un-preempted streams bit for bit (decode runs
    at the fixed [max_slots] shape); every slot is released."""
    cfg = reduced(get_arch(name))
    scfg = ServeConfig(page_size=8, max_slots=3, max_len=80,
                       attn_backend="hopper")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=n).tolist()
               for n in (5, 40, 13, 27)]
    with torch.no_grad():
        params = init_params(cfg, 0, cuda)
        base = [r.tokens for r in Engine(cfg, scfg, params, device=cuda)
                .run_offline(prompts, 12)[0]]
        eng = Engine(cfg, scfg, params, device=cuda)
        for p in prompts:
            eng.add_request(p, 12)
        moved = {}
        while eng.step():
            live = eng.sched.slots[:2]
            if not moved and all(s is not None and len(s.req.generated) >= 3
                                 for s in live):
                for i in (0, 1):
                    moved[eng.sched.slots[i].req.rid] = i
                    eng.sched.preempt(i)
            for i, slot in enumerate(eng.sched.slots):
                assert slot is None or moved.get(slot.req.rid) != i
        got = [r.tokens for r in sorted(eng.collect(), key=lambda r: r.rid)]
        replays = [replay_logits(cfg, scfg, params, p, t)
                   for p, t in zip(prompts, base)]
    assert len(moved) == 2 and eng.metrics.value("engine.state_restores") == 2
    assert got == base
    assert eng.states.num_claimed == 0 and eng.pool.conservation_ok()
    for r, t in zip(replays, base):
        top2 = np.sort(r, axis=-1)[:, -2:]
        high = top2[:, 1] - top2[:, 0] > 2 * 0.25
        assert (r.argmax(-1) == np.asarray(t))[high].all()


@pytest.mark.cuda
@pytest.mark.parametrize("K,G,D", [(16, 1, 64), (8, 7, 128)])
@pytest.mark.parametrize("int8", [False, True])
def test_frontend_family_kernel_shapes_match_plain(cuda, K, G, D, int8):
    """The shapes the enc-dec and vlm families give K1, K2 and K3:
    seamless-m4t's 16 KV heads of 64 with one query head each (G = 1: one
    live row in K1's 16-row block, 64-row K2 tiles of 64 tokens of one
    head) and llava's 8 KV x 7 query heads of 128; K2 on chunks of 24 and
    of 100 tokens (neither a multiple of 64), K3 at Q = 5."""
    rng = np.random.RandomState(K + G + int8)
    ps = 16
    k, v, t = _pool(rng, [300, 17, 1, 164], ps, K, D, 20, cuda)
    kw = dict(scale=D ** -0.5)
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = _int8(k, v)
    q = torch.from_numpy(rng.randn(4, K * G, D).astype(np.float32)) \
        .bfloat16().to(cuda)
    pos = torch.tensor([299, 16, 0, 163], dtype=torch.int32, device=cuda)
    assert _within_one_ulp(paged_decode(q, k, v, t, pos, **kw),
                           paged_decode_plain(q, k, v, t, pos, **kw))
    _prefill_matches_plain(rng, k, v, t, G, D, kw, cuda)
    qp = torch.from_numpy(rng.randn(2, 100, K * G, D).astype(np.float32)) \
        .bfloat16().to(cuda)
    st = torch.tensor([200, 64], dtype=torch.int32, device=cuda)
    tt = t[[0, 3]].contiguous()
    assert _within_one_ulp(ragged_prefill(qp, k, v, tt, st, **kw),
                           ragged_prefill_plain(qp, k, v, tt, st, **kw))
    Q = 5
    qv = torch.from_numpy(rng.randn(4, Q, K * G, D).astype(np.float32)) \
        .bfloat16().to(cuda)
    pv = torch.tensor([290, 10, 0, 150], dtype=torch.int32, device=cuda)
    n_q = torch.tensor([5, 3, 1, 4], dtype=torch.int32, device=cuda)
    assert _within_one_ulp(paged_verify(qv, k, v, t, pv, n_q, **kw),
                           paged_verify_plain(qv, k, v, t, pv, n_q, **kw))


@pytest.mark.cuda
def test_flash_full_mode_at_the_encoder_heads(cuda):
    """K9 in its full (non-causal) mode at seamless-m4t's encoder heads (16
    query = 16 KV heads of 64), S = 1000 (a masked key tail), within one
    bf16 ulp of the row's max of its plain version."""
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k, v = (torch.randn((2, 1000, 16, 64), generator=gen,
                           device=cuda).bfloat16() for _ in range(3))
    assert _within_one_ulp(flash_attention(q, k, v, causal=False),
                           attention_plain(q, k, v, causal=False))


def _frontend_arch(name):
    """Reduced seamless-m4t at G = 1 with heads of 64, or reduced llava at
    G = 7 with heads of 128: the full-width models' kernel shapes."""
    if name == "seamless-m4t-large-v2":
        return reduced(get_arch(name), d_model=256, n_heads=4, n_kv_heads=4,
                       frontend_dim=256)
    return reduced(get_arch(name), d_model=512, n_heads=14, n_kv_heads=2,
                   head_dim=128)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kv_dtype", [
    ("seamless-m4t-large-v2", "bf16"), ("seamless-m4t-large-v2", "int8"),
    ("llava-next-34b", "bf16")])
def test_frontend_family_engines_pass_the_dual_gate(cuda, name, kv_dtype):
    """The enc-dec (frames encoded through K9's full mode, continuation
    chunks reading the pinned cross K/V) and vlm (an image prefix through
    K2) engines on the hopper backend: every request's tokens replayed on
    hopper and on reference (the same pool dtype, the request's frontend
    input) pass the dual gate; for llava the n-gram speculative stream
    equals the plain one."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serving.engine import _synthetic_frontend
    cfg = _frontend_arch(name)
    kw = dict(page_size=16, max_slots=4, max_len=128, kv_dtype=kv_dtype,
              prefill_chunk_tokens=32)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab, size=n).tolist()
               for n in (5, 90, 40, 17)]
    with torch.no_grad():
        params = init_params(cfg, 0, cuda)
        n9 = flash_attention.launches
        eng = Engine(cfg, ServeConfig(attn_backend="hopper", **kw), params,
                     device=cuda)
        tokens = [r.tokens for r in eng.run_offline(prompts, 8)[0]]
        m = eng.metrics
        if cfg.enc_dec:
            first = m.value("engine.prefill_steps") \
                - m.value("engine.chunked_prefill_steps")
            assert m.value("engine.chunked_prefill_steps") > 0
            assert flash_attention.launches - n9 == first * cfg.n_enc_layers
        else:
            assert m.value("engine.chunked_prefill_steps") == 0
            spec = Engine(cfg, ServeConfig(attn_backend="hopper",
                                           speculate_tokens=4, **kw),
                          params, device=cuda).run_offline(prompts, 8)[0]
            assert [r.tokens for r in spec] == tokens
        scfg = ServeConfig(**kw)
        fronts = [_synthetic_frontend(cfg, scfg, 0, i)
                  for i in range(len(prompts))]
        ref, test = ([replay_logits(cfg, scfg, params, p, t,
                                    attn_backend=b, frontend=f)
                      for p, t, f in zip(prompts, tokens, fronts)]
                     for b in ("reference", "hopper"))
    rep = dual_gate(ref, test, tokens, tol=0.25)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def _family_batch(cfg, B, S, device, seed=0):
    """Tokens [B, S] and the arch's frontend input (frames [B, S, F] or
    image embeddings [B, n_img, F]), bf16 standard normals."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab, (B, S), device=device,
                                   generator=g)}
    n = S if cfg.enc_dec else cfg.n_image_tokens
    key = "frames" if cfg.enc_dec else "image_embeds"
    out[key] = torch.randn((B, n, cfg.frontend_dim), device=device,
                           generator=g).bfloat16()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [
    ("seamless-m4t-large-v2", "bf16"), ("llava-next-34b", "fp32"),
    ("llava-next-34b", "bf16")])
def test_frontend_family_training_step_matches_reference(cuda, name, dtype):
    """Reduced seamless-m4t (G = 1, heads of 64: K9 full in the encoder,
    causal in the decoder) and llava (G = 7, heads of 128: K9 causal
    behind the image prefix) on the hopper backend against the reference
    backend, one step's loss and gradients: fp32 parameters (K9's FFMA
    body) within 1e-5 and 1e-4 relative L2 a leaf, as the qwen2 test;
    bf16 (its ``wgmma`` body, fp32 p where the chunked core rounds p to
    bf16) within the smoke's 0.01 and 0.1.  seamless runs in bf16 only:
    its encoder casts the frames to bf16, as JAX's does, so its layers
    take bf16 parameters.  The cross-attention's key bias, whose gradient
    is zero in exact arithmetic (q . bk is the same for every key), is
    held below 1e-2 of the query bias's gradient on both backends.  A
    ``make_train_step`` step on hopper launches K9 once an attention
    layer, by mode."""
    from repro_torch.core.mapreduce import value_and_grad
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import OptConfig, init_opt_state
    cfg = _frontend_arch(name)
    params = init_params(cfg, 0, cuda)
    if dtype == "fp32":
        params = tree_map(lambda t: t.float(), params)
    batch = _family_batch(cfg, 2, 100, cuda)
    (hl, _, hg), (rl, _, rg) = (
        value_and_grad(build_model(cfg, b).loss, params, batch)
        for b in ("hopper", "reference"))
    tol_loss, tol_grad = (1e-5, 1e-4) if dtype == "fp32" else (1e-2, 0.1)
    assert abs(hl.item() - rl.item()) <= tol_loss
    hd, rd = dict(tree_leaves(hg)), dict(tree_leaves(rg))
    for p, a in hd.items():
        b = rd[p]
        if p.endswith("cross_attn/bk"):
            for g in (hd, rd):
                bq = g[p[:-2] + "bq"].float().norm()
                assert g[p].float().norm() <= 1e-2 * bq, p
            continue
        rel = ((a.float() - b.float()).norm()
               / b.float().norm().clamp_min(1e-30)).item()
        assert rel <= tol_grad, (p, rel)
    ocfg = OptConfig(lr=1e-3)
    flash_attention.mode_launches.clear()
    _, _, m = make_train_step(cfg, ocfg, attn_backend="hopper")(
        params, init_opt_state(params, ocfg), batch)
    assert np.isfinite(m["loss"].item())
    want = {("full", 64): cfg.n_enc_layers, ("causal", 64): cfg.n_dec_layers} \
        if cfg.enc_dec else {("causal", 128): cfg.n_layers}
    assert flash_attention.mode_launches == want


@pytest.mark.cuda
def test_full_attend_forward_is_bit_equal_with_and_without_grad(cuda):
    """The hopper backend's ``full_attend`` (the encoder's attend) carries
    a gradient since the training forward needs one; its forward is the
    same K9 launch, so serving under ``no_grad`` keeps its bits."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attn_backend import get_backend
    be = get_backend("hopper")
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v = (torch.randn((2, 300, 16, 64), generator=gen,
                           device=cuda).bfloat16() for _ in range(3))
    with torch.no_grad():
        served = be.full_attend(q, k, v, scale=0.125)
    qg = q.clone().requires_grad_(True)
    trained = be.full_attend(qg, k, v, scale=0.125)
    assert trained.grad_fn is not None
    assert torch.equal(served, trained.detach())
    assert torch.equal(served, flash_attention(q, k, v, causal=False,
                                               scale=0.125))
    (g,) = torch.autograd.grad(trained.float().sum(), qg)
    assert bool(torch.isfinite(g).all())


# ------------------------------------------------------ the logit softcap

CAP = 30.0


@pytest.mark.cuda
@pytest.mark.parametrize("gain", [16.0, 64.0])
@pytest.mark.parametrize("int8", [False, True])
def test_capped_kernels_match_plain(cuda, int8, gain):
    """K1, K2, K3 and K4 in their softcap mode (cap 30; queries times 16,
    the largest scores about the cap, or 64, several times it), causal and
    ring, against their capped plain versions within a row ulp and apart
    from the uncapped ones; K3 at one live query equals K1 bit for bit."""
    rng = np.random.RandomState(int(gain) + int8)
    ps, K, G, D, Q = 16, 2, 7, 64, 5

    def rand(*shape):
        return (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                * gain).bfloat16().to(cuda)

    def held(fn, plain, *args, **kw):
        got = fn(*args, softcap=CAP, **kw)
        want = plain(*args, softcap=CAP, **kw)
        assert _within_one_ulp(got, want)
        assert not _within_one_ulp(plain(*args, **kw), want)

    for window in (0, 64):
        if window:
            k, v, t = _ring_inputs(rng, 4, 5, ps, K, D, cuda)
            pos = [5, 79, 117, 340]
        else:
            k, v, t = _pool(rng, [300, 17, 1, 64], ps, K, D, 20, cuda)
            pos = [299, 16, 0, 63]
        kw = dict(scale=D ** -0.5, window=window)
        if int8:
            k, v, kw["k_scale"], kw["v_scale"] = _int8(k, v)
        pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
        held(paged_decode, paged_decode_plain, rand(4, K * G, D), k, v, t,
             pos, **kw)
        qv = rand(4, Q, K * G, D)
        n_q = torch.tensor([1, 3, 5, 2], dtype=torch.int32, device=cuda)
        held(paged_verify, paged_verify_plain, qv, k, v, t, pos, n_q, **kw)
        one = paged_verify(qv, k, v, t, pos, torch.ones_like(n_q),
                           softcap=CAP, **kw)
        assert torch.equal(one[:, 0], paged_decode(
            qv[:, 0].contiguous(), k, v, t, pos, softcap=CAP, **kw))
    k, v, t = _pool(rng, [300, 17, 1, 64], ps, K, D, 20, cuda)
    kw = dict(scale=D ** -0.5)
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = _int8(k, v)
    st = torch.tensor([270, 0, 0, 40], dtype=torch.int32, device=cuda)
    held(ragged_prefill, ragged_prefill_plain, rand(4, 24, K * G, D), k, v,
         t, st, **kw)
    k, v, t = _ring_inputs(rng, 3, 6, ps, K, D, cuda)
    kw = dict(scale=D ** -0.5, window=64)
    if int8:
        k, v, kw["k_scale"], kw["v_scale"] = _int8(k, v)
    fresh = [torch.from_numpy(rng.randn(3, 48, K, D).astype(np.float32))
             .bfloat16().to(cuda) for _ in range(2)]
    held(windowed_prefill, windowed_prefill_plain, rand(3, 48, K * G, D),
         *fresh, k, v, t,
         torch.tensor([0, 208, 333], dtype=torch.int32, device=cuda),
         torch.tensor([48, 21, 48], dtype=torch.int32, device=cuda), **kw)


def _capped_qwen2(cuda, dtype=None):
    """A small qwen2-0.5b with cap 5 and wq times the gain that gives
    pre-cap scores of std 2: a score's std is d_model * std(wq) * std(wk)
    for unit-RMS inputs, read from the drawn weights (the stacked init
    counts the layer axis in the fan-in)."""
    import dataclasses
    cfg = dataclasses.replace(
        reduced(get_arch("qwen2-0.5b"), n_heads=14, n_kv_heads=2,
                head_dim=64, d_model=896), attn_logit_softcap=5.0)
    params = init_params(cfg, 0, cuda)
    attn = params["blocks"]["attn"]
    attn["wq"].mul_(2.0 / (cfg.d_model * attn["wq"].float().std().item()
                           * attn["wk"].float().std().item()))
    if dtype is not None:
        from repro_torch.models.params import tree_map
        params = tree_map(lambda x: x.to(dtype), params)
    return cfg, params


@pytest.mark.cuda
def test_capped_hopper_engine_passes_the_dual_gate(cuda):
    """The capped model served on hopper (K1, K2 and, with speculation,
    K3 with the cap) against reference replays: the dual gate; the
    speculative stream equal to the plain one; and the cap acting: the
    uncapped model's hopper replay along the same tokens lies further
    from the capped one than the gate's bound."""
    import dataclasses
    cfg, params = _capped_qwen2(cuda)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=n).tolist()
               for n in (8, 90, 40)]
    kw = dict(page_size=16, max_slots=4, max_len=160,
              prefill_chunk_tokens=48)
    with torch.no_grad():
        runs = [[r.tokens for r in Engine(cfg, ServeConfig(
            attn_backend="hopper", speculate_tokens=s, **kw), params,
            device=cuda).run_offline(prompts, 8)[0]] for s in (0, 4)]
        tokens = runs[0]
        ref = [replay_logits(cfg, ServeConfig(**kw), params, p, tk,
                             attn_backend="reference")
               for p, tk in zip(prompts, tokens)]
        test, free = ([replay_logits(c, ServeConfig(**kw), params, p, tk,
                                     attn_backend="hopper")
                       for p, tk in zip(prompts, tokens)]
                      for c in (cfg, dataclasses.replace(
                          cfg, attn_logit_softcap=0.0)))
    assert runs[1] == tokens
    rep = dual_gate(ref, test, tokens, tol=0.25)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}
    moved = max(float(np.abs(a - b).max()) for a, b in zip(test, free))
    assert moved > 0.25, moved


@pytest.mark.cuda
def test_capped_training_takes_the_chunked_core(cuda):
    """K9 has no softcap (nor has the TPU kernel): a capped model's
    training forward on hopper runs the chunked core, launches K9 no time
    and gives the reference backend's loss and gradients bit for bit."""
    from repro_torch.core.mapreduce import value_and_grad
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.registry import build_model
    cfg, params = _capped_qwen2(cuda, torch.float32)
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (2, 64), device=cuda,
        generator=torch.Generator(device="cuda").manual_seed(0))}
    n0 = flash_attention.launches
    (hl, _, hg), (rl, _, rg) = (
        value_and_grad(build_model(cfg, b).loss, params, batch)
        for b in ("hopper", "reference"))
    assert flash_attention.launches == n0
    assert torch.equal(hl, rl)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(hg),
                                                           tree_leaves(rg)))
