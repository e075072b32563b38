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
ulp.  The hopper engine passes the dual gate against the reference
engine (``serving.parity``, max |dlogit| <= 0.25).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ServeConfig, get_arch, reduced  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode, paged_decode_plain)
from repro_torch.kernels.ragged_prefill import (  # noqa: E402
    ragged_prefill, ragged_prefill_plain)
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


@pytest.mark.cuda
@pytest.mark.parametrize("G,D", [(7, 64), (2, 32)])
def test_kernels_match_plain(cuda, G, D):
    rng = np.random.RandomState(G)
    ps, K = 16, 2
    k, v, t = _pool(rng, [300, 17, 1, 64], ps, K, D, 19, cuda)
    q = torch.from_numpy(rng.randn(4, K * G, D).astype(np.float32)) \
        .bfloat16().to(cuda)
    pos = torch.tensor([299, 16, 0, 63], dtype=torch.int32, device=cuda)
    n0 = paged_decode.launches
    got = paged_decode(q, k, v, t, pos, scale=D ** -0.5)
    want = paged_decode_plain(q, k, v, t, pos, scale=D ** -0.5)
    assert paged_decode.launches == n0 + 1
    assert _within_one_ulp(got, want)
    qp = torch.from_numpy(rng.randn(4, 24, K * G, D).astype(np.float32)) \
        .bfloat16().to(cuda)
    st = torch.tensor([270, 0, 0, 40], dtype=torch.int32, device=cuda)
    m0 = ragged_prefill.launches
    got = ragged_prefill(qp, k, v, t, st, scale=D ** -0.5)
    want = ragged_prefill_plain(qp, k, v, t, st, scale=D ** -0.5)
    assert ragged_prefill.launches == m0 + 1
    assert _within_one_ulp(got, want)


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
