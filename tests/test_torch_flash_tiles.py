"""K9's tensor-core arithmetic on the CPU: a model of the Hopper kernel's
order and rounding (``csrc/flash_attention.cu``, the bf16 body at head dim
64 and 128) held to ``attention_plain`` and to the Pallas TPU kernel.

The model, written here and nowhere in the package, computes what the
kernel computes, in its order, for every (request, KV head):

* rows are (token, group head) pairs, token-major, in 64-row tiles; keys
  go in 64-key tiles anchored at key 0; a row tile sweeps the key tiles up
  to its last row's token (causal) or every tile (full), and each row is
  updated only by the tiles of its own row tile;
* scores are fp32 sums of exact bf16 products, each k16 step's 16 products
  summed exactly and added to the fp32 accumulator (the tensor cores' k16
  step), then times the scale (after the dot); keys at or past S and,
  causal, after the row's token score -inf;
* one online-softmax step a tile with the TPU kernel's guards: m_new =
  max(m, tile max), p = exp(s - m_new) (0 while m_new is -inf), alpha =
  exp(m - m_new) (0 while m is -inf), l = l * alpha + sum p, the tile's sum
  taken as the kernel's threads take it (each of a row's 4 threads sums its
  16 columns in order, then (t0 + t1) + (t2 + t3)), acc *= alpha;
* p as two bf16 terms, h1 = bf16(p) and h2 = bf16(p - h1), each times the
  bf16 V tile, k16 steps summed exactly into the fp32 accumulator, h1's
  four steps before h2's;
* out = acc / max(l, 1e-20), one bf16 cast.

Bounds: each output element within one bf16 ulp of the largest |plain| in
its row (one head of one token), never below 2^-14 -- the bound
``chip_smoke.py`` holds the kernel to on the card -- against
``attention_plain`` and against ``repro.kernels.flash_attention``'s Pallas
kernel in interpret mode on the same numpy inputs.  Bit for bit, as the
card checks the kernel: a request alone gives its rows in the batch, and
the causal rows 0..S'-1 of a call at S equal those of a call at S' < S.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch.kernels.flash_attention import attention_plain  # noqa: E402

TILE = 64                  # rows of a row tile, keys of a key tile


from _torch_common import one_thread  # noqa: E402, F401


def _quad_sum(e):
    """[rows, 64] -> [rows]: thread c of a row's quad holds columns 8 j +
    2 c + {0, 1} and sums them in order; then (t0 + t1) + (t2 + t3)."""
    x = e.reshape(-1, 8, 4, 2).permute(0, 2, 1, 3).reshape(-1, 4, 16)
    t = x[:, :, 0].clone()
    for j in range(1, 16):
        t = t + x[:, :, j]
    return (t[:, 0] + t[:, 1]) + (t[:, 2] + t[:, 3])


def _mma(acc, a, b):
    """acc [rows, N] fp32 (None: zeros, overwritten) += a [rows, n] @ b
    [n, N], both exact in bf16: each 16 of the n products summed exactly,
    then one fp32 rounding into the accumulator."""
    for k0 in range(0, a.shape[1], 16):
        t = a[:, k0:k0 + 16].double() @ b[k0:k0 + 16].double()
        acc = t.float() if acc is None else (acc.double() + t).float()
    return acc


def k9_model(q, k, v, *, causal, scale=None):
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = D ** -0.5 if scale is None else scale
    n_all = -(-S // TILE)
    n_rows = S * G
    row = torch.arange(n_rows)
    tok = row // G
    # the key tiles each row's 64-row tile sweeps
    last = torch.clamp((row // TILE + 1) * TILE, max=n_rows) - 1
    n_mine = last // G // TILE + 1 if causal else torch.full_like(row, n_all)
    out = torch.empty_like(q)
    for b in range(B):
        for kh in range(K):
            qr = q[b, :, kh * G:(kh + 1) * G].reshape(n_rows, D)
            m = torch.full((n_rows,), float("-inf"))
            l = torch.zeros(n_rows)
            o = torch.zeros(n_rows, D)
            for i in range(int(n_mine.max())):
                keys = i * TILE + torch.arange(TILE)
                live_key = keys < S
                kt = torch.zeros(TILE, D, dtype=q.dtype)
                vt = torch.zeros(TILE, D, dtype=q.dtype)
                kt[live_key] = k[b, keys[live_key], kh]
                vt[live_key] = v[b, keys[live_key], kh]
                s = _mma(None, qr, kt.T) * scale
                masked = ~live_key[None, :]
                if causal:
                    masked = masked | (keys[None, :] > tok[:, None])
                s = s.masked_fill(masked, float("-inf"))
                m_new = torch.maximum(m, s.amax(-1))
                live = m_new > float("-inf")
                safe = torch.where(live, m_new, torch.zeros(()))
                p = torch.where(live[:, None], torch.exp(s - safe[:, None]),
                                torch.zeros(()))
                alpha = torch.where(m > float("-inf"), torch.exp(m - safe),
                                    torch.zeros(()))
                h1 = p.bfloat16()
                h2 = (p - h1.float()).bfloat16()
                o_new = _mma(_mma(o * alpha[:, None], h1, vt), h2, vt)
                act = n_mine > i
                m = torch.where(act, m_new, m)
                l = torch.where(act, l * alpha + _quad_sum(p), l)
                o = torch.where(act[:, None], o_new, o)
            res = (o / l.clamp_min(1e-20)[:, None]).to(q.dtype)
            out[b, :, kh * G:(kh + 1) * G] = res.reshape(S, G, D)
    return out


def _row_ulps(got, want):
    """Worst |got - want| over one bf16 ulp of the largest |want| in its
    row, never below 2^-14."""
    a = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7).clamp_min(2.0 ** -14)
    return ((got.float() - want.float()).abs() / ulp).max().item()


def _inputs(seed, B, S, K, G, D):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(B, S, n, D).astype(
        np.float32)).bfloat16() for n in (K * G, K, K))


@pytest.mark.parametrize("G,D,causal,S", [
    (1, 64, True, 100), (2, 64, False, 77), (7, 64, True, 130),
    (7, 64, False, 71), (1, 128, False, 65), (2, 128, True, 93),
    (7, 128, True, 150)])
def test_model_matches_plain_within_a_row_ulp(G, D, causal, S):
    """bf16, S not a multiple of the 64-key tiles, 2 requests of 2 KV
    heads."""
    q, k, v = _inputs(G * 1000 + D + S, 2, S, 2, G, D)
    got = k9_model(q, k, v, causal=causal)
    assert torch.isfinite(got.float()).all()
    assert _row_ulps(got, attention_plain(q, k, v, causal=causal)) <= 1.0


@pytest.mark.parametrize("G,D,causal,S,block", [
    (7, 64, True, 120, 40), (2, 128, False, 90, 30), (1, 64, False, 100, 50)])
def test_model_matches_the_pallas_kernel_within_a_row_ulp(G, D, causal, S,
                                                          block):
    """The model and the TPU kernel in interpret mode (``block``-row tiles:
    it asserts S % block == 0) on the same bf16 inputs, one KV head."""
    q, k, v = _inputs(G + D + S, 1, S, 1, G, D)
    pallas = np.asarray(j_flash(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        causal=causal, block_q=block, block_k=block, interpret=True),
        np.float32)
    got = k9_model(q, k, v, causal=causal)
    assert _row_ulps(got, torch.from_numpy(pallas)) <= 1.0


@pytest.mark.parametrize("G,D", [(7, 64), (3, 128)])
def test_model_rows_alone_and_past_s_are_bit_equal(G, D):
    """(a) each of 3 requests alone gives its rows in the batch; (b) the
    causal rows 0..99 of a call at S = 100 equal rows 0..99 at S = 128 on
    the same inputs (the ragged tail, the tiles past a row tile's last
    token, keys zero-filled at S = 100 and real at 128), bit for bit."""
    q, k, v = _inputs(G + D, 3, 128, 2, G, D)
    full = k9_model(q, k, v, causal=True)
    for b in range(3):
        assert torch.equal(k9_model(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                    causal=True), full[b:b + 1])
    cut = k9_model(*(t[:, :100].contiguous() for t in (q, k, v)),
                   causal=True)
    assert torch.equal(cut, full[:, :100])
    assert _row_ulps(full, attention_plain(q, k, v, causal=True)) <= 1.0
