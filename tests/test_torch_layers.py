"""The port's shared layers against ``repro.models.layers``.

Same inputs, drawn with numpy from a seed and rounded once to the working
dtype, go through both packages.  fp32 tolerances cover libm differences
(rsqrt, cos, sin and pow may differ by an ulp between XLA and torch); bf16
tolerances are one bf16 ulp of each element plus, for matmuls, one ulp of
the output's magnitude (the two frameworks sum a bf16 GEMM's fp32 products
in another order before the one rounding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_arch, reduced  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


from _torch_common import one_thread  # noqa: E402, F401


def _pair(a, dtype):
    """The same values in both frameworks: rounded once by jax, carried
    over exactly through fp32."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(np.asarray(a, np.float32), jd)
    t = torch.from_numpy(np.array(j, np.float32)).to(td)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ulp(x):
    """Elementwise bf16 ulp of |x| (8 significant bits)."""
    m = np.maximum(np.abs(x), 1e-30)
    return np.exp2(np.floor(np.log2(m)) - 7)


def _check(j, t, dtype, matmul=False):
    a, b = _np(j), _np(t)
    assert a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-5)
        return
    tol = _ulp(a)
    if matmul:
        tol = tol + _ulp(np.abs(a).max())
    assert np.all(np.abs(a - b) <= tol), float(np.max(np.abs(a - b) - tol))


def _cfgs():
    return reduced(get_arch("qwen2-0.5b")), t_reduced(t_get_arch("qwen2-0.5b"))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm(dtype):
    rng = np.random.RandomState(0)
    jc, tc = _cfgs()
    xj, xt = _pair(rng.randn(3, 5, 128) * 3, dtype)
    sj, st = _pair(1 + 0.1 * rng.randn(128), dtype)
    _check(jl.apply_norm(jc, {"scale": sj}, xj),
           tl.apply_norm(tc, {"scale": st}, xt), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gated_silu_mlp(dtype):
    rng = np.random.RandomState(1)
    jc, tc = _cfgs()
    xj, xt = _pair(rng.randn(2, 4, 128), dtype)
    pj, pt = {}, {}
    for name, shape in (("gate", (128, 256)), ("up", (128, 256)),
                        ("down", (256, 128))):
        pj[name], pt[name] = _pair(rng.randn(*shape) / np.sqrt(shape[0]),
                                   dtype)
    _check(jl.apply_mlp(jc, pj, xj), tl.apply_mlp(tc, pt, xt), dtype,
           matmul=True)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "relu2"])
def test_activations_fp32(act):
    rng = np.random.RandomState(2)
    xj, xt = _pair(rng.randn(64) * 3, "float32")
    _check(jl.act_fn(act)(xj), tl.act_fn(act)(xt), "float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rope(dtype):
    rng = np.random.RandomState(3)
    jc, tc = _cfgs()
    xj, xt = _pair(rng.randn(2, 6, 4, 32), dtype)
    pos = rng.randint(0, 4096, size=(2, 6)).astype(np.int32)
    fj, ft = jl.rope_freqs(jc, 32), tl.rope_freqs(tc, 32)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6)
    _check(jl.apply_rope(xj, jnp.asarray(pos), fj),
           tl.apply_rope(xt, torch.from_numpy(pos), ft), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_embed_and_tied_logits(dtype):
    rng = np.random.RandomState(4)
    jc, tc = _cfgs()
    ej, et = _pair(0.02 * rng.randn(jc.vocab_padded, 128), dtype)
    toks = rng.randint(0, jc.vocab, size=(2, 7)).astype(np.int32)
    hj = jl.embed_tokens({"tok": ej}, jnp.asarray(toks))
    ht = tl.embed_tokens({"tok": et}, torch.from_numpy(toks).long())
    np.testing.assert_array_equal(_np(ht), _np(hj))        # a pure gather
    xj, xt = _pair(rng.randn(2, 128), dtype)
    _check(jl.lm_logits(jc, {"tok": ej}, xj),
           tl.lm_logits(tc, {"tok": et}, xt), dtype, matmul=True)
