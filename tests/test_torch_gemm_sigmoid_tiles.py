"""K8's tensor-core arithmetic on the CPU: a model of the Hopper kernel's
order and rounding (``csrc/gemm_sigmoid.cu``) held to
``gemm_sigmoid_plain`` and to the JAX package's ``gemm_sigmoid_ref``.

The model, written here and nowhere in the package, computes what the
kernel computes, in its order, for fp32 operands:

* each operand split into two TF32 terms as the kernel splits it, hi =
  cvt.rna.tf32.f32(a) and lo = cvt.rna.tf32.f32(a - hi) (round to nearest,
  ties away from zero, on the 13 low bits);
* K cut by ``split_plan(N, K)`` into splits of whole 32-wide slices; a
  split's k8 steps run in order into one fresh fp32 accumulator, each
  step's three terms small first -- w_lo x_hi, w_hi x_lo, then w_hi x_hi
  -- each term's 8 products summed exactly and added to the accumulator
  with one rounding (to nearest even, or toward zero: the tensor cores'
  internal rounding is not documented, so the bound must hold for both);
* the splits' sums added in split order with fp32 adds, the first taken
  as it is; then z = sum + b and 1 / (1 + exp(-z)) in fp32.

Bounds: the model within ``K8_TOL / 4`` of ``gemm_sigmoid_plain`` and of
``gemm_sigmoid_ref`` at every layer of mnist-dbn (784-1000-500-250-30),
both phases at batch 100 (the negative phase through the ``W.T`` view)
and a 512-row slice of layer 0's forward propagation; the same model with
one TF32 term (w_hi x_hi) above ``K8_TOL`` at layer 0, so the check can
fail.  ``K8_TOL`` is the bound ``chip_smoke.py`` holds the kernel to on
the card.  The split helper is held to an independent rounding on edge
bit patterns.  Inputs are drawn from a seed with numpy.
"""
import math
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rbm_cd import gemm_sigmoid_ref  # noqa: E402
from repro_torch.kernels.rbm_cd import gemm_sigmoid_plain  # noqa: E402
from repro_torch.kernels.rbm_cd.ops import (  # noqa: E402
    MAX_SPLITS, SLICE, call_plan, grid_splits, split_plan, workspace)

K8_TOL = 1e-5                  # chip_smoke.py's bound on the card
STACK = (784, 1000, 500, 250, 30)


from _torch_common import one_thread  # noqa: E402, F401


def rna_tf32(a):
    """fp32 -> the TF32 value cvt.rna.tf32.f32 gives, as fp32 (low 13 bits
    zero): add half of the dropped field to the bits, then clear it; a
    carry runs into the exponent.  NaN stays NaN."""
    bits = a.contiguous().view(torch.int32)
    r = (bits + 0x1000) & -0x2000
    return torch.where(torch.isnan(a), a, r.view(torch.float32))


def split_tf32(a):
    hi = rna_tf32(a)
    return hi, rna_tf32(a - hi)


def _round32(v, mode):
    """fp64 -> fp32, to nearest even or toward zero."""
    f = v.float()
    if mode == "rz":
        over = f.double().abs() > v.abs()
        f = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
    return f


def k8_model(x, w, b, *, terms=3, mode="rne"):
    """sigmoid(x @ w + b) as the kernel computes it; x [M, K], w [K, N]
    (any strides), b [N], fp32."""
    K, N = w.shape
    per, splits = split_plan(N, K)
    xh, xl = (t.double() for t in split_tf32(x))
    wh, wl = (t.double() for t in split_tf32(w))
    pairs = ((wl, xh), (wh, xl), (wh, xh)) if terms == 3 else ((wh, xh),)
    tot = None
    for s in range(splits):
        acc = None
        for k0 in range(s * per * SLICE, min(K, (s + 1) * per * SLICE), 8):
            for a, bb in pairs:
                t = bb[:, k0:k0 + 8] @ a[k0:k0 + 8]
                acc = _round32(t if acc is None else acc.double() + t, mode)
        tot = acc if tot is None else tot + acc
    z = tot + b
    return 1 / (1 + torch.exp(-z))


# ------------------------------------------------------- the TF32 split

def _rna_oracle(bits: int) -> int:
    """cvt.rna.tf32.f32 of the fp32 ``bits``, by exact arithmetic: the
    value rounded to 11 significant bits (the subnormal spacing below
    2^-126), ties away from zero."""
    v = struct.unpack("<f", struct.pack("<I", bits))[0]
    if v == 0 or math.isinf(v):
        return bits
    e = max(math.frexp(abs(v))[1] - 1, -126)
    q = 2.0 ** (e - 10)
    r = math.copysign(math.floor(abs(v) / q + 0.5) * q, v)
    if abs(r) >= 2.0 ** 128:
        r = math.copysign(math.inf, v)
    return struct.unpack("<I", struct.pack("<f", r))[0]


EDGE_BITS = [
    0x00000000, 0x80000000,                     # +0, -0
    0x3F800000, 0xBF800000,                     # +-1
    0x3F801000, 0xBF801000,                     # ties: away from zero
    0x3F803000, 0x3F800FFF, 0x3F801001,         # a tie, below, above
    0x3FFFF000, 0xBFFFF000, 0x3FFFEFFF,         # a carry into the exponent
    0x7F7FF000, 0xFF7FF000, 0x7F7FEFFF,         # to infinity, and not
    0x00000001, 0x00000FFF, 0x00001000,         # subnormals: to 0, a tie
    0x00003000, 0x007FF000, 0x807FF000,         # into the least normal
    0x00400000, 0x00800000, 0x00801000,         # least normal, a tie
    0x7F800000, 0xFF800000,                     # infinities
]


def test_rna_tf32_matches_exact_rounding_on_edge_bits():
    """(a) The split helper against exact round-to-nearest-away on edge
    bit patterns and random ones; NaN stays NaN."""
    rng = np.random.RandomState(0)
    bits = EDGE_BITS + [int(v) for v in rng.randint(0, 2 ** 32, 2000,
                                                    dtype=np.uint64)]
    bits = [b for b in bits if (b >> 23) & 0xFF != 0xFF or b & 0x7FFFFF == 0]
    a = torch.from_numpy(np.array(bits, np.uint32).view(np.float32))
    got = rna_tf32(a).view(torch.int32).numpy().view(np.uint32)
    want = np.array([_rna_oracle(b) for b in bits], np.uint32)
    bad = [(hex(b), hex(g), hex(w)) for b, g, w in zip(bits, got, want)
           if g != w]
    assert not bad, bad[:5]
    assert (got & 0x1FFF == 0).all()
    nan = torch.tensor([float("nan")])
    assert torch.isnan(rna_tf32(nan)).all()


def test_split_terms_sum_to_the_value():
    """(b) hi + lo within 2^-22 |a|, both TF32, over normal magnitudes
    from 2^-100 to 2^100."""
    rng = np.random.RandomState(1)
    a = (rng.uniform(1, 2, 20000) * 2.0 ** rng.randint(-100, 100, 20000)
         * rng.choice([-1, 1], 20000)).astype(np.float32)
    a = torch.from_numpy(a)
    hi, lo = split_tf32(a)
    for t in (hi, lo):
        assert (t.view(torch.int32) & 0x1FFF == 0).all()
    err = (a.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * a.double().abs()).all()


# ------------------------------------------------------- the model's sums

def _layer_case(rng, i, phase):
    """Layer i's weights and one phase's input, as chip_smoke.py draws
    them: x uniform (the visible phase's x binary), W 0.1 N(0, 1), biases
    0.1 U(0, 1)."""
    nv, nh = STACK[i], STACK[i + 1]
    w = (0.1 * rng.randn(nv, nh)).astype(np.float32)
    if phase == "hidden":
        return rng.rand(100, nv).astype(np.float32), w, \
            (0.1 * rng.rand(nh)).astype(np.float32), False
    if phase == "visible":
        return (rng.rand(100, nh) < 0.5).astype(np.float32), w, \
            (0.1 * rng.rand(nv)).astype(np.float32), True
    return rng.rand(512, nv).astype(np.float32), w, \
        (0.1 * rng.rand(nh)).astype(np.float32), False


CASES = [(i, p) for i in range(len(STACK) - 1)
         for p in ("hidden", "visible")] + [(0, "forward-prop")]


@pytest.mark.parametrize("mode", ["rne", "rz"])
@pytest.mark.parametrize("layer,phase", CASES)
def test_model_holds_quarter_tolerance(layer, phase, mode):
    """(c) The kernel's order within K8_TOL / 4 of the plain version and
    of the JAX reference, whichever way the tensor cores round."""
    rng = np.random.RandomState(10 * layer + len(phase))
    x, w, b, transposed = _layer_case(rng, layer, phase)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    wt = torch.from_numpy(w).T if transposed else torch.from_numpy(w)
    got = k8_model(xt, wt, bt, mode=mode)
    plain = gemm_sigmoid_plain(xt, wt, bt)
    ref = torch.from_numpy(np.array(gemm_sigmoid_ref(
        jnp.asarray(x), jnp.asarray(wt.numpy()), jnp.asarray(b))))
    assert got.dtype == torch.float32 and got.shape == plain.shape
    assert torch.isfinite(got).all()
    assert (got - plain).abs().max().item() <= K8_TOL / 4
    assert (got - ref).abs().max().item() <= K8_TOL / 4


def test_one_tf32_term_fails_the_tolerance():
    """(d) w_hi x_hi alone moves layer 0's outputs past K8_TOL: the
    check can fail."""
    x, w, b, _ = _layer_case(np.random.RandomState(5), 0, "hidden")
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    err = (k8_model(xt, wt, bt, terms=1)
           - gemm_sigmoid_plain(xt, wt, bt)).abs().max().item()
    assert err > K8_TOL


@pytest.mark.parametrize("layer", [0, 3])
def test_row_alone_equals_its_row_in_the_batch(layer):
    """(e) The split plan depends on N and K only, not on M, so a row
    computed alone sums in its batch's order: bit for bit in the model,
    whether the batch's splits run as blocks of their own or not."""
    x, w, b, _ = _layer_case(np.random.RandomState(7), layer, "forward-prop")
    K, N = w.shape
    assert grid_splits(1, N, K) == split_plan(N, K)[1] > 1
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    batch = k8_model(xt, wt, bt)
    for r in (0, 137, 511):
        assert torch.equal(k8_model(xt[r:r + 1], wt, bt)[0], batch[r])


def test_split_plan_fills_the_card_at_the_cd_shapes():
    """At batch 100 each CD product of layer 0 runs at least 100 blocks
    (N tiles x splits as blocks, a cluster of at most 16 a tile, no
    workspace); the forward-propagation job sums its splits inside each
    block, w's two TF32 planes in the workspace; every split holds whole
    slices, and the splits K."""
    assert MAX_SPLITS <= 16
    for N, K in ((1000, 784), (784, 1000)):
        per, splits = split_plan(N, K)
        assert call_plan(100, N, K) == (per, splits, splits, 0)
        assert -(-N // 64) * splits >= 100
        assert (splits - 1) * per * SLICE < K <= splits * per * SLICE
    assert grid_splits(60000, 1000, 784) == 1
    assert workspace(60000, 1000, 784) == 2 * 1000 * 784
    assert workspace(60000, 1000, 785) == 2 * 1000 * 788
    assert workspace(60000, 30, 250) == 0


# Fig. 8's CD job (``launch/fig8_scaling.py``): RBM 784 x 512 on the whole
# global batch of 2048 rows at world size 1
FIG8 = [("hidden", 2048, 784, 512, False), ("visible", 2048, 512, 784, True)]


def test_split_plan_at_fig8_shapes():
    """The hidden phase's 128 output tiles are fewer than the SMs, but its
    13 splits as blocks would take 1664 blocks, over five waves of the
    card, where the other route takes one: its splits run inside each
    block over w's TF32 planes, as do the visible
    phase's (N 784 through ``W.T``, 208 tiles).  A CD step's 100 rows keep
    their splits as blocks, up to the five waves."""
    assert call_plan(2048, 512, 784) == (2, 13, 1, 2 * 512 * 784)
    assert call_plan(2048, 784, 512) == (2, 8, 1, 2 * 784 * 512)
    assert grid_splits(100, 512, 784) == 13
    assert grid_splits(512, 512, 784) == 13          # 416 blocks
    assert grid_splits(1024, 512, 784) == 1          # 832 blocks
    assert grid_splits(512, 1000, 784) == 9          # 576 blocks
    assert grid_splits(4096, 30, 250) == 8           # 256 blocks
    for _, M, K, N, _ in FIG8:
        per, splits = split_plan(N, K)
        assert splits <= MAX_SPLITS
        assert (splits - 1) * per * SLICE < K <= splits * per * SLICE


@pytest.mark.parametrize("mode", ["rne", "rz"])
@pytest.mark.parametrize("phase,M,K,N,transposed", FIG8,
                         ids=[c[0] for c in FIG8])
def test_model_holds_quarter_tolerance_at_fig8(phase, M, K, N, transposed,
                                              mode):
    """(c) at Fig. 8's shapes, on 256 of the 2048 rows (the split plan
    depends on N and K only): the visible phase's x binary, as the CD
    step's hidden samples are."""
    rng = np.random.RandomState(K + N)
    x = rng.rand(256, K).astype(np.float32)
    if transposed:
        x = (x < 0.5).astype(np.float32)
        wt = torch.from_numpy((0.1 * rng.randn(N, K)).astype(np.float32)).T
    else:
        wt = torch.from_numpy((0.1 * rng.randn(K, N)).astype(np.float32))
    xt = torch.from_numpy(x)
    bt = torch.from_numpy((0.1 * rng.rand(N)).astype(np.float32))
    got = k8_model(xt, wt, bt, mode=mode)
    assert torch.isfinite(got).all()
    assert (got - gemm_sigmoid_plain(xt, wt, bt)).abs().max().item() \
        <= K8_TOL / 4
