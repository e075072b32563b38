"""Kernel K8 and the RBM of the paper's path in the port, on the CPU,
against the JAX package.

1. *K8* — the port's ``gemm_sigmoid_plain`` (the plain version of the
   Hopper kernel, and what the wrapper runs for CPU tensors) against the
   Pallas ``gemm_sigmoid`` in interpret mode and against
   ``rbm_cd/ref.py``, fp32 and bf16, ragged M/N/K, and the negative
   phase's transposed weight (a view in the port).  Tolerance: 1e-5 in
   fp32 (two fp32 sums of the same products in another order, through a
   sigmoid whose slope is at most 1/4) and 2e-2 in bf16 (the output is
   rounded to bf16, whose ulp is 2^-8 near 1: XLA and torch may round a
   value on either side), as ``tests/test_kernels.py`` holds the Pallas
   kernel to its oracle.
2. *RBM* — hidden/visible probabilities (through K8's wrapper) against
   JAX's plain and Pallas probabilities, ``update`` and ``free_energy``
   against JAX on converted parameters, and
   the CD statistics from JAX's own positive-phase sample fed to both
   negative phases (CD-1 draws nothing more): fp32 within 1e-5.
3. *Learning* — the port's CD steps, with its own generator, lower the
   reconstruction error and widen the free-energy gap between data and
   noise (the JAX tests' properties, ``tests/test_rbm_dbn.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import rbm as jrbm  # noqa: E402
from repro.kernels.rbm_cd import gemm_sigmoid as j_gemm_sigmoid  # noqa: E402
from repro.kernels.rbm_cd import gemm_sigmoid_ref  # noqa: E402
from repro_torch.core import rbm  # noqa: E402
from repro_torch.data import dataset  # noqa: E402
from repro_torch.kernels.rbm_cd import (gemm_sigmoid,  # noqa: E402
                                        gemm_sigmoid_plain)
from repro_torch.models.convert import rbm_stack_from_numpy  # noqa: E402

F32_TOL, BF16_TOL = 1e-5, 2e-2

# (M, K, N): the paper's layer-0 CD shape, ragged shapes, the narrow code
GEMM_SHAPES = [(100, 784, 1000), (37, 200, 61), (1, 30, 10), (130, 250, 30)]


from _torch_common import one_thread  # noqa: E402, F401


def _operands(M, K, N, transposed, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(M, K).astype(np.float32)
    w = (0.1 * rng.randn(N, K) if transposed else 0.1 * rng.randn(K, N))
    return x, w.astype(np.float32), (0.1 * rng.randn(N)).astype(np.float32)


@pytest.mark.parametrize("M,K,N", GEMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transposed", [False, True])
def test_gemm_sigmoid_plain_matches_pallas(M, K, N, dtype, transposed):
    x, w, b = _operands(M, K, N, transposed, M + K + N)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    jx, jw, jb = (jnp.asarray(a).astype(jd) for a in (x, w, b))
    jw = jw.T if transposed else jw
    pallas = np.asarray(j_gemm_sigmoid(jx, jw, jb, interpret=True),
                        np.float32)
    ref = np.asarray(gemm_sigmoid_ref(jx, jw, jb), np.float32)
    tx, tw, tb = (torch.from_numpy(a).to(td) for a in (x, w, b))
    tw = tw.T if transposed else tw                     # a view, as K8 reads
    got = gemm_sigmoid_plain(tx, tw, tb)
    assert got.dtype == td and tuple(got.shape) == (M, N)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), pallas, atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=tol)


def test_gemm_sigmoid_wrapper_runs_the_plain_version_on_cpu():
    x, w, b = _operands(33, 40, 20, True, 1)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    n0 = gemm_sigmoid.launches
    torch.testing.assert_close(gemm_sigmoid(tx, tw.T, tb),
                               gemm_sigmoid_plain(tx, tw.T, tb), rtol=0,
                               atol=0)
    assert gemm_sigmoid.launches == n0          # counts kernel launches only


def _jax_and_port_params(n_vis, n_hid, seed):
    rng = np.random.RandomState(seed)
    p = {"W": (0.1 * rng.randn(n_vis, n_hid)).astype(np.float32),
         "bv": (0.1 * rng.randn(n_vis)).astype(np.float32),
         "bh": (0.1 * rng.randn(n_hid)).astype(np.float32)}
    return {k: jnp.asarray(v) for k, v in p.items()}, \
        rbm_stack_from_numpy([p])[0]


@pytest.mark.parametrize("jax_kernel", [False, True])
def test_probabilities_match_jax(jax_kernel):
    """The port's probabilities (K8's wrapper, its plain version here)
    against JAX's plain ones and its Pallas K8 in interpret mode."""
    jp, tp = _jax_and_port_params(784, 100, 0)
    v = np.random.RandomState(1).rand(64, 784).astype(np.float32)
    h = (np.random.RandomState(2).rand(64, 100) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        rbm.hidden_probs(tp, torch.from_numpy(v)).numpy(),
        np.asarray(jrbm.hidden_probs(jp, jnp.asarray(v), jax_kernel)),
        atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(
        rbm.visible_probs(tp, torch.from_numpy(h)).numpy(),
        np.asarray(jrbm.visible_probs(jp, jnp.asarray(h), jax_kernel)),
        atol=F32_TOL, rtol=F32_TOL)


def test_cd_statistics_match_jax_on_the_same_sample():
    """JAX's mapper (``cd_statistics``) draws its positive-phase sample from
    the first half of its split key; the port's negative phase takes that
    same sample (CD-1 draws nothing more), so every statistic is a
    deterministic function of the same inputs."""
    jp, tp = _jax_and_port_params(200, 64, 3)
    v = np.random.RandomState(4).rand(32, 200).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jstats = jrbm.cd_statistics(jp, jnp.asarray(v), key,
                                jrbm.RBMConfig(n_vis=200, n_hid=64))
    k1, _ = jax.random.split(key)
    _, h_sample = jrbm.getposphase(jp, jnp.asarray(v), k1)
    tv = torch.from_numpy(v)
    th_prob = rbm.hidden_probs(tp, tv)
    tv_neg, th_neg = rbm.getnegphase(tp, torch.from_numpy(
        np.array(h_sample)), None)
    tstats = rbm.phase_statistics(tv, th_prob, tv_neg, th_neg)
    assert set(tstats) == set(jstats)
    for k in ("W", "bv", "bh", "err"):
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(jstats[k]),
                                   atol=F32_TOL, rtol=F32_TOL, err_msg=k)


def test_update_and_free_energy_match_jax():
    jp, tp = _jax_and_port_params(100, 30, 7)
    rng = np.random.RandomState(8)
    vel = {k: (0.01 * rng.randn(*np.shape(v))).astype(np.float32)
           for k, v in jp.items()}
    stats = {k: (0.01 * rng.randn(*np.shape(v))).astype(np.float32)
             for k, v in jp.items()}
    cfg = jrbm.RBMConfig(n_vis=100, n_hid=30)
    tcfg = rbm.RBMConfig(n_vis=100, n_hid=30)
    for epoch in (0, 7):                     # both momentum settings
        jnew, jvel = jrbm.update(jp, {k: jnp.asarray(v) for k, v in
                                      vel.items()},
                                 {k: jnp.asarray(v) for k, v in
                                  stats.items()}, cfg, epoch)
        tnew, tvel = rbm.update(tp, {k: torch.from_numpy(v) for k, v in
                                     vel.items()},
                                {k: torch.from_numpy(v) for k, v in
                                 stats.items()}, tcfg, epoch)
        for k in jp:
            np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                       atol=1e-7, rtol=1e-6)
            np.testing.assert_allclose(tvel[k].numpy(), np.asarray(jvel[k]),
                                       atol=1e-7, rtol=1e-6)
    v = rng.rand(16, 100).astype(np.float32)
    np.testing.assert_allclose(
        rbm.free_energy(tp, torch.from_numpy(v)).numpy(),
        np.asarray(jrbm.free_energy(jp, jnp.asarray(v))), atol=1e-4,
        rtol=1e-5)


def test_rbm_learning_reduces_reconstruction_error():
    cfg = rbm.RBMConfig(n_vis=784, n_hid=64, lr=0.1)
    gen = torch.Generator().manual_seed(0)
    X = torch.from_numpy(dataset(512, seed=3)[0])
    p = rbm.rbm_init(gen, cfg)
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    step = rbm.make_rbm_step(cfg)
    errs = []
    for epoch in range(6):
        for b in range(0, 512, 128):
            p, vel, err = step(p, vel, X[b:b + 128], gen, epoch)
        errs.append(float(err))
    assert errs[-1] < errs[0] * 0.7, errs


def test_free_energy_gap_data_vs_noise_widens():
    cfg = rbm.RBMConfig(n_vis=784, n_hid=32)
    gen = torch.Generator().manual_seed(1)
    X = torch.from_numpy(dataset(256, seed=5)[0])
    noise = torch.rand(X.shape, generator=gen)
    p = rbm.rbm_init(gen, cfg)
    gap0 = float(rbm.free_energy(p, X).mean()
                 - rbm.free_energy(p, noise).mean())
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    step = rbm.make_rbm_step(cfg)
    for epoch in range(5):
        p, vel, _ = step(p, vel, X, gen, epoch)
    gap1 = float(rbm.free_energy(p, X).mean()
                 - rbm.free_energy(p, noise).mean())
    assert gap1 < gap0
