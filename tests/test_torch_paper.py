"""The paper's path in the port, end to end on the CPU, against the JAX
package: the DBN driver (Algorithm 1), the autoencoder and classifier
fine-tuning, the weight bridge, the data copies and the quickstart.

* JAX pre-trains a small stack; the port takes it through
  ``models.convert`` and both packages run the same fine-tuning steps on
  the same batches (autoencoder and classifier).  fp32 throughout:
  parameters within 2e-5 and losses within 1e-5 relative after 5 steps
  (XLA and torch sum the same fp32 products in other orders; momentum
  carries those last-bit differences from step to step).
* The port's own pre-training (its generator, its draws) shows the JAX
  tests' properties (``tests/test_rbm_dbn.py``): the reconstruction error
  falls, fine-tuning lowers it further, and the classifier beats chance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import autoencoder as jae  # noqa: E402
from repro.core import finetune as jft  # noqa: E402
from repro.core.dbn import DBNConfig as JDBNConfig  # noqa: E402
from repro.core.dbn import forward_stack as j_forward_stack  # noqa: E402
from repro.core.dbn import train_dbn as j_train_dbn  # noqa: E402
from repro.data import dataset as j_dataset  # noqa: E402
from repro.data import dedup as j_dedup  # noqa: E402
from repro_torch.configs import MNIST_DBN, get_arch  # noqa: E402
from repro_torch.configs import mnist_dbn  # noqa: E402
from repro_torch.core import (DBNConfig, autoencoder, finetune,  # noqa: E402
                              forward_stack, train_dbn)
from repro_torch.core import dbn  # noqa: E402
from repro_torch.data import dataset, dedup, train_test  # noqa: E402
from repro_torch.kernels.rbm_cd import gemm_sigmoid  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.models.convert import (dbn_tree_from_numpy,  # noqa: E402
                                        rbm_stack_from_numpy)
from repro_torch.models.params import tree_map  # noqa: E402

PARAM_TOL, LOSS_TOL, N_STEPS = 2e-5, 1e-5, 5


from _torch_common import one_thread  # noqa: E402, F401


@pytest.fixture(scope="module")
def pretrained():
    """A JAX-pretrained (784, 64, 16) stack on 256 digits, and the data."""
    X, y = j_dataset(384, seed=2)
    stack = j_train_dbn(X[:256], JDBNConfig(stack=(784, 64, 16), max_epoch=1,
                                            batch_size=64),
                        jax.random.PRNGKey(0))
    return [jax.device_get(p) for p in stack], X, y


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def _close(tparams, jparams, tol):
    jl = _leaves(jparams)
    tl = [t.numpy() for t in jax.tree.leaves(tparams)]
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


def test_unroll_and_forward_stack_match_jax(pretrained):
    stack, X, _ = pretrained
    tstack = rbm_stack_from_numpy(stack)
    junroll = jae.unroll([{k: jnp.asarray(v) for k, v in p.items()}
                          for p in stack])
    tunroll = autoencoder.unroll(tstack)
    for k in ("enc_W", "enc_b", "dec_W", "dec_b"):
        for a, b in zip(tunroll[k], junroll[k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(
        forward_stack(tstack, torch.from_numpy(X[:32])).numpy(),
        np.asarray(j_forward_stack(stack, jnp.asarray(X[:32]))), atol=1e-5,
        rtol=1e-5)


def test_autoencoder_finetuning_matches_jax(pretrained):
    stack, X, _ = pretrained
    jparams = jae.unroll([{k: jnp.asarray(v) for k, v in p.items()}
                          for p in stack])
    tparams = dbn_tree_from_numpy("autoencoder", jax.device_get(jparams))
    jstep = jae.make_finetune_step(None, lr=0.02)
    tstep = autoencoder.make_finetune_step(None, lr=0.02)
    jvel = jax.tree.map(jnp.zeros_like, jparams)
    tvel = tree_map(torch.zeros_like, tparams)
    for i in range(N_STEPS):
        xb = X[i * 32:(i + 1) * 32]
        jparams, jvel, jl, jaux = jstep(jparams, jvel,
                                        {"x": jnp.asarray(xb)})
        tparams, tvel, tl, taux = tstep(tparams, tvel,
                                        {"x": torch.from_numpy(xb)})
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)
        np.testing.assert_allclose(float(taux["mse"]), float(jaux["mse"]),
                                   rtol=LOSS_TOL)
    _close(tparams, jparams, PARAM_TOL)
    np.testing.assert_allclose(
        autoencoder.reconstruction_error(tparams, X[300:]),
        jae.reconstruction_error(jparams, X[300:]), rtol=LOSS_TOL)


def test_classifier_finetuning_matches_jax(pretrained):
    stack, X, y = pretrained
    jparams = jft.classifier_init(stack, 10, jax.random.PRNGKey(1))
    tparams = dbn_tree_from_numpy("classifier", jax.device_get(jparams))
    jstep = jft.make_classifier_step(None, lr=0.5)
    tstep = finetune.make_classifier_step(None, lr=0.5)
    jvel = jax.tree.map(jnp.zeros_like, jparams)
    tvel = tree_map(torch.zeros_like, tparams)
    for i in range(N_STEPS):
        xb, yb = X[i * 32:(i + 1) * 32], y[i * 32:(i + 1) * 32]
        jparams, jvel, jl, jaux = jstep(jparams, jvel, {
            "x": jnp.asarray(xb), "y": jnp.asarray(yb)})
        tparams, tvel, tl, taux = tstep(tparams, tvel, {
            "x": torch.from_numpy(xb), "y": torch.from_numpy(yb)})
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)
        assert float(taux["acc"]) == float(jaux["acc"])
    _close(tparams, jparams, PARAM_TOL)
    assert finetune.error_rate(tparams, X[300:], y[300:]) == \
        jft.error_rate(jparams, X[300:], y[300:])


def test_dbn_autoencoder_end_to_end():
    """Algorithm 1 + unroll + fine-tune in the port, through K8's wrapper:
    the layer's reconstruction error falls over its epochs and fine-tuning
    lowers the autoencoder's."""
    Xtr, _, Xte, _ = train_test(n_train=512, n_test=128, seed=0)
    cfg = DBNConfig(stack=(784, 128, 32), max_epoch=3, batch_size=128,
                    lr=0.1)
    errs = {}
    stack = train_dbn(Xtr, cfg, torch.Generator().manual_seed(0),
                      callback=lambda layer, epoch, recon_err:
                      errs.setdefault(layer, []).append(recon_err))
    assert len(stack) == 2
    assert all(e[-1] < e[0] for e in errs.values()), errs
    params = autoencoder.unroll(stack)
    err_pre = autoencoder.reconstruction_error(params, Xte)
    step = autoencoder.make_finetune_step(None, lr=0.02)
    vel = tree_map(torch.zeros_like, params)
    for _ in range(4):
        for b in range(0, 512, 128):
            params, vel, _, _ = step(params, vel,
                                     {"x": torch.from_numpy(Xtr[b:b + 128])})
    assert autoencoder.reconstruction_error(params, Xte) < err_pre


def test_classifier_beats_chance():
    Xtr, ytr, Xte, yte = train_test(n_train=1024, n_test=256, seed=1)
    gen = torch.Generator().manual_seed(0)
    stack = train_dbn(Xtr, DBNConfig(stack=(784, 64), max_epoch=2,
                                     batch_size=128), gen)
    params = finetune.classifier_init(stack, 10, gen)
    step = finetune.make_classifier_step(None, lr=1.0)
    vel = tree_map(torch.zeros_like, params)
    for _ in range(15):
        for b in range(0, 1024, 128):
            params, vel, _, _ = step(params, vel, {
                "x": torch.from_numpy(Xtr[b:b + 128]),
                "y": torch.from_numpy(ytr[b:b + 128])})
    err = finetune.error_rate(params, Xte, yte)
    assert err < 0.5, f"test error {err} (chance = 0.9)"


def test_forward_prop_job_is_one_k8_call_per_layer():
    """On the CPU the wrapper runs its plain version and counts nothing;
    the DBN's probabilities all go through it (3 per CD-1 step, 1 per
    layer's forward-propagation job: ``chip_smoke.py`` counts them on the
    card)."""
    calls = []
    real = dbn.hidden_probs

    def counting(p, v):
        calls.append(v.shape[0])
        return real(p, v)
    X = dataset(64, seed=4)[0]
    n0 = gemm_sigmoid.launches
    dbn.hidden_probs = counting
    try:
        train_dbn(X, DBNConfig(stack=(784, 16, 8), max_epoch=1,
                               batch_size=32),
                  torch.Generator().manual_seed(0))
    finally:
        dbn.hidden_probs = real
    assert calls == [64, 64]                      # one job per layer
    assert gemm_sigmoid.launches == n0


def test_quickstart_runs_on_cpu():
    out = quickstart.main(["--device", "cpu"])
    assert 0.0 <= out["test_error"] < 0.9
    assert out["k8_launches"] == 0                  # plain version on CPU


def test_data_copies_and_config_match_jax():
    X, y = dataset(64, seed=7, duplicate_frac=0.2)
    jX, jy = j_dataset(64, seed=7, duplicate_frac=0.2)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    for a, b in zip(dedup(X, y), j_dedup(jX, jy)):
        np.testing.assert_array_equal(a, b)
    assert MNIST_DBN.name == "mnist-dbn" and mnist_dbn.STACK == \
        (784, 1000, 500, 250, 30)
    with pytest.raises(KeyError):                 # not a served LM arch
        get_arch("mnist-dbn")


def test_weight_bridge_refuses_a_wrong_tree(pretrained):
    stack, _, _ = pretrained
    with pytest.raises(KeyError):
        rbm_stack_from_numpy([{"W": stack[0]["W"], "bh": stack[0]["bh"]}])
    with pytest.raises(ValueError):
        rbm_stack_from_numpy([stack[1], stack[0]])          # does not chain
    with pytest.raises(KeyError):
        dbn_tree_from_numpy("classifier", {"W": [], "b": []})


def test_lm_stacking_waits_for_the_trainer():
    """Progressive stacking raised until the LM trainer was ported; now
    each stage of ``progressive_stack_lm`` starts from the last stage's
    layers cycled to its depth (``grow_stacked_params``) and trains a
    step."""
    import dataclasses
    from repro_torch.configs import reduced
    from repro_torch.models.registry import init_params
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import OptConfig, init_opt_state
    base = reduced(get_arch("qwen2-0.5b"))
    ocfg = OptConfig(lr=1e-3)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, base.vocab, (2, 16)))
    losses = []

    def train_fn(n_layers, prev):
        cfg = dataclasses.replace(base, n_layers=n_layers)
        params = init_params(cfg, 0, "cpu")
        if prev is not None:
            params["blocks"] = dbn.grow_stacked_params(prev["blocks"],
                                                       n_layers)
            for name, t in params["blocks"]["attn"].items():
                assert torch.equal(t[-1], prev["blocks"]["attn"][name][
                    (n_layers - 1) % prev["blocks"]["attn"][name].shape[0]])
        params, _, m = make_train_step(cfg, ocfg)(
            params, init_opt_state(params, ocfg), {"tokens": toks})
        losses.append(float(m["loss"]))
        return params
    out = dbn.progressive_stack_lm(train_fn, [1, 2, 4])
    assert out["blocks"]["mlp"]["up"].shape[0] == 4
    assert len(losses) == 3 and all(np.isfinite(losses))
