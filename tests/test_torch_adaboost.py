"""The port's AdaBoost precision refinement (``repro_torch.core.adaboost``,
paper §IV-C, multiclass SAMME) against the JAX package's
``repro.core.adaboost`` on the CPU.

* (a) a weak learner's logits and 5 SGD steps from the same numpy-drawn
  parameters and batches: parameters within 2e-5 and logits within 1e-5
  (fp32, as ``tests/test_torch_paper.py`` bounds the fine-tuning steps:
  XLA and torch sum the same products in other orders);
* (b) the JAX ensemble carried across by ``boost_learners_from_numpy``:
  the port's votes pick JAX's class on every row, except where one
  learner's top two logits lie within 1e-5 (an fp32 last bit may then flip
  that learner's argmax); those rows are counted and printed;
* (c) the JAX learners' miss vectors, run in turn through the port's
  ``samme_round`` from uniform weights, give JAX's vote weights within
  1e-12 relative (fp64 on both sides);
* (d) a learner at or past the multiclass condition (eps >= 1 - 1/K) ends
  boosting with no learner appended;
* (e) the port's own ``fit`` (its generator, its draws, which differ from
  JAX's by design) keeps a learner and beats chance, as
  ``tests/test_system.py`` asks of the JAX one, and two runs from one
  seed are equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import adaboost as jada  # noqa: E402
from repro.data import dataset as j_dataset  # noqa: E402
from repro_torch.core import adaboost  # noqa: E402
from repro_torch.data import train_test  # noqa: E402
from repro_torch.models.convert import boost_learners_from_numpy  # noqa: E402

PARAM_TOL, LOGIT_TOL, N_STEPS = 2e-5, 1e-5, 5
TIE_GAP = 1e-5                 # top-two logit gap below which argmax may flip
ALPHA_RTOL = 1e-12


@pytest.fixture(autouse=True)
def one_thread():
    """Hundreds of small ops: one torch thread keeps them cheap when the
    suite runs in several processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_fit():
    """JAX's ensemble on 256 digits: 3 rounds of 1 epoch, 16 hidden."""
    X, y = j_dataset(256, seed=3)
    cfg = jada.BoostConfig(n_rounds=3, n_hidden=16, epochs=1)
    learners, alphas = jada.fit(X, y, cfg, jax.random.PRNGKey(0))
    return X, y, cfg, learners, alphas


def _jax_logits(p, X):
    return np.asarray(jada._mlp_logits({k: jnp.asarray(v)
                                        for k, v in p.items()},
                                       jnp.asarray(X)))


def test_weak_learner_steps_match_jax():
    rng = np.random.RandomState(0)
    X, y = j_dataset(5 * 32, seed=1)
    p0 = {"W1": (0.1 * rng.randn(784, 16)).astype(np.float32),
          "b1": (0.01 * rng.randn(16)).astype(np.float32),
          "W2": (0.1 * rng.randn(16, 10)).astype(np.float32),
          "b2": (0.01 * rng.randn(10)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = boost_learners_from_numpy([p0])[0]
    np.testing.assert_allclose(
        adaboost._mlp_logits(tp, torch.from_numpy(X)).numpy(),
        np.asarray(jada._mlp_logits(jp, jnp.asarray(X))),
        atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for i in range(N_STEPS):
        xb, yb = X[i * 32:(i + 1) * 32], y[i * 32:(i + 1) * 32]
        jp = jada._sgd_step(jp, jnp.asarray(xb), jnp.asarray(yb), 0.5)
        tp = adaboost._sgd_step(tp, torch.from_numpy(xb),
                                torch.from_numpy(yb), 0.5)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=PARAM_TOL, rtol=PARAM_TOL)
    np.testing.assert_allclose(
        adaboost._mlp_logits(tp, torch.from_numpy(X)).numpy(),
        np.asarray(jada._mlp_logits(jp, jnp.asarray(X))),
        atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_votes_of_jax_learners_match_jax(jax_fit):
    X, y, _, learners, alphas = jax_fit
    assert learners, "JAX kept no learner"
    tl = boost_learners_from_numpy(learners)
    got = adaboost.predict(tl, alphas, X)
    want = jada.predict(learners, alphas, X)
    near = np.zeros(len(X), bool)
    for p in learners:
        top2 = np.sort(_jax_logits(p, X), -1)[:, -2:]
        near |= top2[:, 1] - top2[:, 0] < TIE_GAP
    print(f"rows with a learner's top two logits within {TIE_GAP}: "
          f"{int(near.sum())} of {len(X)}")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got[~near], want[~near])
    assert abs(adaboost.error_rate(tl, alphas, X, y)
               - jada.error_rate(learners, alphas, X, y)) \
        <= near.sum() / len(X)


def test_samme_weights_match_jax(jax_fit):
    X, y, cfg, learners, alphas = jax_fit
    w = torch.full((len(X),), 1.0 / len(X), dtype=torch.float64)
    got = []
    for p in learners:
        miss = torch.from_numpy(np.argmax(_jax_logits(p, X), -1) != y)
        alpha, w = adaboost.samme_round(w, miss, cfg.n_classes)
        got.append(alpha)
    np.testing.assert_allclose(got, alphas, rtol=ALPHA_RTOL, atol=0)
    assert w.dtype == torch.float64
    assert abs(float(w.sum()) - 1.0) < 1e-12


def test_samme_round_stops_at_the_multiclass_condition():
    """eps = 0.9 at K = 10 stops; just below it does not; eps = 0 is
    clamped at 1e-10."""
    n = 100
    w = torch.full((n,), 1.0 / n, dtype=torch.float64)
    miss = torch.arange(n) < 90                   # eps = 0.9 = 1 - 1/10
    alpha, w2 = adaboost.samme_round(w, miss, 10)
    assert alpha is None and torch.equal(w2, w)
    alpha, _ = adaboost.samme_round(w, torch.arange(n) < 89, 10)
    assert alpha is not None and alpha > 0
    alpha, w3 = adaboost.samme_round(w, torch.zeros(n, dtype=torch.bool),
                                     10)                # eps clamped
    assert alpha == pytest.approx(np.log((1 - 1e-10) / 1e-10) + np.log(9),
                                  rel=ALPHA_RTOL)
    assert torch.equal(w3, w)


def test_fit_keeps_no_learner_past_the_condition(monkeypatch):
    """A weak learner that always answers class 0, on data with no 0 (eps
    = 1): the first round ends boosting and nothing is appended."""
    def always_zero(gen, X, y, cfg):
        p = adaboost._mlp_init(gen, X.shape[1], cfg.n_hidden, cfg.n_classes)
        p["W2"].zero_()
        p["b2"][0] = 1.0
        return p
    monkeypatch.setattr(adaboost, "_train_weak", always_zero)
    X, y = j_dataset(64, seed=5)
    learners, alphas = adaboost.fit(X, 1 + y % 9, adaboost.BoostConfig(
        n_rounds=3, n_hidden=4), torch.Generator().manual_seed(0))
    assert learners == [] and alphas == []


def test_port_fit_beats_chance_and_repeats():
    Xtr, ytr, Xte, yte = train_test(n_train=512, n_test=256, seed=2)
    cfg = adaboost.BoostConfig(n_rounds=3, epochs=2)
    runs = [adaboost.fit(Xtr, ytr, cfg, torch.Generator().manual_seed(0))
            for _ in range(2)]
    (learners, alphas), (learners2, alphas2) = runs
    assert len(learners) >= 1
    assert alphas == alphas2
    for a, b in zip(learners, learners2):
        assert all(torch.equal(a[k], b[k]) for k in a)
    err = adaboost.error_rate(learners, alphas, Xte, yte)
    assert err < 0.9, f"boosted test error {err} (chance = 0.9)"
    assert adaboost.predict(learners, alphas, Xte).shape == (256,)


def test_boost_bridge_refuses_a_wrong_tree(jax_fit):
    learners = jax_fit[3]
    with pytest.raises(KeyError):
        boost_learners_from_numpy([{k: v for k, v in learners[0].items()
                                    if k != "b2"}])
    bad = dict(learners[0], W2=np.zeros((3, 10), np.float32))
    with pytest.raises(ValueError):
        boost_learners_from_numpy([bad])
