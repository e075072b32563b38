"""The paper's figures and demos in the port (``repro_torch.launch.fig6_
unsup_error``, ``fig7_sup_error``, ``fig8_scaling``, ``figures`` and
``examples/*_torch.py``) on the CPU, against the JAX scripts.

* Figs. 6 and 7 from one stack: both packages' ``train_dbn`` (patched in
  each script) return the same JAX-pretrained (784, 32, 16) stack and
  both ``finetune.classifier_init`` the same numpy-drawn head, then both
  scripts fine-tune on the same digits (n_train 256, n_test 64, batch
  32, 2 epochs).  Reconstruction errors within 1e-4 relative (fp32 sums
  in other orders, carried by momentum); error rates within one digit
  (1/n: an fp32 last bit may flip an argmax at a near-tie).  The CSV
  lines have the same names and keys in the same order.
* Fig. 8 at 1 and 2 gloo processes: JAX's keys, its analytic columns by
  its formulas exactly, and both ranks' parameters equal bit for bit
  after the jobs (each worker prints a digest).
* ``figures --only roofline`` prints the dry-run sweep's roofline table
  (a row a cell); both demos run to their last line on the CPU.
"""
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.finetune as j_finetune  # noqa: E402
from repro.core.dbn import DBNConfig as JDBNConfig  # noqa: E402
from repro.core.dbn import train_dbn as j_train_dbn  # noqa: E402
from repro.data import dataset as j_dataset  # noqa: E402
import repro_torch.core.finetune as t_finetune  # noqa: E402
from repro_torch.launch import (fig6_unsup_error, fig7_sup_error,  # noqa: E402
                                fig8_scaling, figures)
from repro_torch.models.convert import (dbn_tree_from_numpy,  # noqa: E402
                                        rbm_stack_from_numpy)

ROOT = Path(__file__).resolve().parents[1]
RECON_RTOL = 1e-4
SIZES = dict(n_train=256, n_test=64, batch=32, epochs=2, seed=0)


from _torch_common import one_thread  # noqa: E402, F401


def _load(rel: str, name: str):
    """A script by path: ``benchmarks/`` and ``examples/`` are not
    packages."""
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stack():
    """A JAX-pretrained (784, 32, 16) stack (numpy leaves) and a numpy-
    drawn softmax head for it."""
    X, _ = j_dataset(256, seed=11)
    s = j_train_dbn(X, JDBNConfig(stack=(784, 32, 16), max_epoch=1,
                                  batch_size=64), jax.random.PRNGKey(0))
    head = (0.01 * np.random.RandomState(3).randn(16, 10)).astype(np.float32)
    return [jax.device_get(p) for p in s], head


def _patch(monkeypatch, jmod, tmod, stack):
    layers, head = stack
    monkeypatch.setattr(jmod, "train_dbn", lambda X, cfg, key: [
        {k: jnp.asarray(v) for k, v in p.items()} for p in layers])
    monkeypatch.setattr(tmod, "train_dbn", lambda X, cfg, gen:
                        rbm_stack_from_numpy(layers))
    tree = {"W": [p["W"] for p in layers], "b": [p["bh"] for p in layers],
            "head_W": head, "head_b": np.zeros(10, np.float32)}
    monkeypatch.setattr(j_finetune, "classifier_init", lambda s, n, key: {
        k: [jnp.asarray(a) for a in v] if isinstance(v, list)
        else jnp.asarray(v) for k, v in tree.items()})
    monkeypatch.setattr(t_finetune, "classifier_init", lambda s, n, gen:
                        dbn_tree_from_numpy("classifier", tree))


def _keys(out: str):
    """The CSV lines with every value blanked: names and keys only."""
    return [re.sub(r"=[^,]*", "=", ln) for ln in out.splitlines()
            if "," in ln]


@pytest.mark.parametrize("fig", ["fig6_unsup_error", "fig7_sup_error"])
def test_fig6_fig7_rows_match_jax(fig, stack, monkeypatch, capsys):
    jmod = _load(f"benchmarks/{fig}.py", f"jax_{fig}")
    tmod = {"fig6_unsup_error": fig6_unsup_error,
            "fig7_sup_error": fig7_sup_error}[fig]
    _patch(monkeypatch, jmod, tmod, stack)
    jrows = jmod.run(stack=(784, 32, 16), **SIZES)
    jout = capsys.readouterr().out
    trows = tmod.run(stack=(784, 32, 16), device="cpu", **SIZES)
    tout = capsys.readouterr().out
    assert _keys(tout) == _keys(jout) and len(_keys(tout)) == 3
    assert len(trows) == len(jrows) == SIZES["epochs"]
    for (te, ttr, tte), (je, jtr, jte) in zip(trows, jrows):
        assert te == je
        assert all(np.isfinite([ttr, tte]))
        if fig == "fig6_unsup_error":
            np.testing.assert_allclose([ttr, tte], [jtr, jte],
                                       rtol=RECON_RTOL)
        else:
            assert abs(ttr - jtr) <= 1 / SIZES["n_train"] + 1e-12
            assert abs(tte - jte) <= 1 / SIZES["n_test"] + 1e-12


def test_fig8_rows_and_ranks(capsys):
    rows = fig8_scaling.run(worker_counts=(1, 2), device="cpu")
    out = capsys.readouterr().out
    assert len(rows) == 2
    jax_keys = {"workers", "s_per_job", "err", "ideal_work_fraction",
                "allreduce_mb_per_device", "speedup_measured"}
    for n, rec in zip((1, 2), rows):
        assert jax_keys <= set(rec)
        assert rec["workers"] == n and rec["threads"] == 1
        assert rec["ideal_work_fraction"] == 1.0 / n
        assert rec["allreduce_mb_per_device"] == \
            2 * (n - 1) / n * (784 * 512 * 4) / 1e6
        assert rec["speedup_measured"] == \
            rows[0]["s_per_job"] / rec["s_per_job"]
        assert rec["s_per_job"] > 0 and np.isfinite(rec["err"])
        assert len(rec["param_digests"]) == n
        assert len(set(rec["param_digests"])) == 1   # ranks bit-equal
        assert rec["k8_launches"] == 0                # plain version on CPU
    assert [ln.split(",")[1] for ln in out.splitlines()] == \
        ["workers=1", "workers=2"]


def test_fig8_refuses_two_workers_on_one_card(monkeypatch):
    monkeypatch.setattr(fig8_scaling, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="NCCL"):
        fig8_scaling.run(worker_counts=(1, 2), device="cuda")


def test_roofline_is_not_ported(tmp_path, capsys):
    """(Named while the figure refused.)  The roofline figure is ported
    (``launch/roofline.py``): it prints a CSV line and a table row for
    each traced cell of the sweep's directory, and a row with its reason
    for a skipped one."""
    from repro_torch.launch.dryrun import dryrun_cell
    for name in ("decode_32k", "long_500k"):
        rec = dryrun_cell("qwen2-0.5b", name, reduced=True, verbose=False)
        (tmp_path / f"qwen2-0.5b__{name}__256.json").write_text(
            json.dumps(rec))
    figures.main(["--only", "roofline", "--device", "cpu",
                  "--dryrun-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("roofline,qwen2-0.5b,decode_32k,256,") == 1
    rows = [x for x in out.splitlines() if x.startswith("| qwen2-0.5b")]
    assert len(rows) == 2
    assert "| skip |" in rows[1] and "sub-quadratic" in rows[1]


@pytest.mark.parametrize("demo,argv,last", [
    ("train_autoencoder_torch", ["--small", "--epochs", "1"], "recon L2:"),
    ("train_classifier_torch", [], "adaboost (")])
def test_demo_runs_on_cpu(demo, argv, last, capsys):
    mod = _load(f"examples/{demo}.py", demo)
    out = mod.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith(last), lines[-1]
    assert all(np.isfinite(v) for v in out.values()
               if isinstance(v, float))
