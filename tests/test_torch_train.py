"""The port's training path on the CPU, against the JAX package.

Parameters are drawn with numpy from a seed by ``repro``'s init rules as
bf16 (``seeded_params``) and cross into torch leaf for leaf.  Where a test
holds the port to JAX "in fp32", both sides run the same bf16-drawn values
cast to fp32: then the two frameworks differ only in the order of fp32
sums.  Tolerances, each with its reason:

* ``apply_updates`` (adamw and sgdm, clipping on and off, every schedule,
  three steps): masters and moments within 1e-6 relative (fp32 rounding:
  the global norm sums its leaves in another order), bf16 params within
  one bf16 ulp (a master one fp32 ulp off can round to the other bf16
  neighbour), lr and grad norm within 1e-6 relative.
* ``DecoderLM.loss`` and its gradients against ``jax.value_and_grad`` for
  reduced qwen2-0.5b: fp32 |dloss| <= 1e-5 and every leaf's gradient
  within 1e-5 relative L2 (measured 1e-6 and 1.4e-6); bf16 |dloss| <= 1e-3
  and 0.05 relative L2 (measured 3e-5 and 0.02: the frameworks round the
  bf16 products of the forward and the backward at other points, one bf16
  ulp being 0.4 %).  The forward loss alone, fp32 within 1e-5, for reduced
  starcoder2-7b (sliding window) and deepseek-v2-236b (MLA + MoE with the
  router's load-balance loss).
* Three ``make_train_step`` steps (pjit; mapreduce with no group; pjit
  with two microbatches), fp32: the loss history within 1e-5 of JAX's.
* Checkpoints as ``tests/test_checkpoint.py`` checks JAX's (bf16 leaves
  round-trip bit for bit), resume equal to an uninterrupted run bit for
  bit, and the NaN guard keeping the state from before the poisoned step.
* ``launch/train.py --device cpu --reduced``: the loss falls, and
  ``--engine mapreduce`` over a gloo group of one process gives the pjit
  run's loss.
"""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch, reduced  # noqa: E402
from repro.core import dbn as jdbn  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models.params import ParamDef as JParamDef  # noqa: E402
from repro.models.registry import build_model as j_build  # noqa: E402
from repro.models.steps import make_train_step as j_train_step  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import (all_steps, latest_step,  # noqa: E402
                                    restore, save)
from repro_torch.core import dbn as tdbn  # noqa: E402
from repro_torch.data import token_batches  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import (tree_leaves, tree_map,  # noqa: E402
                                       tree_unflatten)
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.steps import make_train_step  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.runtime import (LoopConfig, TrainLoop,  # noqa: E402
                                 degraded_mesh, restore_on_mesh)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


from _torch_common import one_thread  # noqa: E402, F401


def seeded_params(jcfg, seed):
    """The JAX model's parameter tree drawn with numpy from ``seed`` by the
    rules of ``repro.models.params`` (``init_params`` itself folds in
    ``hash(path)``, which changes with PYTHONHASHSEED from one process to
    the next), as bf16 JAX arrays: the same values in every run."""
    rng = np.random.RandomState(seed)

    def draw(d):
        if d.init in ("zeros", "ones"):
            return jnp.full(d.shape, d.init == "ones", jnp.bfloat16)
        scale = 0.02 if d.init == "embed" \
            else 1.0 / np.sqrt(max(1, int(np.prod(d.shape[:-1]))))
        return jnp.asarray(rng.randn(*d.shape) * scale, jnp.bfloat16)
    return jax.tree.map(draw, j_build(jcfg).param_defs(),
                        is_leaf=lambda x: isinstance(x, JParamDef))


def _pair(arch, fp32):
    """(jax cfg, torch cfg, jax params, torch params), bf16-drawn values,
    both cast to fp32 when ``fp32``."""
    jcfg = reduced(get_arch(arch))
    tcfg = tconfigs.reduced(tconfigs.get_arch(arch))
    jp = seeded_params(jcfg, 0)
    tp = params_from_numpy(tcfg, jax.device_get(jp))
    if fp32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        tp = tree_map(lambda t: t.float(), tp)
    return jcfg, tcfg, jp, tp


def _np(tree):
    return {p: np.asarray(v, np.float32) for p, v in tree_leaves(tree)}


def _tokens(vocab, B=2, S=80, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)) \
        .astype(np.int32)


# ------------------------------------------------------------- optimizer

def _opt_tree(rng):
    return {"w": rng.randn(6, 5).astype(np.float32),
            "blocks": {"b": rng.randn(7).astype(np.float32),
                       "e": (rng.randn(4, 3) * 3).astype(np.float32)}}


@pytest.mark.parametrize("schedule", ["const", "cosine",
                                      "linear_warmup_cosine"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("name", ["adamw", "sgdm"])
def test_apply_updates_matches_jax(name, clip, schedule):
    rng = np.random.RandomState(7)
    cfg = dict(name=name, lr=0.05, weight_decay=0.01, grad_clip=clip,
               schedule=schedule, warmup=2, total_steps=5)
    jcfg, tcfg = joptim.OptConfig(**cfg), toptim.OptConfig(**cfg)
    p0 = _opt_tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    jp["blocks"]["e"] = jp["blocks"]["e"].astype(jnp.bfloat16)
    tp = tree_map(torch.from_numpy, p0)
    tp["blocks"]["e"] = tp["blocks"]["e"].bfloat16()
    js, ts = joptim.init_opt_state(jp, jcfg), toptim.init_opt_state(tp, tcfg)
    for _ in range(3):
        g = _opt_tree(rng)
        old = tree_map(torch.clone, tp)
        jp, js, jm = joptim.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                          js, jcfg)
        tp2, ts, tm = toptim.apply_updates(tp, tree_map(torch.from_numpy, g),
                                           ts, tcfg)
        # out of place: the inputs are left as they were
        for (_, a), (_, b) in zip(tree_leaves(tp), tree_leaves(old)):
            assert torch.equal(a, b)
        tp = tp2
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        assert int(ts["step"]) == int(js["step"])
        want = _np(jax.device_get(js["params"]))
        for p, v in tree_leaves(ts["params"]):
            np.testing.assert_allclose(v.numpy(), want[p], rtol=1e-6,
                                       atol=1e-7, err_msg=p)
        want = _np(jax.device_get(jp))
        for p, v in tree_leaves(tp):
            assert v.dtype == (torch.bfloat16 if p == "blocks/e"
                               else torch.float32)
            tol = 2.0 ** -8 if v.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(v.float().numpy(), want[p], rtol=tol,
                                       atol=1e-7, err_msg=p)


def test_opt_state_defs_match_init():
    tcfg = tconfigs.reduced(tconfigs.get_arch("qwen2-0.5b"))
    defs = build_model(tcfg).param_defs()
    for name in ("adamw", "sgdm"):
        ocfg = toptim.OptConfig(name=name)
        sdefs = toptim.opt_state_defs(defs, ocfg)
        state = toptim.init_opt_state(_zeros(defs), ocfg)
        got = {p: (tuple(t.shape), t.dtype) for p, t in tree_leaves(state)}
        want = {p: (tuple(d.shape), d.dtype) for p, d in tree_leaves(sdefs)}
        assert got == want


def _zeros(defs):
    from repro_torch.models.params import tree_map_defs
    return tree_map_defs(lambda _, d: torch.zeros(d.shape, dtype=d.dtype),
                         defs)


# ------------------------------------------------------------- loss / grads

@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_loss_and_grads_match_jax(fp32):
    jcfg, tcfg, jp, tp = _pair("qwen2-0.5b", fp32)
    toks = _tokens(jcfg.vocab)
    jm = j_build(jcfg)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
            jp, {"tokens": jnp.asarray(toks)})
    leaves = [p.detach().requires_grad_(True) for _, p in tree_leaves(tp)]
    tl, taux = build_model(tcfg).loss(tree_unflatten(tp, leaves),
                                      {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(tl, leaves)
    assert abs(tl.item() - float(jl)) <= (1e-5 if fp32 else 1e-3)
    assert float(taux["tokens"]) == float(jaux["tokens"]) == 2 * 79
    want = _np(jax.device_get(jg))
    for (p, _), g in zip(tree_leaves(tp), grads):
        assert g.dtype == (torch.float32 if fp32 else torch.bfloat16)
        w = want[p]
        rel = np.linalg.norm(g.float().numpy() - w) / np.linalg.norm(w)
        assert rel <= (1e-5 if fp32 else 0.05), (p, rel)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "deepseek-v2-236b"])
def test_forward_loss_matches_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch, fp32=True)
    toks = _tokens(jcfg.vocab)
    jl, jaux = jax.jit(j_build(jcfg).loss)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, taux = build_model(tcfg).loss(tp,
                                          {"tokens": torch.from_numpy(toks)})
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert abs(float(taux["aux"]) - float(jaux["aux"])) <= 1e-5
    if tcfg.is_moe:
        assert float(taux["aux"]) > 0


# ------------------------------------------------------------- train steps

@pytest.fixture(scope="module")
def train_setup():
    jcfg, tcfg, jp, tp = _pair("qwen2-0.5b", fp32=True)
    ocfg = dict(lr=1e-3, schedule="linear_warmup_cosine", warmup=1,
                total_steps=3)
    data = token_batches(jcfg.vocab, 4, 32, seed=0)
    batches = [next(data)["tokens"] for _ in range(3)]
    return jcfg, tcfg, jp, tp, ocfg, batches


@pytest.mark.parametrize("engine,n_micro", [("pjit", 1), ("mapreduce", 1),
                                            ("pjit", 2)])
def test_train_steps_match_jax(train_setup, engine, n_micro):
    jcfg, tcfg, jp, tp, ocfg, batches = train_setup
    jo, to = joptim.OptConfig(**ocfg), toptim.OptConfig(**ocfg)
    mesh = make_host_mesh(data=1) if engine == "mapreduce" else None
    jstep = jax.jit(j_train_step(jcfg, mesh, jo, engine=engine,
                                 n_micro=n_micro))
    tstep = make_train_step(tcfg, to, engine=engine, n_micro=n_micro)
    js, ts = joptim.init_opt_state(jp, jo), toptim.init_opt_state(tp, to)
    jl, tl = [], []
    for b in batches:
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(b)})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.from_numpy(b)})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)


# ------------------------------------------------------------- checkpoints

def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn((8, 4), generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32),
                       "h": torch.randn((3, 5), generator=g).bfloat16()},
            "list": [torch.randn(2, generator=g)],
            "scalar": torch.tensor(3.5)}


def test_roundtrip_with_bf16_leaves(tmp_path):
    t = _tree()
    save(str(tmp_path), 7, (t, {"step": torch.tensor(7, dtype=torch.int32)}),
         extra={"cursor": 7})
    like = (tree_map(lambda x: torch.empty_like(x, device="meta"), t),
            {"step": torch.zeros((), dtype=torch.int32)})
    t2, step, extra = restore(str(tmp_path), like)
    assert step == 7 and extra["cursor"] == 7
    assert int(t2[1]["step"]) == 7
    for (p, a), (_, b) in zip(tree_leaves(t), tree_leaves(t2[0])):
        assert a.dtype == b.dtype and b.device.type == "cpu", p
        assert torch.equal(a, b), p


def test_async_save_and_gc(tmp_path):
    t = _tree()
    threads = [save(str(tmp_path), s, t, _async=True) for s in (1, 2, 3, 4, 5)]
    for th in threads:
        th.join()
    steps = all_steps(str(tmp_path))
    assert len(steps) <= 3 and steps[-1] == 5
    assert latest_step(str(tmp_path)) == 5


def test_async_save_copies_before_the_thread(tmp_path):
    t = {"a": torch.zeros(4)}
    th = save(str(tmp_path), 1, t, _async=True)
    t["a"].add_(1.0)                        # the caller moves on at once
    th.join()
    assert torch.equal(restore(str(tmp_path), t)[0]["a"], torch.zeros(4))


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "nope"), {"a": torch.zeros(2)})


def test_restore_on_mesh_and_degraded_mesh(tmp_path):
    tcfg = tconfigs.reduced(tconfigs.get_arch("qwen2-0.5b"))
    defs = build_model(tcfg).param_defs()
    params = tree_map(lambda t: t + torch.rand(t.shape).to(t.dtype),
                      _zeros(defs))
    save(str(tmp_path), 3, params)
    got, step, _ = restore_on_mesh(str(tmp_path), defs, "cpu")
    assert step == 3
    for (p, a), (_, b) in zip(tree_leaves(params), tree_leaves(got)):
        assert torch.equal(a, b), p
    mesh = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                 devices=np.zeros((2, 4, 2)))
    for axis in ("pod", "data", "nope"):
        assert degraded_mesh(mesh, axis) == jelastic.degraded_mesh(mesh, axis)


def _loop_parts():
    tcfg = dataclasses.replace(tconfigs.reduced(
        tconfigs.get_arch("qwen2-0.5b")), n_layers=1)
    ocfg = toptim.OptConfig(lr=1e-3)
    step = make_train_step(tcfg, ocfg)
    from repro_torch.models.registry import init_params
    params = init_params(tcfg, 0, "cpu")
    state = (params, toptim.init_opt_state(params, ocfg))

    def loop_step(state, batch):
        p, o, m = step(*state, {"tokens": torch.from_numpy(batch["tokens"])})
        return (p, o), m
    return tcfg, state, loop_step


def test_resume_equals_uninterrupted(tmp_path):
    tcfg, state, loop_step = _loop_parts()

    def data():
        return token_batches(tcfg.vocab, 2, 16, seed=3)
    full = TrainLoop(loop_step, state, data(), LoopConfig(log_every=0))
    full.run(4)
    cfg = LoopConfig(ckpt_dir=str(tmp_path), ckpt_every=2, async_save=True,
                     log_every=0)
    first = TrainLoop(loop_step, state, data(), cfg)
    first.run(2)
    second = TrainLoop(loop_step, state, data(), cfg)   # restarts, resumes
    assert second.step == 2
    second.run(2)
    assert first.history + second.history == full.history
    for (p, a), (_, b) in zip(tree_leaves(full.state),
                              tree_leaves(second.state)):
        assert torch.equal(a, b), p


def test_nan_guard_keeps_the_prior_state():
    tcfg, state, loop_step = _loop_parts()
    seen = []

    def guarded(state, batch):
        new, m = loop_step(state, batch)
        if len(seen) == 1:                  # poison the second step
            new = tree_map(lambda t: t * float("nan"), new)
            m = {**m, "loss": torch.tensor(float("nan"))}
        seen.append(state)
        return new, m
    loop = TrainLoop(guarded, state, token_batches(tcfg.vocab, 2, 16, seed=4),
                     LoopConfig(log_every=0))
    loop.run(3)
    assert loop.step == 3 and len(loop.history) == 2
    # the third step started from the state the poisoned one was given
    for (p, a), (_, b) in zip(tree_leaves(seen[1]), tree_leaves(seen[2])):
        assert torch.equal(a, b), p
    assert all(torch.isfinite(t).all() for _, t in tree_leaves(loop.state)
               if t.is_floating_point())


# ------------------------------------------------------------- CLI, dbn

ARGV = ["--device", "cpu", "--reduced", "--steps", "6", "--global-batch",
        "4", "--seq-len", "32"]


def test_train_cli_loss_falls_and_mapreduce_agrees():
    out = train_main(ARGV)
    assert out["steps"] == 6 and out["history"][-1] < out["history"][0]
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *ARGV, "--engine", "mapreduce"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"final loss {out['final_loss']:.4f} after 6 steps" in r.stdout


def test_grow_stacked_params_matches_jax():
    rng = np.random.RandomState(5)
    tree = {"blocks": {"w": rng.randn(2, 3, 4).astype(np.float32),
                       "b": rng.randn(2, 4).astype(np.float32)},
            "s": np.float32(2.0)}
    want = jdbn.grow_stacked_params(jax.tree.map(jnp.asarray, tree), 5)
    got = tdbn.grow_stacked_params(tree_map(torch.as_tensor, tree), 5)
    for p, v in tree_leaves(got):
        np.testing.assert_array_equal(v.numpy(), _np(want)[p])
    stages = []

    def train_fn(n_layers, params):
        stages.append((n_layers, params))
        return {"depth": n_layers}
    assert tdbn.progressive_stack_lm(train_fn, (1, 2, 4)) == {"depth": 4}
    assert [s[0] for s in stages] == [1, 2, 4] and stages[0][1] is None \
        and stages[2][1] == {"depth": 2}
