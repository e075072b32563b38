"""The port's sharding rules and parameter sizing against the JAX package's
(``repro_torch.models.{shardings,params}``, ``launch/mesh.py``).

* ``resolve`` gives JAX's spec for every leaf of every registered arch's
  full-width ``param_defs`` and ``opt_state_defs``, and ``sharded_bytes``,
  ``param_bytes`` and ``param_count`` JAX's numbers, on the meshes (16,
  16), (2, 16, 16), (32, 8), (256,) and (2, 256).  JAX's functions read
  only ``axis_names`` and ``devices.shape`` of a mesh, so they get a
  duck-typed one (``devices`` an ``np.empty`` of the shape): no device is
  needed.  Exact equality: both are integer arithmetic on the same defs.
* deepseek-v2-236b's bf16 parameters a device: 30.9 GB on (16, 16), 60.3
  GB on (32, 8), all 471.6 GB on the port's (2, 256).
* ``MeshSpec``, the production and host meshes, and the step arguments'
  local shapes (the batch split over ``pod`` x ``data`` only where it
  divides; the optimizer state whole) on ``meta``.
* On JAX's one-device host mesh, ``train_shardings`` and
  ``serve_shardings`` give JAX's specs leaf by leaf, and
  ``abstract_params``, ``abstract_cache`` and ``input_specs`` JAX's shapes
  and dtypes, for every registered arch.
"""
import types

import numpy as np
import pytest

from _torch_common import one_thread  # noqa: F401

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.models import params as j_params  # noqa: E402
from repro.models import shardings as j_shardings  # noqa: E402
from repro.models.registry import build_model as j_build  # noqa: E402
from repro.optim import OptConfig as JOpt, opt_state_defs as j_opt_defs  # noqa: E402
from repro_torch.configs import ARCHS, ShapeConfig, get_arch  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh, mesh_name)
from repro_torch.models import params as t_params  # noqa: E402
from repro_torch.models import shardings as t_shardings  # noqa: E402
from repro_torch.models.registry import (abstract_cache,  # noqa: E402
                                         abstract_params, build_model,
                                         input_specs)
from repro_torch.models.steps import (abstract_serve_args,  # noqa: E402
                                      abstract_train_args, train_shardings)
from repro_torch.optim import OptConfig, opt_state_defs  # noqa: E402

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((32, 8), ("data", "model")),
          ((256,), ("data",)),
          ((2, 256), ("pod", "data"))]


def duck_mesh(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def j_leaves(defs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        defs, is_leaf=lambda d: isinstance(d, j_params.ParamDef))
    return {"/".join(str(k.key) for k in path): d for path, d in flat}


def t_leaves(defs):
    return dict(t_params.tree_leaves(defs))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_resolve_and_sizes_equal_jax(arch):
    jp = j_build(J_ARCHS[arch]).param_defs()
    tp = build_model(get_arch(arch)).param_defs()
    trees = [(jp, tp), (j_opt_defs(jp, JOpt()), opt_state_defs(tp, OptConfig()))]
    for jd, td in trees:
        jl, tl = j_leaves(jd), t_leaves(td)
        assert sorted(jl) == sorted(tl)
        assert t_params.param_count(td) == j_params.param_count(jd)
        assert t_params.param_bytes(td) == j_params.param_bytes(jd)
        for shape, names in MESHES:
            jm = duck_mesh(shape, names)
            tm = t_shardings.MeshSpec(shape, names)
            for path, d in tl.items():
                j = jl[path]
                assert d.shape == j.shape and d.logical == j.logical, path
                want = tuple(j_shardings.resolve(j.logical, j.shape, jm))
                got = t_shardings.resolve(d.logical, d.shape, tm)
                assert tuple(got) == want, (path, shape)
            assert t_params.sharded_bytes(td, tm) \
                == j_params.sharded_bytes(jd, jm), shape


def test_deepseek_parameter_bytes_a_device():
    defs = build_model(get_arch("deepseek-v2-236b")).param_defs()
    gb = {shape: t_params.sharded_bytes(defs, t_shardings.MeshSpec(
        shape, names)) / 1e9 for shape, names in MESHES}
    assert round(gb[(16, 16)], 1) == 30.9
    assert round(gb[(32, 8)], 1) == 60.3
    assert round(gb[(2, 256)], 1) == 471.6 == round(
        t_params.param_bytes(defs) / 1e9, 1)


def test_mesh_spec_reads_as_a_jax_mesh():
    m = make_production_mesh(multi_pod=True)
    assert (m.dims, m.axis_names, m.size) == ((2, 256), ("pod", "data"), 512)
    assert m.shape == {"pod": 2, "data": 256}
    # the process ranks dp_groups lays out: pod p holds p * 256 ...
    assert m.devices.shape == (2, 256) and m.devices[1, 3] == 259
    assert mesh_name(make_production_mesh()) == "256"
    assert mesh_name(m) == "2x256"
    assert make_host_mesh(data=4, model=2, pod=2).shape \
        == {"pod": 2, "data": 4, "model": 2}
    assert make_host_mesh().axis_names == ("data",)
    assert t_shardings.dp_axes(m) == j_shardings.dp_axes(
        duck_mesh((2, 256), ("pod", "data")))
    spec = t_shardings.P(("pod", "data"), None)
    assert isinstance(spec, tuple) and spec == (("pod", "data"), None)


def test_abstract_step_args_take_local_shapes_on_meta():
    cfg = get_arch("qwen2-0.5b")
    mesh = make_production_mesh(multi_pod=True)
    opt = OptConfig()
    for B, local in ((512, 1), (256, 256)):      # 256 does not split 512
        shape = ShapeConfig("t", "train", 64, B)
        params, state, batch = abstract_train_args(cfg, shape, mesh, opt)
        assert batch["tokens"].shape == (local, 64)
        assert batch["tokens"].device.type == "meta"
        emb = params["embed"]["tok"]
        assert emb.shape == (cfg.vocab_padded, cfg.d_model)  # replicated
        mu = state["params"]["embed"]["tok"]["mu"]
        assert mu.shape == emb.shape and mu.dtype == torch.float32
    specs = train_shardings(cfg, ShapeConfig("t", "train", 64, 512), mesh,
                            opt)
    assert specs[2]["tokens"] == (("pod", "data"), None)
    # the state defs name JAX's ZeRO axis; the port holds the state whole
    assert specs[1]["params"]["embed"]["tok"]["mu"] == (None, None)

    dec = ShapeConfig("d", "decode", 128, 512)
    params, cache, tokens = abstract_serve_args(cfg, dec, mesh)
    assert tokens.shape == (1,) and cache["pos"].shape == (1,)
    assert cache["pos"].dtype == torch.int32
    assert cache["blocks"]["k"].shape[:3] == (cfg.n_layers, 1, 128)
    pre = ShapeConfig("p", "prefill", 128, 32)           # replicated
    params, batch = abstract_serve_args(cfg, pre, mesh)
    assert batch["tokens"].shape == (32, 128)
    assert abstract_cache(cfg, dec, mesh)["pos"].shape == (1,)
    assert abstract_params(cfg, mesh)["embed"]["tok"].device.type == "meta"
    # the frontend inputs the enc-dec and vlm steps need
    train = ShapeConfig("t", "train", 1024, 512)
    sm = get_arch("seamless-m4t-large-v2")
    assert input_specs(sm, train, mesh)["frames"].shape \
        == (1, 1024, sm.frontend_dim)
    lv = get_arch("llava-next-34b")
    spec = input_specs(lv, train, mesh)
    assert spec["tokens"].shape == (1, 1024 - lv.n_image_tokens)
    assert spec["image_embeds"].shape == (1, lv.n_image_tokens,
                                          lv.frontend_dim)


def _flat(tree, prefix=""):
    """A nested dict's leaves by their '/'-joined keys."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _j_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): x for path, x in flat}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_step_specs_and_stand_ins_equal_jax_on_a_host_mesh(arch):
    """On JAX's one-device host mesh, where every batch dim divides the
    ``data`` axis: ``train_shardings`` and ``serve_shardings`` give JAX's
    specs leaf by leaf (the optimizer state's with JAX's ZeRO axis
    dropped: the port holds the state whole), and ``abstract_params``,
    ``abstract_cache`` and ``input_specs`` JAX's shapes and dtypes (a
    device's local shape is the global one on one device)."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from repro.models import registry as j_registry
    from repro.models import steps as j_steps
    from repro_torch.models.steps import serve_shardings
    jm, tm = j_host_mesh(), make_host_mesh()
    jc, tc = J_ARCHS[arch], get_arch(arch)
    shapes = {kind: (JShape(kind, kind, 1024, 4),
                     ShapeConfig(kind, kind, 1024, 4))
              for kind in ("train", "prefill", "decode")}

    def same_specs(j_tree, t_tree, drop_zero_of=None):
        jl, tl = _j_flat(j_tree), _flat(t_tree)
        assert sorted(jl) == sorted(tl)
        for path, spec in tl.items():
            want = tuple(jl[path].spec)
            if drop_zero_of is not None:      # the port's whole state
                d = drop_zero_of[path]
                want = tuple(j_shardings.resolve(
                    tuple(None if a == "zero" else a for a in d.logical),
                    d.shape, jm))
            assert tuple(spec) == want, path

    js, ts = shapes["train"]
    jt = j_steps.train_shardings(jc, js, jm, JOpt())
    tt = train_shardings(tc, ts, tm, OptConfig())
    same_specs(jt[0], tt[0])
    same_specs(jt[2], tt[2])
    odefs = j_leaves(j_opt_defs(j_build(jc).param_defs(), JOpt()))
    same_specs(jt[1], tt[1], drop_zero_of=odefs)
    for kind in ("prefill", "decode"):
        js, ts = shapes[kind]
        jv, tv = (j_steps.serve_shardings(jc, js, jm),
                  serve_shardings(tc, ts, tm))
        assert len(jv) == len(tv)
        for j_tree, t_tree in zip(jv, tv):
            if isinstance(t_tree, dict):
                same_specs(j_tree, t_tree)
            else:                             # the decode step's tokens
                assert tuple(t_tree) == tuple(j_tree.spec)

    def same_stand_ins(j_tree, t_tree):
        jl, tl = _j_flat(j_tree), _flat(t_tree)
        assert sorted(jl) == sorted(tl)
        for path, t in tl.items():
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(jl[path].shape), path
            assert str(t.dtype).split(".")[-1] == str(jl[path].dtype), path

    same_stand_ins(j_registry.abstract_params(jc, jm),
                   abstract_params(tc, tm))
    js, ts = shapes["decode"]
    same_stand_ins(j_registry.abstract_cache(jc, js, jm),
                   abstract_cache(tc, ts, tm))
    for kind in ("train", "decode"):
        js, ts = shapes[kind]
        same_stand_ins(j_registry.input_specs(jc, js, jm),
                       input_specs(tc, ts, tm))
