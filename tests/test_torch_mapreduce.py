"""The port's MapReduce engine (``repro_torch.core.mapreduce``) on
``torch.distributed`` with the gloo backend, on the CPU.

The paper's correctness claim, as ``tests/test_mapreduce.py`` states it for
the JAX engine: the distributed map/combine/reduce gradient equals the
single-process gradient on the same global batch.  Four processes, two
pods of two, each holding a quarter of the batch in two microbatches:
``allreduce`` and ``hierarchical`` within 1e-5 of the serial gradient (fp32
sums in another order), ``compressed`` (int8 + error feedback across pods)
within 0.05, as the JAX test bounds it.  The same inputs go through the
JAX engine on a 2 x 2 (pod, data) mesh of forced host devices: every
mode's loss and gradients, and the ``compressed`` mode's error-feedback
state of each process, match it within 1e-6 (the int8 codes are the
same, so only the fp32 sums' order differs).  A one-process group runs its
collectives and gives the plain step's numbers bit for bit.  The int8
compression is bit-exact against ``repro.optim.compression``.

The processes meet through a file store and talk over the loopback
interface: nothing resolves a host name.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.core.mapreduce import map_reduce_job  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
JAX_TOL = 1e-6             # the port against the JAX engine, fp32

WORKER = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.finetune import (classifier_init,
                                           make_classifier_step)
    from repro_torch.core.mapreduce import (dp_groups, mapreduce_value_and_grad,
                                            value_and_grad)
    from repro_torch.models.params import tree_leaves, tree_map

    rank, world, store, n_pod = sys.argv[1:5]
    rank, world, n_pod = int(rank), int(world), int(n_pod)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    groups = dp_groups(n_pod)

    def loss_fn(params, batch):
        y = batch["x"] @ params["w"] + params["b"]
        return torch.mean(torch.square(y - batch["y"])), {}

    rng = np.random.RandomState(0)
    params = {"w": torch.from_numpy(rng.randn(16, 4).astype(np.float32)),
              "b": torch.zeros(4)}
    batch = {"x": torch.from_numpy(rng.randn(32, 16).astype(np.float32)),
             "y": torch.from_numpy(rng.randn(32, 4).astype(np.float32))}
    ref_l, _, ref_g = value_and_grad(loss_fn, params, batch)
    n = 32 // world
    shard = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    out = {}
    for mode in ("allreduce", "hierarchical", "compressed"):
        mr = mapreduce_value_and_grad(loss_fn, groups, reduce_mode=mode,
                                      n_micro=2)
        loss, grads, err, _ = mr(params, shard, None)
        out[mode] = {
            "loss_err": float(abs(loss - ref_l)),
            "grad_err": max(float((grads[k] - ref_g[k]).abs().max())
                            for k in grads),
            "err_state": err is not None,
            "loss": float(loss),
            "grads": {k: g.tolist() for k, g in grads.items()},
            "err": None if err is None else {k: e.tolist()
                                             for k, e in err.items()}}
    if world == 1:
        # a fine-tuning step through the one-process group vs the plain one
        gen = torch.Generator().manual_seed(1)
        stack = [{"W": 0.1 * torch.randn(16, 8, generator=gen),
                  "bh": torch.zeros(8)}]
        p0 = classifier_init(stack, 4, gen)
        vel0 = tree_map(torch.zeros_like, p0)
        b = {"x": batch["x"], "y": torch.arange(32) % 4}
        pa, va, la, _ = make_classifier_step(None, lr=0.5)(p0, vel0, b)
        pb, vb, lb, _ = make_classifier_step(groups, lr=0.5)(p0, vel0, b)
        out["plain_step_bit_equal"] = all(
            torch.equal(x, y) for (_, x), (_, y) in zip(
                tree_leaves([pa, va, la]), tree_leaves([pb, vb, lb])))
    dist.destroy_process_group()
    print("RESULT" + json.dumps(out))
""")


# The JAX engine on the same inputs: a (pod, data) = (2, 2) mesh, the
# batch sharded over both axes, so device (p, d) holds process p * 2 + d's
# shard; each device's own error-feedback state is read from its shard.
JAX_WORKER = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.core.mapreduce import mapreduce_value_and_grad
    from repro.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data=2, pod=2)
    rank_of = {dev: p * 2 + d for (p, d), dev in np.ndenumerate(mesh.devices)}

    def loss_fn(params, batch):
        y = batch["x"] @ params["w"] + params["b"]
        return jnp.mean(jnp.square(y - batch["y"])), {}

    rng = np.random.RandomState(0)
    params = {"w": jnp.asarray(rng.randn(16, 4).astype(np.float32)),
              "b": jnp.zeros((4,), jnp.float32)}
    batch = {"x": jnp.asarray(rng.randn(32, 16).astype(np.float32)),
             "y": jnp.asarray(rng.randn(32, 4).astype(np.float32))}
    out = {}
    for mode in ("allreduce", "hierarchical", "compressed"):
        mr = mapreduce_value_and_grad(loss_fn, mesh, reduce_mode=mode,
                                      n_micro=2)
        err = jax.tree.map(jnp.zeros_like, params) \\
            if mode == "compressed" else None
        loss, grads, new_err, _ = jax.jit(mr)(params, batch, err)
        out[mode] = {
            "loss": float(loss),
            "grads": {k: np.asarray(g).tolist() for k, g in grads.items()},
            "err": None if new_err is None else {
                k: {rank_of[s.device]: np.asarray(s.data).tolist()
                    for s in e.addressable_shards}
                for k, e in new_err.items()}}
    print("RESULT" + json.dumps(out))
""")


from _torch_common import one_thread  # noqa: E402, F401


def _result(stdout: str) -> dict:
    line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["GLOO_SOCKET_IFNAME"] = "lo"
    return env


def run_workers(world: int, n_pod: int) -> list:
    env = _env()
    store = os.path.join(tempfile.mkdtemp(prefix="mapreduce-"), "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), store,
         str(n_pod)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stderr[-2000:]
            outs.append(_result(stdout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(os.path.dirname(store), ignore_errors=True)
    return outs


@pytest.fixture(scope="module")
def two_pods_of_two():
    return run_workers(4, 2)


@pytest.fixture(scope="module")
def jax_two_pods_of_two():
    env = _env()
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", JAX_WORKER],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return _result(proc.stdout)


@pytest.mark.parametrize("mode", ["allreduce", "hierarchical"])
def test_distributed_grad_equals_serial(two_pods_of_two, mode):
    for out in two_pods_of_two:
        assert out[mode]["loss_err"] < 1e-5, out
        assert out[mode]["grad_err"] < 1e-5, out


def test_compressed_grad_close_to_serial(two_pods_of_two):
    for out in two_pods_of_two:
        # int8 quantization: bounded error, not exact
        assert out["compressed"]["loss_err"] < 1e-5, out
        assert out["compressed"]["grad_err"] < 0.05, out
        assert out["compressed"]["err_state"], out


@pytest.mark.parametrize("mode", ["allreduce", "hierarchical", "compressed"])
def test_reduce_modes_match_jax(two_pods_of_two, jax_two_pods_of_two, mode):
    """Each process's loss and reduced gradients, and in ``compressed``
    mode its own error-feedback state, against the JAX engine's device
    holding the same shard."""
    want = jax_two_pods_of_two[mode]
    for rank, out in enumerate(two_pods_of_two):
        got = out[mode]
        assert abs(got["loss"] - want["loss"]) <= JAX_TOL, (rank, mode)
        for k in want["grads"]:
            np.testing.assert_allclose(got["grads"][k], want["grads"][k],
                                       atol=JAX_TOL, rtol=0,
                                       err_msg=f"rank {rank} grads {k}")
        if mode == "compressed":
            for k in want["err"]:
                np.testing.assert_allclose(
                    got["err"][k], want["err"][k][str(rank)], atol=JAX_TOL,
                    rtol=0, err_msg=f"rank {rank} error feedback {k}")
        else:
            assert got["err"] is None and want["err"] is None


def test_one_process_group_step_equals_the_plain_step():
    out = run_workers(1, 1)[0]
    assert out["plain_step_bit_equal"], out
    for mode in ("allreduce", "hierarchical"):
        assert out[mode]["grad_err"] < 1e-5, out    # two microbatches


def test_map_reduce_job_without_a_group_is_plain_eval():
    job = map_reduce_job(lambda p, b: {"s": torch.sum(b["x"] * p)},
                         None, reduce="mean")
    assert float(job(2.0, {"x": torch.arange(4.0)})["s"]) == 12.0


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096 + 17])
def test_int8_compression_bit_exact_against_jax(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n) * rng.choice([1e-3, 1.0, 30.0], size=n)) \
        .astype(np.float32)
    if n > 300:
        x[256:512] = 0.0                         # an all-zero block
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    shape = (n,) if n % 5 else (5, n // 5)
    np.testing.assert_array_equal(
        tcomp.dequantize_int8(tq, ts, shape, torch.float32).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, shape, jnp.float32)))
    err = (0.01 * rng.randn(n)).astype(np.float32)
    jd, je, jw = jcomp.ef_compress(jnp.asarray(x), jnp.asarray(err))
    td, te, tw = tcomp.ef_compress(torch.from_numpy(x), torch.from_numpy(err))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert tw == int(jw)


def test_compress_tree_round_trip_matches_jax():
    rng = np.random.RandomState(3)
    tree = {"W": [rng.randn(30, 20).astype(np.float32)],
            "b": rng.randn(7).astype(np.float32)}
    jt = jcomp.decompress_tree(jcomp.compress_tree(
        jax.tree.map(jnp.asarray, tree)), jax.tree.map(jnp.asarray, tree))
    tt = tcomp.decompress_tree(tcomp.compress_tree(
        {"W": [torch.from_numpy(tree["W"][0])], "b": torch.from_numpy(
            tree["b"])}), {"W": [torch.from_numpy(tree["W"][0])],
                           "b": torch.from_numpy(tree["b"])})
    np.testing.assert_array_equal(tt["W"][0].numpy(), np.asarray(jt["W"][0]))
    np.testing.assert_array_equal(tt["b"].numpy(), np.asarray(jt["b"]))
