"""The port stands alone: no jax, nothing of ``repro``, and its verbatim
copies of framework-free ``repro`` modules stay equal to their originals.

* importing ``repro_torch`` and every module of it in a fresh interpreter
  leaves ``jax`` and ``repro`` out of ``sys.modules``;
* no file of ``src/repro_torch``, nor ``chip_smoke.py``, nor an
  ``examples/*_torch.py`` demo imports them;
* each copied module's top-level definitions, imports aside, have the same
  AST as the original's, apart from the few listed as deliberately changed,
  added in the port, or left out of it (``ADDED`` / ``ABSENT``); and the
  JAX definitions that have no counterpart in the port on purpose (the
  HLO walker of ``launch/hlo_cost.py``, whose counterpart
  ``launch/op_cost.py`` counts eager ops instead) are named.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
ORIG = SRC / "repro"

# copied module -> (original, definitions that differ on purpose, whether
# the copy holds every definition of the original)
ARCH_FILES = ["command_r_plus_104b", "dbrx_132b", "deepseek_v2_236b",
              "llava_next_34b", "mamba2_780m", "minitron_4b", "qwen2_0_5b",
              "recurrentgemma_2b", "seamless_m4t_large_v2", "starcoder2_7b",
              "mnist_dbn"]
COPIES = {
    "configs/base.py": ("configs/base.py",
                        {"ServeConfig.__post_init__"}, True),
    "models/cache_spec.py": ("models/cache_spec.py", set(), True),
    "serving/radix_cache.py": ("serving/radix_cache.py", set(), True),
    "serving/scheduler.py": ("serving/scheduler.py", set(), True),
    "serving/speculate.py": ("serving/speculate.py", set(), True),
    "serving/telemetry.py": ("serving/telemetry.py",
                             {"Tracer.__doc__", "Tracer.__init__",
                              "Tracer.annotate"}, True),
    "serving/admission.py": ("serving/admission.py", set(), True),
    "serving/faults.py": ("serving/faults.py", set(), True),
    "serving/server.py": ("serving/server.py",
                          {"ServingLoop._engine_main"}, True),
    "launch/trace_report.py": ("launch/trace_report.py", set(), True),
    "data/synthetic_mnist.py": ("data/synthetic_mnist.py", set(), True),
    "data/dedup.py": ("data/dedup.py", set(), True),
    "data/pipeline.py": ("data/pipeline.py", set(), True),
    "runtime/elastic.py": ("runtime/elastic.py", {"restore_on_mesh"}, True),
    **{f"configs/{a}.py": (f"configs/{a}.py", set(), True)
       for a in ARCH_FILES},
    "models/shardings.py": ("models/shardings.py", {"tree_specs"}, True),
    "launch/analysis.py": ("launch/analysis.py",
                           {"roofline", "collective_summary"}, True),
}
# definitions a copy adds (no counterpart in the original), by their
# top-level name: the mesh and spec the planning functions read
ADDED = {
    "models/shardings.py": {"MeshSpec", "Mesh", "PartitionSpec", "P"},
    "launch/analysis.py": {"LINK_BW", "wire_factor", "link"},
}
# the original's definitions with no counterpart in the port, on purpose:
# the eager port has no jit to constrain and no HLO to parse, and
# ``DPGroups`` stands for a mesh's data axes
ABSENT = {
    "models/shardings.py": {"shard_map_compat", "make_mesh_compat", "named",
                            "constrain"},
    "launch/analysis.py": {"_DTYPE_BYTES", "_COLL", "_LINE_RE", "_GROUPS_RE",
                           "_GROUPS_IOTA_RE", "_SHAPE_RE", "_nelems",
                           "parse_collectives"},
}
# JAX modules whose port is a new design, not a copy: (the port's
# counterpart, the JAX definitions it has no counterpart of)
REDESIGNED = {
    "launch/hlo_cost.py": ("launch/op_cost.py", {
        "_SHAPE_RE", "_DEF_RE", "_COMP_RE", "_OPERAND_RE", "_WHILE_RE",
        "_TRIP_RE", "_CALLS_RE", "_CONST_RE", "_CONTRACT_RE", "_GROUPS_RE",
        "_GROUPS_IOTA_RE", "_COLLECTIVES", "_shape_bytes", "_shape_elems",
        "Op", "Computation", "parse_module", "_trip_count",
        "_collective_wire", "_fusion_flops", "_dot_flops", "_comp_cost",
        "module_cost"}),
}


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_repro():
    mods = list(_port_modules())
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
              "print(len(sys.modules)); assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(mods) > 20


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "examples").glob("*_torch.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def _defs(path: Path):
    """name -> ast dump of each top-level definition (functions, classes,
    assignments), imports and the module docstring left out; classes also
    list their methods and docstring as ``Class.member``."""
    out = {}
    body = ast.parse(path.read_text()).body
    for i, node in enumerate(body):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if i == 0 and isinstance(node, ast.Expr):
            continue                                   # module docstring
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            name = node.name
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            target = (node.targets[0] if isinstance(node, ast.Assign)
                      else node.target)
            name = (target.id if isinstance(target, ast.Name)
                    else ast.dump(target))
        else:
            name = ast.dump(node)
        if isinstance(node, ast.ClassDef):
            for j, sub in enumerate(node.body):
                if j == 0 and isinstance(sub, ast.Expr):
                    key = f"{name}.__doc__"
                elif isinstance(sub, ast.FunctionDef):
                    key = f"{name}.{sub.name}"
                else:
                    key = f"{name}.#{j}"
                out[key] = ast.dump(sub)
            node = ast.ClassDef(node.name, node.bases, node.keywords, [],
                                node.decorator_list)
        out[name] = ast.dump(node)
    return out


@pytest.mark.parametrize("copy", sorted(COPIES))
def test_copied_modules_do_not_drift(copy):
    orig, changed, full = COPIES[copy]
    mine, theirs = _defs(PORT / copy), _defs(ORIG / orig)
    added, absent = ADDED.get(copy, set()), ABSENT.get(copy, set())
    for name, dump in mine.items():
        if name.split(".")[0] in added:
            assert name.split(".")[0] not in theirs, f"{name} is in repro"
            continue
        if name in changed:
            assert dump != theirs.get(name), f"{name} no longer differs"
            continue
        assert name in theirs, f"{copy}: {name} is not in repro/{orig}"
        assert dump == theirs[name], f"{copy}: {name} drifted from repro"
    if full:
        missing = set(theirs) - set(mine)
        assert missing == absent, f"{copy} lacks {sorted(missing - absent)}"


@pytest.mark.parametrize("orig", sorted(REDESIGNED))
def test_redesigned_modules_name_what_they_leave_out(orig):
    port, absent = REDESIGNED[orig]
    mine, theirs = _defs(PORT / port), _defs(ORIG / orig)
    assert absent <= set(theirs), sorted(absent - set(theirs))
    assert not absent & set(mine), sorted(absent & set(mine))
