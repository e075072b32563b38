"""The port's device layouts and the H100's constants: the counterpart of
``repro.launch.mesh`` (TPU v5e pods).

The port runs each process's whole model and spreads only data: the
paper's MapReduce data parallelism over ``pod`` x ``data``
(``core.mapreduce.DPGroups``).  So its production layouts keep the JAX
package's device counts with no ``model`` axis: ``(data=256)`` and
``(pod=2, data=256)``.  ``make_host_mesh`` keeps JAX's signature and
accepts a ``model`` axis > 1, which the dry run plans memory for and then
skips (the port has no tensor-parallel step).  A mesh here is a
``models.shardings.MeshSpec``: a shape, not devices.
"""
from __future__ import annotations

from ..models.shardings import MeshSpec

# NVIDIA H100 SXM5 80GB, per GPU (NVIDIA H100 Tensor Core GPU data sheet;
# dense rates, without structured sparsity)
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 / fp16 tensor cores
PEAK_FLOPS_TF32 = 495e12      # FLOP/s, TF32 tensor cores
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, fp32 without tensor cores (and fp64 TC)
HBM_BW = 3.35e12              # B/s, HBM3
HBM_BYTES = 80e9              # B of HBM3
# DGX H100 layout: 8 GPUs a node joined all to all by NVLink 4 (900 GB/s
# a GPU in both directions), one 400 Gb/s NDR InfiniBand NIC a GPU
NVLINK_BW = 450e9             # B/s a GPU, one direction
NET_BW = 50e9                 # B/s a GPU, one direction (400 Gb/s)
GPUS_PER_NODE = 8


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The port's data-parallel layouts on the JAX package's device
    counts: 256 processes, or 2 pods of 256."""
    if multi_pod:
        return MeshSpec((2, 256), ("pod", "data"))
    return MeshSpec((256,), ("data",))


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1) -> MeshSpec:
    """A small mesh for tests and examples, laid out as JAX's is."""
    axes, shape = [], []
    if pod > 1:
        axes.append("pod"); shape.append(pod)
    axes.append("data"); shape.append(data)
    if model > 1:
        axes.append("model"); shape.append(model)
    return MeshSpec(tuple(shape), tuple(axes))


def mesh_name(mesh: MeshSpec) -> str:
    """``256``, ``2x256``, ``16x16``: the mesh's sizes joined by x."""
    return "x".join(str(n) for n in mesh.dims)
