"""Config registry: one module per assigned language-model architecture,
plus the paper's own MNIST deep-belief network (copies of
``repro.configs``)."""
from __future__ import annotations

from .base import (ArchConfig, ServeConfig, ShapeConfig, SHAPES,  # noqa: F401
                   supports, reduced)

from . import (  # noqa: E402
    starcoder2_7b,
    command_r_plus_104b,
    qwen2_0_5b,
    minitron_4b,
    dbrx_132b,
    deepseek_v2_236b,
    seamless_m4t_large_v2,
    llava_next_34b,
    recurrentgemma_2b,
    mamba2_780m,
    mnist_dbn,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        starcoder2_7b,
        command_r_plus_104b,
        qwen2_0_5b,
        minitron_4b,
        dbrx_132b,
        deepseek_v2_236b,
        seamless_m4t_large_v2,
        llava_next_34b,
        recurrentgemma_2b,
        mamba2_780m,
    )
}

MNIST_DBN = mnist_dbn.CONFIG


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]
