"""Config registry: one module per assigned language-model architecture
(copies of ``repro.configs``; the paper's MNIST DBN config arrives with the
training slice)."""
from __future__ import annotations

from .base import ArchConfig, ServeConfig, reduced  # noqa: F401

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


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
