"""Mamba2-780M [arXiv:2405.21060; unverified] — attention-free SSD (state-space duality)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,                # attention-free
    n_kv_heads=0,
    d_ff=0,                   # no separate MLP; SSD block carries the capacity
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_n_groups=1,
    conv_width=4,
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2405.21060; state-spaces/mamba2-780m",
)
