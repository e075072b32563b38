"""RecurrentGemma-2B [arXiv:2402.19427; hf] — Griffin: RG-LRU + local attention, 1:2."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,             # MQA
    head_dim=256,
    d_ff=7680,                # GeGLU expanded width (3 * d_model)
    vocab=256000,
    mlp_gated=True,
    act="gelu",
    qkv_bias=False,
    rope_theta=1e4,
    norm="rmsnorm",
    block_pattern=("rec", "rec", "attn"),   # 1 attention per 2 recurrent blocks
    d_rnn=2560,               # lru width
    conv_width=4,
    attn_window=2048,         # local sliding-window attention
    source="arXiv:2402.19427; hf:google/recurrentgemma-2b",
)
