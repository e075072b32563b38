"""DeepSeek-V2 236B [arXiv:2405.04434; hf] — MLA (kv_lora=512) + 2 shared / 160 routed top-6."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,           # MLA: per-assignment annotation; realized via compressed KV
    d_ff=1536,                # routed-expert hidden
    vocab=102400,
    mlp_gated=True,
    act="silu",
    qkv_bias=False,
    rope_theta=1e4,
    norm="rmsnorm",
    # MoE
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1536,
    first_k_dense=1,
    d_ff_dense=12288,
    capacity_factor=1.25,
    # MLA
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2",
)
