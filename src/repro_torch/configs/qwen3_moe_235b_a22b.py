"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B; hf]

Copied from ``repro.configs.qwen3_moe_235b_a22b``.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="lm",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,             # per-expert hidden (assigned)
    vocab_size=151936,
    act="silu",
    mlp_kind="glu",
    qk_norm=True,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536, num_shared=0,
                  capacity_factor=1.25),
    moe_every=1,
    rope_theta=1e6,
)
