"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave, MoE
16e top-2. [arXiv:2403.19887; hf]

Copied from ``repro.configs.jamba_1_5_large_398b``. A Jamba block is 8
layers with attention at position 4 (0-indexed) and a MoE MLP on every
other layer (e:2).
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="lm",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,            # per-expert hidden (assigned)
    vocab_size=65536,
    act="silu",
    mlp_kind="glu",
    pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
             "mamba"),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576, num_shared=0,
                  capacity_factor=1.25),
    moe_every=2,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
)
