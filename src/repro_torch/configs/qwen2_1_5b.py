"""qwen2-1.5b [dense] — GQA with QKV bias. [arXiv:2407.10671; hf]

Copied from ``repro.configs.qwen2_1_5b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="lm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab_size=151936,
    act="silu",
    mlp_kind="glu",
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
)
