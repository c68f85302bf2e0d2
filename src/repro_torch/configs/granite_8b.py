"""granite-8b [dense] — llama-arch code model. [arXiv:2405.04324; hf]

Copied from ``repro.configs.granite_8b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="lm",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=49152,
    act="silu",
    mlp_kind="glu",
    rope_theta=1e4,
    tie_embeddings=True,
)
