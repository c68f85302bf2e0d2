"""deepseek-7b [dense] — llama-arch (MHA: kv_heads == heads). [arXiv:2401.02954; hf]

Copied from ``repro.configs.deepseek_7b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="lm",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=11008,
    vocab_size=102400,
    act="silu",
    mlp_kind="glu",
    rope_theta=1e4,
)
