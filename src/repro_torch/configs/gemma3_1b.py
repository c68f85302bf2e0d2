"""gemma3-1b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

Copied from ``repro.configs.gemma3_1b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="lm",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_head=256,
    d_ff=6912,
    vocab_size=262144,
    act="gelu",
    mlp_kind="glu",
    qk_norm=True,
    pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
    sliding_window=512,
    rope_theta=1e6,
    rope_theta_local=1e4,
    tie_embeddings=True,
)
