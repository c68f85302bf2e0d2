"""internvl2-26b [vlm] — InternViT frontend (stub) + InternLM2-20B backbone.
[arXiv:2404.16821; hf]

Copied from ``repro.configs.internvl2_26b``. The modality frontend is a
stub: a batch carries precomputed patch embeddings, which the model
prepends to the token stream.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="lm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=92553,
    act="silu",
    mlp_kind="glu",
    rope_theta=1e6,
    frontend="patch_stub",
)
