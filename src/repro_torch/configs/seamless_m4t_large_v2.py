"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal. [arXiv:2308.11596; hf]

Copied from ``repro.configs.seamless_m4t_large_v2``. The audio frontend is
a stub: the encoder takes precomputed frame embeddings. 24 encoder + 24
decoder layers share the backbone dims.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,           # decoder layers
    n_enc_layers=24,
    cross_attend=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8192,
    vocab_size=256206,
    act="relu2",
    mlp_kind="plain",
    norm_kind="layernorm",
    rope_theta=1e4,
    frontend="frame_stub",
)
