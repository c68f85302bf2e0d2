"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]

Copied from ``repro.configs.rwkv6_3b``. CORP QK pruning is inapplicable
(no QK bilinear logits); MLP (channel-mix) pruning applies.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="lm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # 2560 / head_dim 64
    n_kv_heads=40,
    d_head=64,
    d_ff=8960,
    vocab_size=65536,
    act="relu2",           # channel-mix uses squared ReLU
    mlp_kind="plain",
    norm_kind="layernorm",
    pattern=("rwkv",),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
)
