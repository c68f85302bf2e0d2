"""DeiT family — the paper's own architectures (Touvron et al. 2021).

Copied from ``repro.configs.deit``. Plain ViT: LayerNorm, GELU two-matrix
MLP, learned positional embeddings, cls token, classification head.
"""
from repro_torch.configs.base import ModelConfig


def _deit(name, n_layers, d_model, n_heads, d_ff, patch=16, img=224,
          n_classes=1000):
    return ModelConfig(
        name=name,
        family="vit",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads,
        d_head=d_model // n_heads,
        d_ff=d_ff,
        vocab_size=0,
        act="gelu",
        mlp_kind="plain",
        qkv_bias=True,
        norm_kind="layernorm",
        frontend="patch_conv",
        n_classes=n_classes,
        img_size=img,
        patch=patch,
        dtype="float32",
    )


DEIT_TINY = _deit("deit-tiny", 12, 192, 3, 768)
DEIT_SMALL = _deit("deit-small", 12, 384, 6, 1536)
DEIT_BASE = _deit("deit-base", 12, 768, 12, 3072)
DEIT_LARGE = _deit("deit-large", 24, 1024, 16, 4096)
DEIT_HUGE = _deit("deit-huge", 32, 1280, 16, 5120, patch=14)

CONFIG = DEIT_BASE
