"""Config registry of the port: the DeiT ids and their reduced variants.

Copied from ``repro.configs``. Only the DeiT family is ported so far; the
LM, MoE, RWKV, Mamba and enc-dec configs raise ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

DEIT_IDS = ("deit-tiny", "deit-small", "deit-base", "deit-large", "deit-huge")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in DEIT_IDS:
        from repro_torch.configs import deit
        return getattr(deit, arch_id.upper().replace("-", "_"))
    raise NotImplementedError(
        f"arch {arch_id!r} is not ported to repro_torch yet (only "
        f"{DEIT_IDS}); its config lives in repro.configs.get_config")


def reduced(cfg: ModelConfig, *, d_model: int = 64,
            layers_scale: int = 1) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (as
    ``repro.configs.reduced`` gives it for a ViT)."""
    if cfg.family != "vit":
        raise NotImplementedError(
            "reduced() of a non-ViT config is not ported; see "
            "repro.configs.reduced")
    n_layers = max(len(cfg.pattern), 2) * layers_scale
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, n_heads * cfg.n_kv_heads // cfg.n_heads)
    n_heads = n_kv * max(1, n_heads // n_kv)
    return cfg.replace(
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=16,
        d_ff=4 * d_model,
        vocab_size=min(cfg.vocab_size, 503) if cfg.vocab_size else 0,
        sliding_window=8,
        dtype="float32",
        vocab_round=8,
        img_size=32,
        patch=8,
        n_classes=min(cfg.n_classes, 10) or 10,
    )


def resolve_config(name: str) -> ModelConfig:
    """``deit-base`` or ``deit-base-reduced`` -> config."""
    if name.endswith("-reduced"):
        return reduced(get_config(name[: -len("-reduced")]))
    return get_config(name)


__all__ = ["ModelConfig", "DEIT_IDS", "get_config", "reduced",
           "resolve_config"]
