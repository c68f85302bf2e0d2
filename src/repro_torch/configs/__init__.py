"""Config registry of the port: the DeiT ids, the LMs it serves and prunes
(``qwen2-1.5b``, ``granite-8b``, ``deepseek-7b``, ``gemma3-1b``,
``rwkv6-3b``, the VLM ``internvl2-26b``, the routed MoE
``qwen3-moe-235b-a22b``, the MLA MoE ``deepseek-v3-671b`` and the Mamba
hybrid ``jamba-1.5-large-398b``), the encoder-decoder
``seamless-m4t-large-v2`` and their reduced variants.

Copied from ``repro.configs``.
"""
from __future__ import annotations

import importlib

import dataclasses
import math

from repro_torch.configs.base import (MambaConfig, MLAConfig, ModelConfig,
                                      MoEConfig, RWKVConfig)

DEIT_IDS = ("deit-tiny", "deit-small", "deit-base", "deit-large", "deit-huge")
_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "granite-8b": "granite_8b",
    "deepseek-7b": "deepseek_7b",
    "gemma3-1b": "gemma3_1b",
    "rwkv6-3b": "rwkv6_3b",
    "internvl2-26b": "internvl2_26b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}
LM_IDS = tuple(_MODULES)
ENCDEC_IDS = ("seamless-m4t-large-v2",)
_MODULES["seamless-m4t-large-v2"] = "seamless_m4t_large_v2"


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in DEIT_IDS:
        from repro_torch.configs import deit
        return getattr(deit, arch_id.upper().replace("-", "_"))
    if arch_id in _MODULES:
        return importlib.import_module(
            f"repro_torch.configs.{_MODULES[arch_id]}").CONFIG
    raise KeyError(
        f"unknown arch id {arch_id!r}; known: "
        f"{DEIT_IDS + LM_IDS + ENCDEC_IDS}")


def reduced(cfg: ModelConfig, *, d_model: int = 64,
            layers_scale: int = 1) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests, as
    ``repro.configs.reduced`` gives it for a ViT, a dense LM, RWKV, a
    routed MoE (4 experts, top 2, d_expert 2 d_model, at most one shared
    expert), MLA with its ``first_k_dense`` layers (one dense layer of
    4 d_model more), a Mamba hybrid (d_state 4, d_conv 4, expand 2) or an
    enc-dec (2 encoder layers)."""
    period = len(cfg.pattern)
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe_every)
    n_layers = max(period, 2) * layers_scale + (1 if cfg.first_k_dense
                                                else 0)
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, n_heads * cfg.n_kv_heads // cfg.n_heads)
    n_heads = n_kv * max(1, n_heads // n_kv)
    kw = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=16,
        d_ff=4 * d_model if cfg.moe is None else 2 * d_model,
        vocab_size=min(cfg.vocab_size, 503) if cfg.vocab_size else 0,
        sliding_window=8,
        dtype="float32",
        vocab_round=8,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_expert=2 * d_model,
            num_shared=min(cfg.moe.num_shared, 1))
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_dim=16, qk_rope_dim=8, v_dim=16)
    if cfg.mamba is not None:
        kw["mamba"] = MambaConfig(d_state=4, d_conv=4, expand=2)
    if cfg.rwkv is not None:
        kw.update(rwkv=RWKVConfig(head_dim=16, decay_lora=8),
                  n_heads=d_model // 16, n_kv_heads=d_model // 16)
    if cfg.first_k_dense:
        kw.update(first_k_dense=1, dense_d_ff=4 * d_model)
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = 2
    if cfg.family == "vit":
        kw.update(img_size=32, patch=8, n_classes=min(cfg.n_classes, 10) or 10)
    return cfg.replace(name=cfg.name + "-reduced", **kw)


def resolve_config(name: str) -> ModelConfig:
    """``deit-base`` or ``qwen2-1.5b-reduced`` -> config."""
    if name.endswith("-reduced"):
        return reduced(get_config(name[: -len("-reduced")]))
    return get_config(name)


__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "MambaConfig",
           "DEIT_IDS", "LM_IDS", "ENCDEC_IDS", "get_config", "reduced", "resolve_config"]
