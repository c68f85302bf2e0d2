"""Transformer block (``repro.models.blocks``): norm -> attention -> norm
-> dense MLP, pre-norm residual. Mamba, RWKV, MoE and cross-attention
blocks are not ported yet; they raise."""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import apply_norm, init_norm, merge_taps


def _check(kind: str, is_moe: bool):
    if kind not in ("attn", "swa") or is_moe:
        raise NotImplementedError(
            f"block kind={kind!r} is_moe={is_moe} is not ported; see "
            f"repro.models.blocks.apply_block")


def init_block(gen: torch.Generator, cfg, kind: str = "attn",
               is_moe: bool = False):
    _check(kind, is_moe)
    return {"ln1": init_norm(cfg),
            "mixer": attn_mod.init_attn(gen, cfg, kind),
            "ln2": init_norm(cfg),
            "mlp": mlp_mod.init_mlp(gen, cfg)}


def apply_block(p, x, cfg, kind: str = "attn", is_moe: bool = False, *,
                taps=None, mask_kind="causal"):
    """Full-sequence block. Returns x after both residual sub-layers."""
    _check(kind, is_moe)
    t = {} if taps is not None else None
    h = apply_norm(p["ln1"], x, cfg)
    x = x + attn_mod.apply_attn(p["mixer"], h, cfg, kind, taps=t,
                                mask_kind=mask_kind)
    h = apply_norm(p["ln2"], x, cfg)
    x = x + mlp_mod.apply_mlp(p["mlp"], h, cfg, taps=t)
    if taps is not None:
        merge_taps(taps, t, "")
    return x
