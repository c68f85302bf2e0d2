"""Transformer block (``repro.models.blocks``): norm -> attention -> norm
-> dense MLP, pre-norm residual; full-sequence and one-token decode. Mamba,
RWKV, MoE and cross-attention blocks are not ported yet; they raise."""
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
                positions=None, taps=None, mask_kind="causal"):
    """Full-sequence block. Returns x after both residual sub-layers."""
    _check(kind, is_moe)
    t = {} if taps is not None else None
    h = apply_norm(p["ln1"], x, cfg)
    y, _ = attn_mod.apply_attn(p["mixer"], h, cfg, kind, positions=positions,
                               taps=t, mask_kind=mask_kind)
    x = x + y
    h = apply_norm(p["ln2"], x, cfg)
    x = x + mlp_mod.apply_mlp(p["mlp"], h, cfg, taps=t)
    if taps is not None:
        merge_taps(taps, t, "")
    return x


def init_block_cache(cfg, kind: str, batch: int, max_len: int, device):
    _check(kind, False)
    return attn_mod.init_cache(cfg, kind, batch, max_len, device)


def decode_block(p, x, cache, cfg, kind: str = "attn", is_moe: bool = False):
    """One-token decode. x: (B,1,D); ``cache`` is updated in place.
    Returns (x, cache)."""
    _check(kind, is_moe)
    h = apply_norm(p["ln1"], x, cfg)
    y, cache = attn_mod.decode_attn(p["mixer"], h, cache, cfg, kind)
    x = x + y
    h = apply_norm(p["ln2"], x, cfg)
    return x + mlp_mod.apply_mlp(p["mlp"], h, cfg), cache
