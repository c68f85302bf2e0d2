"""Block assembly (``repro.models.blocks``): norm -> mixer -> norm -> MLP,
pre-norm residual; full-sequence and one-token decode. The mixer is
attention (``attn``/``swa``, MLA when ``cfg.mla``) or the Mamba SSM
(``mamba``), with a dense or routed-MoE MLP, or the RWKV-6 time mix with
its channel mix (``rwkv``). The ``first_k_dense`` layers of a MoE config
take a dense MLP of ``dense_ff`` hidden channels. An enc-dec decoder
block (``cross=True``) adds a cross-attention sub-layer (``ln_cross``,
``cross``) between the mixer and the MLP, whose taps it renames
``cross_q``/``cross_k``."""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import apply_norm, init_norm, merge_taps


def _check(kind: str):
    if kind not in ("attn", "swa", "mamba", "rwkv"):
        raise ValueError(f"unknown block kind {kind!r}")


def ffn(p, h, cfg, is_moe: bool, taps=None):
    """The block's MLP: routed experts or a dense MLP."""
    if is_moe:
        return mlp_mod.apply_moe(p, h, cfg, taps=taps)
    return mlp_mod.apply_mlp(p, h, cfg, taps=taps)


def init_block(gen: torch.Generator, cfg, kind: str = "attn",
               is_moe: bool = False, dense_ff: int | None = None,
               cross: bool = False):
    """``dense_ff``: the hidden dim of a dense MLP other than
    ``cfg.eff_d_ff`` (a ``first_k_dense`` layer's); ``cross``: an enc-dec
    decoder block."""
    _check(kind)
    if kind == "rwkv":
        return {"ln1": init_norm(cfg),
                "mixer": ssm_mod.init_rwkv_time(gen, cfg),
                "ln2": init_norm(cfg),
                "mlp": ssm_mod.init_rwkv_channel(gen, cfg)}
    p = {"ln1": init_norm(cfg),
         "mixer": ssm_mod.init_mamba(gen, cfg) if kind == "mamba"
         else attn_mod.init_attn(gen, cfg, kind),
         "ln2": init_norm(cfg),
         "mlp": mlp_mod.init_moe(gen, cfg) if is_moe
         else mlp_mod.init_mlp(gen, cfg, d_ff=dense_ff)}
    if cross:
        p["ln_cross"] = init_norm(cfg)
        p["cross"] = attn_mod.init_attn(gen, cfg, "attn", cross=True)
    return p


def rwkv_block(p, x, cfg, state=None, taps=None):
    """RWKV block: ln1 -> time mix -> residual -> ln2 -> channel mix ->
    residual. ``state`` ({"time", "channel"}) is read and updated in place
    (decode); without one a fresh state is returned (prefill).
    Returns (x, state)."""
    state = state or {}
    h = apply_norm(p["ln1"], x, cfg)
    y, st = ssm_mod.apply_rwkv_time(p["mixer"], h, cfg, taps=taps,
                                    state=state.get("time"))
    x = x + y
    h = apply_norm(p["ln2"], x, cfg)
    y, sc = ssm_mod.apply_rwkv_channel(p["mlp"], h, cfg, taps=taps,
                                       state=state.get("channel"))
    return x + y, {"time": st, "channel": sc}


def apply_block(p, x, cfg, kind: str = "attn", is_moe: bool = False, *,
                positions=None, taps=None, mask_kind="causal", mem=None):
    """Full-sequence block. Returns x after its residual sub-layers; a
    decoder block attends the encoder memory ``mem`` (B, S, D)."""
    _check(kind)
    t = {} if taps is not None else None
    if kind == "rwkv":
        x, _ = rwkv_block(p, x, cfg, taps=t)
    else:
        h = apply_norm(p["ln1"], x, cfg)
        if kind == "mamba":
            y, _ = ssm_mod.apply_mamba(p["mixer"], h, cfg, taps=t)
        else:
            y, _ = attn_mod.apply_attn(p["mixer"], h, cfg, kind,
                                       positions=positions, taps=t,
                                       mask_kind=mask_kind)
        x = x + y
        if "cross" in p and mem is not None:
            x = x + cross_sublayer(p, x, mem, cfg, t)
        h = apply_norm(p["ln2"], x, cfg)
        x = x + ffn(p["mlp"], h, cfg, is_moe, taps=t)
    if taps is not None:
        merge_taps(taps, t, "")
    return x


def cross_sublayer(p, x, mem, cfg, taps=None):
    """ln_cross -> cross attention to ``mem``; its taps go into ``taps``
    as ``cross_q``/``cross_k``. Returns the residual update."""
    tc = {} if taps is not None else None
    h = apply_norm(p["ln_cross"], x, cfg)
    y = attn_mod.apply_cross_attn(p["cross"], h, mem, cfg, taps=tc)
    if taps is not None:
        taps.update({"cross_" + k: v for k, v in tc.items()})
    return y


def init_block_cache(cfg, kind: str, batch: int, max_len: int, device):
    _check(kind)
    if kind == "rwkv":
        return ssm_mod.init_rwkv_state(cfg, batch, device)
    if kind == "mamba":
        return ssm_mod.init_mamba_state(cfg, batch, device)
    return attn_mod.init_cache(cfg, kind, batch, max_len, device)


def decode_block(p, x, cache, cfg, kind: str = "attn", is_moe: bool = False,
                 *, cross_cache=None):
    """One-token decode. x: (B,1,D); ``cache`` is updated in place; a
    decoder block attends its memory K/V ``cross_cache``. Returns (x,
    cache)."""
    _check(kind)
    if kind == "rwkv":
        return rwkv_block(p, x, cfg, state=cache)
    h = apply_norm(p["ln1"], x, cfg)
    if kind == "mamba":
        y, cache = ssm_mod.apply_mamba(p["mixer"], h, cfg, state=cache)
    else:
        y, cache = attn_mod.decode_attn(p["mixer"], h, cache, cfg, kind)
    x = x + y
    if "cross" in p and cross_cache is not None:
        h = apply_norm(p["ln_cross"], x, cfg)
        x = x + attn_mod.decode_cross_attn(p["cross"], h, cross_cache, cfg)
    h = apply_norm(p["ln2"], x, cfg)
    return x + ffn(p["mlp"], h, cfg, is_moe), cache
