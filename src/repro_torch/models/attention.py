"""Full-sequence attention mixer (``repro.models.attention``), the path a
ViT runs: q/k/v projections with the qkv bias, the attention kernel, the
output projection. Taps ``q`` (B,T,H,dq) and ``k`` (B,T,Hkv,dq) feed the
CORP logit statistics.

Not ported yet: rope, qk-norm, MLA, cross attention and decode; they raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.common import dense_init, dtype_of, tap


def _unported(cfg):
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported; see "
                                  "repro.models.attention._apply_mla")
    if cfg.qk_norm:
        raise NotImplementedError("qk-norm is not ported; see "
                                  "repro.models.common.rms_head_norm")
    if cfg.family == "lm" and cfg.rwkv is None:
        raise NotImplementedError("rope attention is not ported; see "
                                  "repro.models.attention._rope_gathered")


def init_attn(gen: torch.Generator, cfg, kind: str = "attn"):
    _unported(cfg)
    dt = dtype_of(cfg)
    D, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dq, dv = cfg.eff_qk, cfg.d_head
    p = {
        "wq": dense_init(gen, (D, H, dq), dt),
        "wk": dense_init(gen, (D, Hkv, dq), dt),
        "wv": dense_init(gen, (D, Hkv, dv), dt),
        "wo": dense_init(gen, (H, dv, D), dt, scale=1.0 / math.sqrt(H * dv)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H, dq)
        p["bk"] = torch.zeros(Hkv, dq)
        p["bv"] = torch.zeros(Hkv, dv)
    return p


def _project_qkv(p, x, cfg, taps):
    """Q/K/V projection + bias (fp32-stored, cast to x's dtype) + tap."""
    dt = x.dtype
    q = torch.einsum("btd,dhq->bthq", x, p["wq"])
    k = torch.einsum("btd,dhq->bthq", x, p["wk"])
    v = torch.einsum("btd,dhv->bthv", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    tap(taps, "q", q)
    tap(taps, "k", k)
    return q, k, v


def apply_attn(p, x, cfg, kind="attn", *, taps=None, mask_kind="causal"):
    """Full-sequence attention. x: (B, T, D); mask_kind 'causal' | 'full'.

    The scale is 1/sqrt(qk_full) even after pruning: the folded weights
    carry the compensation, the logit scale stays the dense model's."""
    _unported(cfg)
    q, k, v = _project_qkv(p, x, cfg, taps)
    window = cfg.sliding_window if (kind == "swa" and mask_kind != "full") \
        else None
    scale = 1.0 / math.sqrt(cfg.qk_full)
    o = flash_ops.attention(q, k, v, causal=(mask_kind != "full"),
                            window=window, scale=scale)
    return torch.einsum("bthv,hvd->btd", o, p["wo"])
