"""Plain PyTorch attention (``repro.kernels.flash_attention.ref``).

Materialises the full (T, S) logits in fp32: GQA, causal with right-aligned
queries, sliding window or none, masked logits -1e30.
"""
from __future__ import annotations

import math

import torch


def attention(q, k, v, *, causal: bool = True, window=None, scale=None):
    """q: (B,T,H,dq), k: (B,S,Hkv,dq), v: (B,S,Hkv,dv) -> (B,T,H,dv)."""
    B, T, H, dq = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(dq)
    qg = q.reshape(B, T, Hkv, g, dq).float()
    logits = torch.einsum("btngq,bsnq->bngts", qg, k.float()) * scale
    qi = torch.arange(T, device=q.device)[:, None] + (S - T)
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bngts,bsnv->btngv", w, v.float())
    return o.reshape(B, T, H, -1).to(q.dtype)
