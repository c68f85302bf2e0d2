"""Plain PyTorch attention (``repro.kernels.flash_attention.ref``) and its
gradient.

Materialises the full (T, S) logits in fp32: GQA, causal with right-aligned
queries, sliding window or none, masked logits -1e30. ``attention_bwd`` is
the plain version of the backward kernel: the gradient recomputed from the
logsumexp (``logsumexp``), as the kernel computes it.
"""
from __future__ import annotations

import math

import torch


def attention(q, k, v, *, causal: bool = True, window=None, scale=None):
    """q: (B,T,H,dq), k: (B,S,Hkv,dq), v: (B,S,Hkv,dv) -> (B,T,H,dv)."""
    B, T, H, dq = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dq)
    logits, _ = _logits(q, k, causal, window, scale)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bngts,bsnv->btngv", w, v.float())
    return o.reshape(B, T, H, -1).to(q.dtype)


def _mask(T: int, S: int, causal: bool, window, device):
    """(T, S) bool: the keys each query row sees (right-aligned queries:
    row t sits at position t + S - T)."""
    qi = torch.arange(T, device=device)[:, None] + (S - T)
    ki = torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    return mask


def _logits(q, k, causal, window, scale):
    """-> fp32 logits (B, Hkv, g, T, S), masked entries -1e30, and the
    mask."""
    B, T, H, dq = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, dq).float()
    logits = torch.einsum("btngq,bsnq->bngts", qg, k.float()) * scale
    mask = _mask(T, S, causal, window, q.device)
    return torch.where(mask, logits, torch.full_like(logits, -1e30)), mask


def logsumexp(q, k, *, causal: bool = True, window=None, scale=None):
    """(B, H, T) fp32: the natural-log logsumexp over keys of each query
    row's scaled, masked logits (what the forward kernel writes beside
    o)."""
    B, T, H, dq = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dq)
    logits, _ = _logits(q, k, causal, window, scale)
    return torch.logsumexp(logits, dim=-1).reshape(B, H, T)


def attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, window=None,
                  scale=None):
    """Gradient of ``attention`` at (q, k, v) given its output ``o``, the
    logsumexp ``lse`` (B, H, T) and the output's gradient ``do`` -> (dq,
    dk, dv) in q's dtype. fp32 throughout: P = exp(S - lse) on the visible
    keys, D = rowsum(dO o), dS = P (dO V^T - D), dq = scale dS K, dk =
    scale dS^T Q, dv = P^T dO, the group's heads summed into their kv
    head. A masked entry takes P = 0, so a row with no visible key gets
    zero gradients (autograd through ``attention`` would give that row's
    uniform weights to dv)."""
    B, T, H, dq = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(dq)
    logits, mask = _logits(q, k, causal, window, scale)
    lg = lse.float().reshape(B, Hkv, g, T)[..., None]
    p = torch.where(mask, torch.exp(logits - lg), torch.zeros_like(logits))
    dog = do.reshape(B, T, Hkv, g, -1).float()
    delta = (do.float() * o.float()).sum(-1).reshape(B, T, Hkv, g)
    dp = torch.einsum("btngv,bsnv->bngts", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    qg = q.reshape(B, T, Hkv, g, dq).float()
    dq_ = torch.einsum("bngts,bsnq->btngq", ds, k.float()) * scale
    dk = torch.einsum("bngts,btngq->bsnq", ds, qg) * scale
    dv = torch.einsum("bngts,btngv->bsnv", p, dog)
    return (dq_.reshape(B, T, H, dq).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
