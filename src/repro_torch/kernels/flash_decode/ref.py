"""Plain PyTorch single-token decode attention
(``repro.kernels.flash_decode.ref``): GQA over a masked cache, fp32 math,
masked logits -1e30."""
from __future__ import annotations

import torch


def decode_attention(q, k, v, valid, scale: float):
    """q: (B,H,dq); k/v: (B,S,Hkv,d); valid: (B,S) -> (B,H,dv) in q's
    dtype."""
    B, H, dq = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, dq).float()
    logits = torch.einsum("bngq,bsnq->bngs", qg, k.float()) * scale
    logits = logits.masked_fill(~valid.bool()[:, None, None, :], -1e30)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bngs,bsnv->bngv", w, v.float())
    return o.reshape(B, H, -1).to(q.dtype)
