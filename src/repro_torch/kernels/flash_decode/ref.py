"""Plain PyTorch single-token decode attention
(``repro.kernels.flash_decode.ref``): GQA over a masked cache, fp32 math,
masked logits -1e30.

A row whose ``valid`` is all false gives 0, as the Pallas kernel
(``flash_decode.py:38-41`` zeroes masked weights) and this port's CUDA
kernel do. The JAX ref gives the mean of V for such a row (its softmax
over logits that are all -1e30 is uniform): here the port parts from the
JAX ref, so that its result does not depend on the device."""
from __future__ import annotations

import torch


def decode_attention(q, k, v, valid, scale: float):
    """q: (B,H,dq); k/v: (B,S,Hkv,d); valid: (B,S) -> (B,H,dv) in q's
    dtype; 0 for a row with no valid key."""
    B, H, dq = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    valid = valid.bool()
    qg = q.reshape(B, Hkv, g, dq).float()
    logits = torch.einsum("bngq,bsnq->bngs", qg, k.float()) * scale
    logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
    w = torch.softmax(logits, dim=-1) * valid.any(-1)[:, None, None, None]
    o = torch.einsum("bngs,bsnv->bngv", w, v.float())
    return o.reshape(B, H, -1).to(q.dtype)
