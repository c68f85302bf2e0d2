"""Plain PyTorch RWKV-6 recurrence (``repro.kernels.wkv6.ref``): the exact
sequential scan, all in fp32.

Per head with state S (N x N):
    y_t = r_t^T (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
"""
from __future__ import annotations

import torch


def wkv6(r, k, v, w, u, state=None):
    """r, k, v, w: (B, T, H, N); u: (H, N); ``state``: optional (B, H, N, N)
    initial state. Returns (y (B, T, H, N) in r's dtype, final state fp32).
    """
    B, T, H, N = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    S = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    ys = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S
