"""Plain PyTorch RWKV-6 recurrence (``repro.kernels.wkv6.ref``): the exact
sequential scan, all in fp32, and its gradient.

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


def wkv6_bwd(r, k, v, w, u, state, dy, dstate=None):
    """The gradient of ``wkv6(r, k, v, w, u, state)`` given the gradient
    ``dy`` of y and ``dstate`` of the final state (zeros when None) ->
    (dr, dk, dv, dw in r's dtype, du (H, N) fp32, dstate0 (B, H, N, N)
    fp32, or None when ``state`` is None).

    The reverse recurrence in fp32, a token at a time, on the forward's
    states recomputed from ``state`` (never divided back by w). With dS_t
    the gradient of S_t and dS_T = ``dstate``, for t = T .. 1:
        dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t)
        dk_t = dS_t v_t + u r_t (v_t . dy_t)
        dv_t = dS_t^T k_t + (sum_n u r_t k_t) dy_t
        dw_t = rowsum(dS_t * S_{t-1})
        du  += r_t k_t (v_t . dy_t)
        dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T
    and dstate0 = dS_0."""
    B, T, H, N = r.shape
    rf, kf, vf, wf, dyf = (x.float() for x in (r, k, v, w, dy))
    uf = u.float()
    S = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    starts = []                                 # S_{t-1} for t = 1 .. T
    for t in range(T):
        starts.append(S)
        S = wf[:, t, :, :, None] * S \
            + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    dS = torch.zeros_like(S) if dstate is None else dstate.float()
    dr, dk, dv, dw = (torch.empty((B, T, H, N), dtype=torch.float32,
                                  device=r.device) for _ in range(4))
    du = torch.zeros((H, N), dtype=torch.float32, device=r.device)
    for t in reversed(range(T)):
        rt, kt, vt, wt, dyt = (x[:, t] for x in (rf, kf, vf, wf, dyf))
        vy = (vt * dyt).sum(-1, keepdim=True)           # (B, H, 1)
        dr[:, t] = torch.einsum("bhnm,bhm->bhn", starts[t], dyt) \
            + uf * kt * vy
        dk[:, t] = torch.einsum("bhnm,bhm->bhn", dS, vt) + uf * rt * vy
        dv[:, t] = torch.einsum("bhnm,bhn->bhm", dS, kt) \
            + (uf * rt * kt).sum(-1, keepdim=True) * dyt
        dw[:, t] = (dS * starts[t]).sum(-1)
        du += (rt * kt * vy).sum(0)
        dS = wt[..., None] * dS + rt[..., None] * dyt[..., None, :]
    dt = r.dtype
    return (dr.to(dt), dk.to(dt), dv.to(dt), dw.to(dt), du,
            None if state is None else dS)
