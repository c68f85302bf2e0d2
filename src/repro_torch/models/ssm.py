"""RWKV-6 (Finch) time mix and channel mix (``repro.models.ssm``, its RWKV
half). Mamba is not ported.

The time mix runs its recurrence through ``kernels.wkv6`` (the CUDA kernel
on the card). When a ``state`` is given (decode), it is updated in place:
the wkv kernel writes the new state over the old one, and the token-shift
rows are copied over; without one (prefill) a fresh state is returned.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.models.common import dense_init, dtype_of, tap


def init_rwkv_time(gen: torch.Generator, cfg):
    dt = dtype_of(cfg)
    D = cfg.d_model
    N = cfg.rwkv.head_dim
    H = D // N
    r = cfg.rwkv.decay_lora

    def half():
        return torch.full((D,), 0.5)

    return {
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
        "mu_g": half(),
        "w0": torch.full((D,), -2.0),
        "w_lora_a": dense_init(gen, (D, r), torch.float32),
        "w_lora_b": torch.randn((r, D), generator=gen) * 1e-2,
        "u": torch.randn((H, N), generator=gen) * 0.1,
        "wr": dense_init(gen, (D, D), dt),
        "wk": dense_init(gen, (D, D), dt),
        "wv": dense_init(gen, (D, D), dt),
        "wg": dense_init(gen, (D, D), dt),
        "wo": dense_init(gen, (D, D), dt, scale=1.0 / math.sqrt(D)),
        "ln_scale": torch.ones(D),
        "ln_bias": torch.zeros(D),
    }


def _shift(x, prev=None):
    """Token shift: x_{t-1} with x_{-1} = prev (or zeros). A new tensor."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def apply_rwkv_time(p, x, cfg, taps=None, state=None):
    """x: (B, T, D). state: {'shift': (B, D), 'wkv': (B, H, N, N) fp32} or
    None. Returns (y, state): the given state updated in place, or a new
    one."""
    B, T, D = x.shape
    N = cfg.rwkv.head_dim
    H = D // N
    xs = _shift(x, None if state is None else state["shift"])
    r = _mix(x, xs, p["mu_r"]) @ p["wr"]
    k = _mix(x, xs, p["mu_k"]) @ p["wk"]
    v = _mix(x, xs, p["mu_v"]) @ p["wv"]
    g = _mix(x, xs, p["mu_g"]) @ p["wg"]
    xw = _mix(x, xs, p["mu_w"]).float()
    # data-dependent decay (the v6 feature), fp32
    dd = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(p["w0"] + dd))

    def hd(z):
        return z.reshape(B, T, H, N)

    s0 = None if state is None else state["wkv"]
    y, s_new = wkv_ops.wkv6(hd(r), hd(k), hd(v), hd(w.to(x.dtype)), p["u"],
                            s0, out_state=s0)
    # per-head group norm in fp32 (population variance, as jnp.var)
    yh = y.float()
    mu = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    y = yh.reshape(B, T, D) * p["ln_scale"] + p["ln_bias"]
    y = (y.to(x.dtype) * F.silu(g)) @ p["wo"]
    if state is None:
        return y, {"shift": x[:, -1].clone(), "wkv": s_new}
    state["shift"].copy_(x[:, -1])
    return y, state


def init_rwkv_channel(gen: torch.Generator, cfg):
    """A pruned config (``d_ff_kept`` set) also gets ``bv_comp``, zeros
    (D,) fp32: the slot for the compensation bias CORP pruning writes, so
    that a pruned checkpoint restores into this template with it. (The
    JAX package's template has no such leaf, and its restore drops it.)"""
    dt = dtype_of(cfg)
    D, Fd = cfg.d_model, cfg.eff_d_ff
    p = {
        "mu_k": torch.full((D,), 0.5),
        "mu_r": torch.full((D,), 0.5),
        "wk": dense_init(gen, (D, Fd), dt),
        "wv": dense_init(gen, (Fd, D), dt),
        "wr": dense_init(gen, (D, D), dt),
    }
    if cfg.d_ff_kept is not None:
        p["bv_comp"] = torch.zeros(D)
    return p


def apply_rwkv_channel(p, x, cfg, taps=None, state=None):
    """RWKV channel mix (the 'MLP'): squared relu, receptance gate. A given
    ``state`` ({'shift': (B, D)}) is updated in place."""
    xs = _shift(x, None if state is None else state["shift"])
    h = F.relu(_mix(x, xs, p["mu_k"]) @ p["wk"]).square()
    tap(taps, "h", h)
    kv = h @ p["wv"]
    if "bv_comp" in p:   # CORP compensation bias (added by pruning)
        kv = kv + p["bv_comp"].to(kv.dtype)
    y = torch.sigmoid(_mix(x, xs, p["mu_r"]) @ p["wr"]) * kv
    if state is None:
        return y, {"shift": x[:, -1].clone()}
    state["shift"].copy_(x[:, -1])
    return y, state


def init_rwkv_state(cfg, batch: int, device):
    """Empty-history state of one layer (``device="meta"``: shapes only)."""
    D = cfg.d_model
    N = cfg.rwkv.head_dim
    H = D // N
    dt = dtype_of(cfg)
    return {
        "time": {"shift": torch.zeros((batch, D), dtype=dt, device=device),
                 "wkv": torch.zeros((batch, H, N, N), dtype=torch.float32,
                                    device=device)},
        "channel": {"shift": torch.zeros((batch, D), dtype=dt,
                                         device=device)},
    }
