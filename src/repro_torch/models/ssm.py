"""Attention-free mixers (``repro.models.ssm``): the RWKV-6 (Finch) time
mix and channel mix, and the Mamba selective SSM.

The time mix runs its recurrence through ``kernels.wkv6`` (the CUDA kernel
on the card). When a ``state`` is given (decode), it is updated in place:
the wkv kernel writes the new state over the old one, and the token-shift
rows are copied over; without one (prefill) a fresh state is returned.

Mamba's scan is jnp in the reference (no Pallas kernel), so it is plain
torch here: sequential over chunks of at most 256 tokens, associative
within a chunk (a log-depth inclusive scan over the (a, b) pairs with the
reference's combiner, products only), and one step for T = 1. The
discretisation (dt, dA, dBx) is made a chunk at a time and never for the
whole sequence. One deliberate difference: the reference takes the largest
divisor of T that is at most 256 as its chunk (1 for a prime T); the port
takes fixed chunks of ``_SCAN_CHUNK`` = 256 and a shorter last one, the same
result up to fp32 reassociation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.models.common import dense_init, dtype_of, tap

_SCAN_CHUNK = 256   # tokens a scan chunk (module docstring)


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
        "w_lora_b": torch.randn((r, D), generator=gen,
                                device=gen.device) * 1e-2,
        "u": torch.randn((H, N), generator=gen, device=gen.device) * 0.1,
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


# ---------------------------------------------------------------------------
# Mamba (selective SSM)
# ---------------------------------------------------------------------------

def _dt_rank(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def init_mamba(gen: torch.Generator, cfg):
    """A pruned config (``d_inner_kept`` set) also gets ``out_b``, zeros
    (D,) fp32: the slot for the compensation bias CORP writes, so that a
    pruned checkpoint restores into this template with it. (The JAX
    package's template has no such leaf, and its restore drops it.)"""
    dt = dtype_of(cfg)
    D = cfg.d_model
    di = cfg.eff_d_inner
    ns = cfg.mamba.d_state
    dc = cfg.mamba.d_conv
    dr = _dt_rank(cfg)
    a = torch.arange(1, ns + 1, dtype=torch.float32)[None].repeat(di, 1)
    p = {
        "in_proj": dense_init(gen, (D, 2 * di), dt),
        "conv_w": dense_init(gen, (dc, di), torch.float32, scale=0.2),
        "conv_b": torch.zeros(di),
        "x_proj": dense_init(gen, (di, dr + 2 * ns), dt),
        "dt_proj": dense_init(gen, (dr, di), torch.float32),
        "dt_bias": torch.full((di,), -4.0),   # softplus ~ small dt
        "a_log": torch.log(a),
        "d_skip": torch.ones(di),
        "out_proj": dense_init(gen, (di, D), dt),
    }
    if cfg.d_inner_kept is not None:
        p["out_b"] = torch.zeros(D)
    return p


def _causal_conv(x, w, b, prev=None):
    """Depthwise causal conv. x: (B, T, di), w: (dc, di), prev: (B, dc-1,
    di). The taps are summed in order in x's dtype, as the reference does.
    Returns (y, the last dc-1 input rows)."""
    dc = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)
    T = x.shape[1]
    y = xp[:, 0:T] * w[0].to(x.dtype)
    for i in range(1, dc):
        y = y + xp[:, i:i + T] * w[i].to(x.dtype)
    return y + b.to(x.dtype), xp[:, -(dc - 1):]


def _inclusive_scan(a, b):
    """Inclusive scan over axis 1 of the pairs (a, b) under the reference's
    combiner (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2): ceil(log2 L)
    out-of-place steps (Hillis-Steele), each writing into the buffers of
    the step before last. Products only: a cumulative-log form overflows
    fp32 at L = 256."""
    L = a.shape[1]
    spare = None
    s = 1
    while s < L:
        a2, b2 = spare if spare is not None else (torch.empty_like(a),
                                                  torch.empty_like(b))
        a2[:, :s] = a[:, :s]
        b2[:, :s] = b[:, :s]
        torch.mul(a[:, s:], a[:, :-s], out=a2[:, s:])
        torch.mul(b[:, :-s], a[:, s:], out=b2[:, s:])
        b2[:, s:] += b[:, s:]
        spare, (a, b) = (a, b), (a2, b2)
        s *= 2
    return a, b


def apply_mamba(p, x, cfg, taps=None, state=None):
    """x: (B, T, D). state: {'conv': (B, dc-1, di), 'ssm': (B, di, ns)
    fp32} or None. Returns (y, state): the given state updated in place
    (decode), or a new one. Taps ``mamba_y``, the gated input of
    ``out_proj``; adds ``out_b`` when present (CORP's compensation
    bias)."""
    B, T, _ = x.shape
    di = p["d_skip"].shape[-1]
    ns = cfg.mamba.d_state
    dr = _dt_rank(cfg)
    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    xc, conv_new = _causal_conv(xi, p["conv_w"], p["conv_b"],
                                None if state is None else state["conv"])
    xc = F.silu(xc)
    A = -torch.exp(p["a_log"])                                # (di, ns)

    def discretize(xc_blk):
        """(B, L, di) -> the chunk's dA, dBx (B, L, di, ns) and C."""
        xdb = xc_blk @ p["x_proj"]
        dt_in, Bs, Cs = (xdb[..., :dr], xdb[..., dr:dr + ns],
                         xdb[..., dr + ns:])
        dts = F.softplus(dt_in.float() @ p["dt_proj"] + p["dt_bias"])
        dA = torch.exp(dts[..., None] * A)
        dBx = (dts * xc_blk.float())[..., None] * Bs.float()[..., None, :]
        return dA, dBx, Cs

    h = torch.zeros((B, di, ns), dtype=torch.float32, device=x.device) \
        if state is None else state["ssm"]
    if T == 1:
        dA, dBx, Cs = discretize(xc)
        h = dA[:, 0] * h + dBx[:, 0]
        y = torch.einsum("bdn,bn->bd", h, Cs[:, 0].float())[:, None]
    else:
        ys = []
        for t0 in range(0, T, _SCAN_CHUNK):
            a, b, Cs = discretize(xc[:, t0:t0 + _SCAN_CHUNK])
            hs, bc = _inclusive_scan(a, b)
            del a, b
            hs.mul_(h[:, None]).add_(bc)                      # (B, L, di, ns)
            del bc
            ys.append(torch.einsum("bldn,bln->bld", hs, Cs.float()))
            h = hs[:, -1].clone()
            del hs
        y = torch.cat(ys, dim=1)
    y = y + p["d_skip"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    tap(taps, "mamba_y", y)
    out = y @ p["out_proj"]
    if "out_b" in p:   # CORP compensation bias (added by pruning)
        out = out + p["out_b"].to(out.dtype)
    if state is None:
        return out, {"conv": conv_new.clone(), "ssm": h}
    state["conv"].copy_(conv_new)
    state["ssm"].copy_(h)
    return out, state


def init_mamba_state(cfg, batch: int, device):
    """Empty-history state of one Mamba layer (``device="meta"``: shapes
    only)."""
    di = cfg.eff_d_inner
    return {
        "conv": torch.zeros((batch, cfg.mamba.d_conv - 1, di),
                            dtype=dtype_of(cfg), device=device),
        "ssm": torch.zeros((batch, di, cfg.mamba.d_state),
                           dtype=torch.float32, device=device),
    }


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
