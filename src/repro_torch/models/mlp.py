"""Dense MLP mixer (``repro.models.mlp``; MoE is not ported yet).

CORP integration: the tap ``h`` is the activation entering the second
linear map, so one hidden channel is one structured unit.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, dense_init, dtype_of, tap


def init_mlp(gen: torch.Generator, cfg, d_ff=None, bias=None):
    """A pruned config (``d_ff_kept`` set) without biases still gets
    ``bd``, zeros (D,) fp32: the slot for the compensation bias CORP
    pruning writes, so that a pruned checkpoint restores into this template
    with it. (The JAX package's template has no such leaf, and its restore
    drops it.)"""
    dt = dtype_of(cfg)
    D = cfg.d_model
    F = d_ff if d_ff is not None else cfg.eff_d_ff
    bias = cfg.mlp_kind == "plain" if bias is None else bias
    if cfg.mlp_kind == "glu":
        p = {"wg": dense_init(gen, (D, F), dt),
             "wu": dense_init(gen, (D, F), dt),
             "wd": dense_init(gen, (F, D), dt)}
    else:
        p = {"wu": dense_init(gen, (D, F), dt),
             "wd": dense_init(gen, (F, D), dt)}
    if bias:
        p["bu"] = torch.zeros(F)
        p["bd"] = torch.zeros(D)
        if cfg.mlp_kind == "glu":
            p["bg"] = torch.zeros(F)
    elif cfg.d_ff_kept is not None:
        p["bd"] = torch.zeros(D)
    return p


def apply_mlp(p, x, cfg, taps=None):
    """x: (..., D) -> (..., D). Biases are stored fp32 and cast to the
    activation dtype before they are added."""
    act = activation(cfg.act)
    dt = x.dtype
    u = x @ p["wu"]
    if "bu" in p:
        u = u + p["bu"].to(dt)
    if "wg" in p:
        gpre = x @ p["wg"]
        if "bg" in p:
            gpre = gpre + p["bg"].to(dt)
        h = act(gpre) * u
    else:
        h = act(u)
    tap(taps, "h", h)
    y = h @ p["wd"]
    if "bd" in p:
        y = y + p["bd"].to(dt)
    return y
