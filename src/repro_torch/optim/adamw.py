"""AdamW with dtype knobs, masks and global clipping (``repro.optim.adamw``).

The state is a tree shaped like the params, ``{"m", "v", "step"}`` with
``step`` an int32 scalar, so a ``(params, opt_state)`` checkpoint has the
reference's key paths (``1/m/...``, ``1/v/...``, ``1/step``).

Masks, by the leaf's ``/``-joined key path, as the reference writes them:
  * frozen: ``"rope_inv"`` in the path (rope frequency tables). No update,
    but their gradients still enter the global norm;
  * decayed: more than one dimension and none of ``embed``, ``pos``,
    ``cls`` in the path (a stacked norm scale ``(reps, D)`` is decayed).

Every update runs in float32 and is cast back to the leaf's dtype (bf16
params included); ``m_dtype="bfloat16"`` halves the first moment.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.interop import flatten, map_tree, unflatten_like

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    m_dtype: str = "float32"
    v_dtype: str = "float32"


def _frozen(path: str) -> bool:
    return "rope_inv" in path


def _decayed(path: str, leaf) -> bool:
    if leaf.ndim <= 1:
        return False
    if "embed" in path or "pos" in path or "cls" in path:
        return False
    return True


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()):
    def zeros(dtype):
        return map_tree(lambda p: torch.zeros(p.shape, dtype=dtype,
                                              device=p.device), params)
    dev = next(iter(flatten(params).values())).device
    return {"m": zeros(_DTYPES[cfg.m_dtype]), "v": zeros(_DTYPES[cfg.v_dtype]),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in flatten(tree).values()))


@torch.no_grad()
def adamw_update(params, grads, state, lr, cfg: AdamWConfig = AdamWConfig()):
    """Returns (new_params, new_state, {"grad_norm"}). ``grads`` has the
    params' tree; ``lr`` a float or a float32 0-d tensor. New tensors
    throughout: nothing given is modified."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm > 0 else 1.0
    step = state["step"] + 1
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    flat_g, flat_m, flat_v = (flatten(t) for t in (grads, state["m"],
                                                   state["v"]))
    new_p, new_m, new_v = {}, {}, {}
    for path, p in flatten(params).items():
        m, v = flat_m[path], flat_v[path]
        if _frozen(path):
            new_p[path], new_m[path], new_v[path] = p, m, v
            continue
        gf = flat_g[path].float() * scale
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(gf)
        upd = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        if cfg.weight_decay > 0 and _decayed(path, p):
            upd = upd + cfg.weight_decay * p.float()
        new_p[path] = (p.float() - lr * upd).to(p.dtype)
        new_m[path] = mf.to(m.dtype)
        new_v[path] = vf.to(v.dtype)
    return (unflatten_like(params, new_p),
            {"m": unflatten_like(params, new_m),
             "v": unflatten_like(params, new_v), "step": step},
            {"grad_norm": gnorm})
