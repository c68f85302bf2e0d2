"""Prunable-unit discovery, copied from ``repro.core.units`` (numpy-only).

Every family and layout is discovered as in the JAX package; the
statistics and folds cover every unit kind: mlp (shared experts and the
``first_k_dense`` layers' ``dense_d_ff`` included), rwkv_mlp, moe (routed
experts), mamba (inner channels), attn units of every class, mla and the
enc-dec's class-1 cross units, stacked or unrolled.

CORP operates on two kinds of structured units (paper §3.2) plus two
framework extensions:

  mlp      - hidden channels between the two MLP matrices (Alg. 2/3)
  attn     - per-head Q/K dimensions (Alg. 4/5); 'mla' prunes the nope block;
             'cross' covers enc-dec cross attention
  moe      - per-expert MLP hidden channels (expert-conditional statistics)
  rwkv_mlp - RWKV channel-mix hidden channels (structurally an MLP)
  mamba    - Mamba inner channels (beyond-paper; see DESIGN.md)

Compensator classes for attention (DESIGN.md §2.2 / repro.core.solve):
  1 full M (SVD fold)            - no rope, no qk-norm (paper-faithful)
  2 diag-complex per rotary pair - rope, no qk-norm
  3 diag-real per rotary pair    - rope + qk-norm (folds into norm scales)
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Unit:
    name: str             # "seg0/p0/mlp" etc. (diagnostic)
    seg: str              # segment param key: "seg0" | "enc" | "dec"
    layer_key: str        # "p0" | "l3"
    stacked: bool
    reps: int
    kind: str             # mlp | moe | rwkv_mlp | mamba | attn | mla | cross
    tap_prefix: str       # tap key prefix "seg0/p0"
    # attention metadata
    attn_class: int = 1
    n_groups: int = 1     # kv heads (M solved per group)
    q_per_group: int = 1
    # mlp metadata
    d_hidden: int = 0     # full hidden dim (per expert for moe)
    param_key: str = "mlp"  # block sub-key holding the unit's params
    shared_expert: bool = False


def attn_class(cfg: ModelConfig, kind: str) -> int:
    if kind in ("mla", "cross"):
        return 1
    uses_rope = cfg.family == "lm" and cfg.rwkv is None and cfg.mla is None
    if not uses_rope:
        return 1
    return 3 if cfg.qk_norm else 2


def discover_units(cfg: ModelConfig) -> List[Unit]:
    units: List[Unit] = []

    def block_units(seg, lk, stacked, reps, kind, is_moe, prefix,
                    cross=False):
        # mixer unit
        if kind in ("attn", "swa"):
            if cfg.mla is not None:
                units.append(Unit(f"{prefix}/mla", seg, lk, stacked, reps,
                                  "mla", prefix, attn_class=1,
                                  n_groups=cfg.n_heads, q_per_group=1,
                                  param_key="mixer"))
            else:
                units.append(Unit(f"{prefix}/attn", seg, lk, stacked, reps,
                                  "attn", prefix,
                                  attn_class=attn_class(cfg, kind),
                                  n_groups=cfg.n_kv_heads,
                                  q_per_group=cfg.q_per_kv,
                                  param_key="mixer"))
        elif kind == "mamba":
            units.append(Unit(f"{prefix}/mamba", seg, lk, stacked, reps,
                              "mamba", prefix,
                              d_hidden=cfg.mamba.expand * cfg.d_model,
                              param_key="mixer"))
        if cross:
            units.append(Unit(f"{prefix}/cross", seg, lk, stacked, reps,
                              "cross", prefix, attn_class=1,
                              n_groups=cfg.n_kv_heads,
                              q_per_group=cfg.q_per_kv, param_key="cross"))
        # mlp unit
        if kind == "rwkv":
            units.append(Unit(f"{prefix}/rwkv_mlp", seg, lk, stacked, reps,
                              "rwkv_mlp", prefix, d_hidden=cfg.d_ff,
                              param_key="mlp"))
        elif is_moe:
            units.append(Unit(f"{prefix}/moe", seg, lk, stacked, reps,
                              "moe", prefix, d_hidden=cfg.moe.d_expert,
                              param_key="mlp"))
            if cfg.moe.num_shared > 0:
                units.append(Unit(f"{prefix}/shared", seg, lk, stacked, reps,
                                  "mlp", prefix,
                                  d_hidden=cfg.moe.num_shared
                                  * cfg.moe.d_expert,
                                  param_key="mlp", shared_expert=True))
        else:
            dff = cfg.d_ff
            if cfg.moe is not None and cfg.dense_d_ff:
                dff = cfg.dense_d_ff
            units.append(Unit(f"{prefix}/mlp", seg, lk, stacked, reps,
                              "mlp", prefix, d_hidden=dff, param_key="mlp"))

    if cfg.family == "vit":
        block_units("seg0", "p0", True, cfg.n_layers, "attn", False,
                    "seg0/p0")
        return units
    if cfg.family == "encdec":
        block_units("enc", "p0", True, cfg.n_enc_layers, "attn", False,
                    "enc/p0")
        block_units("dec", "p0", True, cfg.n_layers, "attn", False,
                    "dec/p0", cross=True)
        return units
    # lm
    for si, seg in enumerate(cfg.layout()):
        name = f"seg{si}"
        if seg[0] == "unroll":
            for j, li in enumerate(seg[1]):
                kind, moe = cfg.layer_spec(li)
                block_units(name, f"l{j}", False, 1, kind, moe,
                            f"{name}/l{j}")
        else:
            _, reps, idxs = seg
            for j, li in enumerate(idxs):
                kind, moe = cfg.layer_spec(li)
                block_units(name, f"p{j}", True, reps, kind, moe,
                            f"{name}/p{j}")
    return units


def get_block(params, unit: Unit):
    return params[unit.seg][unit.layer_key][unit.param_key]


def set_block(params, unit: Unit, value):
    params[unit.seg][unit.layer_key] = dict(
        params[unit.seg][unit.layer_key], **{unit.param_key: value})
