"""Calibration statistics for CORP (``repro.core.stats``), class-1 path.

Two streaming passes over the unlabeled calibration set:

  pass 1: per MLP unit the moments n, s1 = sum_t x_t, s2 = sum_t x_t x_t^T
    and the activity counts na (fp32), through the gram kernel; per
    attention unit the logit-energy ranking statistic
      rank_j = sum_b (sum_{t,h} q_{t,j}^2)(sum_t k_{t,j}^2)   per kv group.
  pass 2: given the kept index sets from ranking, the ridge system inputs
    of paper Eq. 15 for class-1 (no rope, no qk-norm) attention units:
      G = sum_b (Q_S^T Q_S) (x) (K_S^T K_S),  h = sum_b vec((Q_S^T Q_P)(K_P^T K_S)),
      t2 = sum_b ||Q_P K_P^T||_F^2.

Every statistic is a sum over samples, accumulated in fp32. The layer-stacked
taps (leading layer axis) are reduced for all layers at once: one gram
launch covers every layer of a unit. Rope classes 2/3, MoE, Mamba and the
one-traversal reductions are not ported yet; they raise.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.core.units import Unit
from repro_torch.kernels.gram import ops as gram_ops

ACTIVE_EPS = 1e-2   # |x| > eps counts as 'active' (appendix E ranking)


def _moments(x):
    """x: (L, N, F) -> dict(n (L,), s1 (L,F), s2 (L,F,F), na (L,F)), fp32.

    X^T X and the column sums go through the gram kernel in x's own dtype,
    every layer in one launch."""
    g = gram_ops.gram(x)
    L, N = x.shape[0], x.shape[1]
    return {"n": torch.full((L,), float(N), dtype=torch.float32,
                            device=x.device),
            "s1": g["s1"],
            "s2": g["s2"],
            "na": (x.abs() > ACTIVE_EPS).sum(dim=-2, dtype=torch.float32)}


def _group_q(q, n_groups):
    """(L, B, T, H, d) -> (L, B, G, T*qpg, d): stack group queries along
    tokens."""
    L, B, T, H, d = q.shape
    qpg = H // n_groups
    return q.reshape(L, B, T, n_groups, qpg, d).permute(0, 1, 3, 2, 4, 5) \
        .reshape(L, B, n_groups, T * qpg, d)


def _check_attn(unit: Unit):
    if unit.attn_class != 1 or unit.kind != "attn" or not unit.stacked:
        raise NotImplementedError(
            f"attention unit {unit.name} (kind {unit.kind}, class "
            f"{unit.attn_class}) is not ported; see repro.core.stats._p2_attn")


# ---------------------------------------------------------------------------
# pass 1
# ---------------------------------------------------------------------------

def _p1_mlp(taps, unit: Unit):
    h = taps[f"{unit.tap_prefix}/h"]                  # (L, B, T, F)
    return _moments(h.reshape(h.shape[0], -1, h.shape[-1]))


def _p1_attn(taps, unit: Unit):
    _check_attn(unit)
    q = taps[f"{unit.tap_prefix}/q"].float()          # (L, B, T, H, d)
    k = taps[f"{unit.tap_prefix}/k"].float()          # (L, B, T, Hkv, d)
    qg = _group_q(q, unit.n_groups)                   # (L, B, G, TQ, d)
    kg = k.permute(0, 1, 3, 2, 4)                     # (L, B, G, T, d)
    eq = qg.square().sum(dim=3)                       # (L, B, G, d)
    ek = kg.square().sum(dim=3)
    L, B = q.shape[0], q.shape[1]
    return {"rank": (eq * ek).sum(dim=1),
            "n": torch.full((L,), float(B), dtype=torch.float32,
                            device=q.device)}


# ---------------------------------------------------------------------------
# pass 2 (class-1 attention compensation inputs)
# ---------------------------------------------------------------------------

def _take(x, idx):
    """x: (B, G, T, d), idx: (G, n) -> (B, G, T, n)."""
    B, G, T, _ = x.shape
    return torch.gather(x, 3, idx[None, :, None, :].expand(B, G, T,
                                                          idx.shape[-1]))


def _p2_layer(qg, kg, keep, prune):
    """One layer. qg (B, G, TQ, d), kg (B, G, T, d); keep (G, ds),
    prune (G, dp) -> {G (G, ds^2, ds^2), h (G, ds^2), t2 (G,)}.

    G[i, l, j, k] = sum_b A_ss[b, i, j] C_ss[b, l, k] is contracted over b
    inside the einsum (a matmul over the batch axis), so no per-sample
    (B, ds, ds, ds, ds) product is ever formed."""
    qS, qP = _take(qg, keep), _take(qg, prune)
    kS, kP = _take(kg, keep), _take(kg, prune)
    A_ss = torch.einsum("bgts,bgtu->gbsu", qS, qS)
    C_ss = torch.einsum("bgts,bgtu->gbsu", kS, kS)
    A_sp = torch.einsum("bgts,bgtp->gbsp", qS, qP)
    C_ps = torch.einsum("bgtp,bgts->gbps", kP, kS)
    n_g, ds = keep.shape
    G_mat = torch.einsum("gbij,gblk->giljk", A_ss, C_ss) \
        .reshape(n_g, ds * ds, ds * ds)
    h_vec = torch.einsum("gbsp,gbpu->gsu", A_sp, C_ps).reshape(n_g, -1)
    t2 = torch.einsum("bgtp,bgup->bgtu", qP, kP).square().sum(dim=(0, 2, 3))
    return {"G": G_mat, "h": h_vec, "t2": t2}


def _p2_attn(taps, unit: Unit, keep, prune):
    """keep/prune: int64 tensors (L, G, ds) / (L, G, dp) of kept / pruned
    dims -> {G (L, G, ds^2, ds^2), h (L, G, ds^2), t2 (L, G)}."""
    _check_attn(unit)
    q = taps[f"{unit.tap_prefix}/q"].float()
    k = taps[f"{unit.tap_prefix}/k"].float()
    qg = _group_q(q, unit.n_groups)
    kg = k.permute(0, 1, 3, 2, 4)
    per_layer = [_p2_layer(qg[i], kg[i], keep[i], prune[i])
                 for i in range(q.shape[0])]
    return {key: torch.stack([s[key] for s in per_layer])
            for key in per_layer[0]}


# ---------------------------------------------------------------------------
# per-batch reductions over every unit
# ---------------------------------------------------------------------------

def pass1_reduce(taps: Dict, units: List[Unit]) -> Dict:
    """Per-batch pass-1 sums: mlp -> {n, s1, s2, na}; attn -> {rank, n}."""
    out = {}
    for u in units:
        if u.kind == "mlp" and u.stacked:
            out[u.name] = _p1_mlp(taps, u)
        elif u.kind == "attn":
            out[u.name] = _p1_attn(taps, u)
        else:
            raise NotImplementedError(
                f"unit {u.name} of kind {u.kind} is not ported; see "
                f"repro.core.stats.pass1_reduce")
    return out


def pass2_reduce(taps: Dict, units: List[Unit], plan: Dict) -> Dict:
    out = {}
    for u in units:
        if u.kind in ("attn", "mla", "cross") and u.name in plan:
            keep, prune = plan[u.name]
            out[u.name] = _p2_attn(taps, u, keep, prune)
    return out


def tree_add(a, b):
    """a + b leafwise; ``a`` is updated in place (it is the running
    accumulator, and its largest leaf, pass 2's G, is hundreds of MB at
    DeiT-Base), ``None`` starts a new one."""
    if a is None:
        return b
    for k, v in b.items():
        if isinstance(v, dict):
            tree_add(a[k], v)
        else:
            a[k].add_(v)
    return a
