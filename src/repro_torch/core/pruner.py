"""CORP pipeline (paper Alg. 1, ``repro.core.pruner``): calibrate -> rank ->
compensate -> fold.

``corp_prune(model, params, calib_batches, pc)`` returns ``(pruned_params,
pruned_config, report)``: a physically smaller standard model (reduced d_ff
and per-head qk dims) that the same model code runs. The port covers, on
one device, DeiT and the dense LMs: dense (plain, GLU) MLP units, RWKV
channel mixes (``rwkv_mlp``, compensated through ``wv`` and a ``bv_comp``
bias), class-1 attention units (no rope, no qk-norm) and class-2 ones
(rope: a diagonal complex compensator per kept rotary pair, qkv bias and
rope frequency tables folded alike) and class-3 ones (rope + qk-norm: a
real diagonal per kept pair, folded into the per-head qk-norm scales),
routed-MoE units (each expert's hidden channels with its own ridge
solve, compensated through its ``wd`` and a per-expert ``bd_moe``) and
whole-expert removal (``expert_sparsity``: removed experts' contributions
regressed onto the block input, folded into ``moe_resid`` and
``moe_out_b``), shared experts (an MLP unit on ``mlp/shared``, with its
``bd``), MLA units (class 1 on the nope blocks ``w_uq_nope``/
``w_uk_nope``, one group a head; the rope block is never touched), the
``first_k_dense`` layers' MLPs, Mamba units (the inner channels on the
``mamba_y`` tap, compensated through ``out_proj`` and an ``out_b`` bias;
every channel-wise leaf gathered; ``include_mamba``), stacked units and
unrolled (unstacked) ones; two calibration passes or one
(``one_traversal``), taps streamed in fp32 or bf16, resumable statistics
checkpoints (``ckpt_dir``) and the memory-bounded ``corp_prune_streamed``;
the enc-dec's encoder and decoder units, its cross-attention units
class 1 on ``cross/{wq,wk}`` (a decoder query against memory keys).
``mesh=`` is not ported yet; it raises.

Memory at full width (deepseek-v3 at 4 layers: 30 GB of bf16 weights,
8.6 GB of class-1 G a layer): pass 2 adds its G in place
(``stats._add_kron``); a MoE unit's per-expert s2 accumulates in place a
chunk of experts a batch when it is large (``stats._expert_moments``).
After ranking, the pass-1 moments of every unit but the attention ones
wait in page-locked host memory when pass 2's G and the per-expert s2
would take more than half the card's free memory (``_park_moments``:
deepseek-v3's MLA G; jamba at 2 layers, 38.7 GB of 24576^2 moments beside
24 GB of weights), and each fold copies its moments back, the MoE fold a
chunk of experts at a time. The fold takes the attention units first,
each freeing its statistics as it is folded, and solves class-1 systems
a chunk of groups at a time.

``one_traversal=True`` fuses the two passes: pass 1 also accumulates the
pass-2 sums against top-k candidate keep-sets (``keep_n * (1 +
spec_margin)`` per group, chosen from the first batch's scores); a unit
whose final keep-set lies inside its candidates rebuilds (G, h, t2)
exactly with no second traversal, and the units that escaped take one
targeted pass 2.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.core import calibrate as calib_mod
from repro_torch.core import ranking as rank_mod
from repro_torch.core import solve as solve_mod
from repro_torch.core import stats as stats_mod
from repro_torch.core.units import (Unit, discover_units, get_block,
                                    set_block)
from repro_torch.distrib.fault import CalibrationCheckpointer
from repro_torch.interop import flatten, map_tree


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    mlp_sparsity: float = 0.5
    attn_sparsity: float = 0.5
    expert_sparsity: float = 0.0  # whole routed experts removed
    lam: float = 1e-4            # ridge, relative to mean diagonal
    rank_policy: str = "combined"
    compensate: bool = True      # False = rank-only baseline (paper ablation)
    include_mamba: bool = True   # prune Mamba inner channels (beyond-paper)
    round_to: int = 1            # kept counts rounded down to a multiple


_ATTN_KINDS = ("attn", "mla", "cross")


def _keep_count(full: int, sparsity: float, round_to: int) -> int:
    k = int(round(full * (1.0 - sparsity)))
    if round_to > 1:
        k = max(round_to, (k // round_to) * round_to)
    return max(1, min(full, k))


def _attn_keep_n(u: Unit, full: int, pc: PruneConfig) -> int:
    """Kept dims (cls 1) / rotary pairs (cls 2/3) for an attention unit."""
    rt = pc.round_to if u.attn_class == 1 else max(1, pc.round_to // 2)
    return _keep_count(full, pc.attn_sparsity, rt)


def _host(stats):
    return map_tree(lambda t: t.cpu().numpy(), stats)


def _idx(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# per-unit folding
# ---------------------------------------------------------------------------

def _gather_idx(a, idx, axis: int):
    """Entries of ``a`` at ``idx`` along ``axis``; idx (..., n)'s leading
    dims align with a's outermost ones (one index set per layer, or per
    layer and expert): a (L, ..., F), idx (L, n), axis -1 -> a[l, ...,
    idx[l]]."""
    axis %= a.ndim
    lead = tuple(idx.shape[:-1])
    view = idx.reshape(lead + (1,) * (axis - len(lead)) + idx.shape[-1:]
                       + (1,) * (a.ndim - axis - 1))
    shape = list(a.shape)
    shape[axis] = idx.shape[-1]
    return torch.gather(a, axis, view.expand(shape))


def _ridge_w2(w2, stats, keep_t, prune_t, pc: PruneConfig):
    """The MLP ridge (Eq. 9) of a stacked unit against its second matrix
    w2 (L, F, D): (w2's kept rows, compensated with pc.compensate; the
    compensation bias c W_P (L, D) fp32, or None; the diagnostics). The
    moments are copied to w2's device when they were parked
    (``_park_moments``)."""
    mu, sigma = solve_mod.mlp_cov(_to(stats, w2.device))
    lam = pc.lam * torch.diagonal(sigma, dim1=-2, dim2=-1).mean(dim=-1)
    sol = solve_mod.ridge_affine(mu, sigma, keep_t, prune_t, lam)
    w2_S = solve_mod.gather_rows(w2, keep_t)
    w2_P = solve_mod.gather_rows(w2, prune_t).float()
    diag = solve_mod.mlp_distortion(sol, w2_P)
    if not pc.compensate:
        return w2_S, None, diag
    comp = torch.einsum("rps,rpd->rsd", sol["B"], w2_P)
    bias = torch.einsum("rp,rpd->rd", sol["c"], w2_P)
    return (w2_S.float() + comp).to(w2.dtype), bias, diag


def _fold_mlp_block(p, stats, unit: Unit, pc: PruneConfig, keep, prune,
                    report):
    """Dense MLP or RWKV channel mix of a stacked unit. keep/prune: (L, n)
    index arrays. The compensation goes into the second matrix (``wd``;
    ``wv`` of a channel mix) and its bias: ``bd``, or for a channel mix
    ``bv_comp``, which is added before the receptance gate."""
    w2_key = "wv" if unit.kind == "rwkv_mlp" else "wd"
    new = dict(p)
    keep_t, prune_t = _idx(keep, p[w2_key].device), \
        _idx(prune, p[w2_key].device)
    new[w2_key], bias, diag = _ridge_w2(p[w2_key], stats, keep_t, prune_t,
                                        pc)
    if bias is not None and unit.kind == "rwkv_mlp":
        new["bv_comp"] = bias
    elif bias is not None:
        new["bd"] = p.get("bd", torch.zeros_like(bias)).float() + bias
    for k1 in ("wu", "wg", "wk"):
        if k1 in p:
            new[k1] = _gather_idx(p[k1], keep_t, -1)
    for bk in ("bu", "bg"):
        if bk in p:
            new[bk] = _gather_idx(p[bk], keep_t, -1)
    report[unit.name] = _host(diag)
    return new


def _fold_mamba_block(p, stats, unit: Unit, pc: PruneConfig, keep, prune,
                      report):
    """Inner channels of a stacked Mamba unit (``repro.core.pruner
    ._fold_mamba_block``): the ridge against ``out_proj`` (L, di, D),
    compensated into its kept rows and the bias ``out_b`` (L, D); every
    channel-wise leaf gathered to the kept channels: both halves of
    ``in_proj`` (x and the gate z), ``conv_w``, ``conv_b``, the rows of
    ``x_proj``, ``dt_proj``, ``dt_bias``, ``a_log`` and ``d_skip``. keep /
    prune: (L, n). A pruned channel also leaves ``x_proj``'s input, so dt,
    B and C of the kept channels change, which the ``out_proj`` ridge
    does not see."""
    new = dict(p)
    out = p["out_proj"]                              # (L, di, D)
    di = out.shape[1]
    keep_t, prune_t = _idx(keep, out.device), _idx(prune, out.device)
    new["out_proj"], bias, diag = _ridge_w2(out, stats, keep_t, prune_t, pc)
    if bias is not None:
        new["out_b"] = bias
    new["in_proj"] = _gather_idx(p["in_proj"],
                                 torch.cat([keep_t, keep_t + di], dim=-1), -1)
    for k in ("conv_w", "conv_b", "dt_proj", "dt_bias", "d_skip"):
        new[k] = _gather_idx(p[k], keep_t, -1)
    for k in ("x_proj", "a_log"):
        new[k] = _gather_idx(p[k], keep_t, 1)
    report[unit.name] = _host(diag)
    return new


def _fold_moe_block(p, stats, unit: Unit, pc: PruneConfig, keep, prune,
                    report):
    """Each expert's hidden channels of a stacked MoE unit: experts ``wg``,
    ``wu`` (L, E, D, F), ``wd`` (L, E, F, D), per-expert moments; keep /
    prune (L, E, n). Batched ridge solves over a layer's experts, 16
    experts at a time, fewer when their float64 covariances would pass
    ``stats._MOE_CHUNK`` (one at jamba's 24576: 4.8 GB) (the covariances
    formed in float64 and solved in fp32, as the reference does; at
    deepseek-v3's
    256 experts of 2048 a layer's pruned rows of ``wd`` in fp32 alone are
    7.5 GB); the compensation goes into ``wd`` and ``bd_moe`` (L, E, D),
    which the expert adds to its output before the combine. The moments
    may wait in host memory (``_park_moments``): each chunk of ``s2`` is
    copied to the card as it is solved."""
    new = dict(p)
    wd = p["wd"]
    L, E, F, D = wd.shape
    keep_t, prune_t = _idx(keep, wd.device), _idx(prune, wd.device)
    ds = keep_t.shape[-1]
    wd_new = wd.new_empty((L, E, ds, D))
    bias = torch.zeros((L, E, D), dtype=torch.float32, device=wd.device)
    diags = []
    step = max(1, min(16, stats_mod._MOE_CHUNK // (8 * F * F)))
    cnt, s1 = (stats[k].to(wd.device) for k in ("n", "s1"))
    for l, e in itertools.product(range(L), range(0, E, step)):
        x = slice(e, e + step)
        n = cnt[l, x].double().clamp_min(1.0)[:, None]
        mu = s1[l, x].double() / n
        sigma = stats["s2"][l, x].to(wd.device).double() \
            .div_(n[:, :, None]).sub_(mu[:, :, None] * mu[:, None, :]).float()
        lam = pc.lam * torch.diagonal(sigma, dim1=-2, dim2=-1).mean(dim=-1)
        sol = solve_mod.ridge_affine(mu.float(), sigma, keep_t[l, x],
                                     prune_t[l, x], lam)
        del sigma
        w2_S = solve_mod.gather_rows(wd[l, x], keep_t[l, x])
        w2_P = solve_mod.gather_rows(wd[l, x], prune_t[l, x]).float()
        diags.append(solve_mod.mlp_distortion(sol, w2_P))
        if pc.compensate:
            comp = torch.einsum("rps,rpd->rsd", sol["B"], w2_P)
            wd_new[l, x] = (w2_S.float() + comp).to(wd.dtype)
            bias[l, x] = torch.einsum("rp,rpd->rd", sol["c"], w2_P)
        else:
            wd_new[l, x] = w2_S
    new["wd"] = wd_new
    if pc.compensate:
        new["bd_moe"] = bias
    for k1 in ("wu", "wg"):
        new[k1] = _gather_idx(p[k1], keep_t, -1)
    report[unit.name] = _host({k: torch.cat([d[k] for d in diags])
                               .reshape(L, E) for k in diags[0]})
    return new


def _fold_moe_experts(p, stats, unit: Unit, pc: PruneConfig, keep, prune,
                      report):
    """Whole-expert removal of a stacked MoE unit
    (``repro.core.pruner._fold_moe_experts``), after the hidden-channel
    fold. The regression vector is z_t = [x_t, c_t1..c_tE] (moments yn,
    ys1, ys2): the removed experts' contribution blocks are ridge-regressed
    onto the input block, whose distribution the router's renormalisation
    does not shift. The summed solution folds into ``moe_resid`` (L, D, D)
    and ``moe_out_b`` (L, D), applied after the combine; the kept experts'
    router columns and weights are gathered. keep / prune: (L, n) expert
    indices."""
    new = dict(p)
    wd = p["wd"]
    L, E, _, D = wd.shape
    keep_t, prune_t = _idx(keep, wd.device), _idx(prune, wd.device)
    nP = prune_t.shape[-1]
    ar = torch.arange(D, device=wd.device)
    idx_s = ar.expand(L, D)                               # the input block
    idx_p = ((prune_t + 1)[..., None] * D + ar).reshape(L, nP * D)
    yn, ys1, ys2 = (stats[k].to(wd.device) for k in ("yn", "ys1", "ys2"))
    n = yn.float().clamp_min(1.0)
    mu = ys1 / n[:, None]
    sigma = ys2 / n[:, None, None] \
        - mu[:, :, None] * mu[:, None, :]
    lam = pc.lam * torch.diagonal(sigma, dim1=-2, dim2=-1).mean(dim=-1)
    sol = solve_mod.ridge_affine(mu, sigma, idx_s, idx_p, lam)
    # removed contributions enter the output through the identity (y =
    # sum_e c_te): their "second matrix" is stacked identity blocks
    w_p = torch.eye(D, device=wd.device).repeat(nP, 1).expand(L, -1, -1)
    diag = solve_mod.mlp_distortion(sol, w_p)
    if pc.compensate:
        new["moe_resid"] = sol["B"].reshape(L, nP, D, D).sum(dim=1) \
            .transpose(1, 2).contiguous()                 # y += x @ W
        new["moe_out_b"] = sol["c"].reshape(L, nP, D).sum(dim=1)
    new["router"] = _gather_idx(p["router"], keep_t, 2)
    for k1 in ("wu", "wg", "wd"):
        new[k1] = _gather_idx(new[k1], keep_t, 1)
    if "bd_moe" in new:
        new["bd_moe"] = _gather_idx(new["bd_moe"], keep_t, 1)
    report[unit.name + "/experts"] = _host(diag)
    return new


def _experts_kept(cfg, pc: PruneConfig):
    """Routed experts kept by ``pc.expert_sparsity``, or None when no
    expert is removed."""
    if pc.expert_sparsity <= 0 or cfg.moe is None:
        return None
    keep_n = max(cfg.moe.top_k,
                 _keep_count(cfg.moe.num_experts, pc.expert_sparsity, 1))
    return keep_n if keep_n < cfg.moe.num_experts else None


def _moe_expert_plan(units, p1, cfg, pc: PruneConfig):
    """keep/prune expert index arrays per routed-MoE unit, or {}. Ranking
    reads the contribution blocks' traces of ys2 (host numpy)."""
    keep_n = _experts_kept(cfg, pc)
    if keep_n is None:
        return {}
    return {u.name: rank_mod.rank_experts(
        _host({k: p1[u.name][k] for k in ("yn", "ys2", "n")}), keep_n)
        for u in units if u.kind == "moe"}


def _attn_solve(p2stats, unit: Unit, pc: PruneConfig, L: int, ds: int):
    """Solve every (layer, group) system of an attention unit and fold it.
    Returns the Q and K factors, (L, G, ds, ds) for class 1, per-pair 2x2
    blocks (L, G, ds, 2, 2) for class 2 or per-pair scales (L, G, ds) for
    class 3 (ds kept pairs), and the diagnostics (L, G). Class-1 systems
    (ds^2 wide) are solved ``stats._KRON_CHUNK // ds^4`` at a time, so the
    Cholesky's workspace stays a chunk (16 heads, 2 GB, at MLA's ds 64)."""
    G = unit.n_groups
    t2 = p2stats["t2"].reshape(L * G)
    if unit.attn_class == 1:
        Gm = p2stats["G"].reshape(L * G, ds * ds, ds * ds)
        hv = p2stats["h"].reshape(L * G, ds * ds)
        lam = pc.lam * torch.diagonal(Gm, dim1=-2, dim2=-1).mean(dim=-1)
        step = max(1, stats_mod._KRON_CHUNK // ds ** 4)
        parts = [solve_mod.solve_full_m(Gm[r:r + step], hv[r:r + step],
                                        t2[r:r + step], lam[r:r + step])
                 for r in range(0, L * G, step)]
        sol = {k: torch.cat([part[k] for part in parts]) for k in parts[0]}
        M = sol["M"] if pc.compensate else torch.zeros_like(sol["M"])
        fq, fk = solve_mod.fold_full_m(M)
    else:
        Gm = p2stats["G"].reshape(L * G, ds, ds)
        hv = p2stats["h"].reshape(L * G, ds)
        lam = pc.lam * torch.diagonal(Gm, dim1=-2, dim2=-1).real \
            .mean(dim=-1)
        cls2 = unit.attn_class == 2
        sol = (solve_mod.solve_diag_complex if cls2
               else solve_mod.solve_diag_real)(Gm, hv, t2, lam)
        m = sol["m"] if pc.compensate else torch.zeros_like(sol["m"])
        fq, fk = (solve_mod.fold_diag_complex if cls2
                  else solve_mod.fold_diag_real)(m)
    fq = fq.reshape((L, G) + fq.shape[1:])
    fk = fk.reshape((L, G) + fk.shape[1:])
    diag = {k: sol[k].reshape(L, G) for k in ("j_star", "j_uncomp", "rho2")}
    return fq, fk, diag


def _fold_attn_block(p, p2stats, unit: Unit, pc: PruneConfig, keep, prune,
                     report):
    """QK fold of a stacked attention unit, with the qkv bias. keep/prune:
    (L, G, n) kept / pruned dims per kv group (class 1) or rotary pairs
    (classes 2, 3). Class 1 right-multiplies the kept dims of each group by
    its (ds, ds) factor; class 2 each kept pair's (even, odd) columns by its
    2x2 block; class 3 gathers the kept dims and multiplies its per-pair
    scales (Q: sign(1 + m) sqrt|1 + m|, K: sqrt|1 + m|, each on both dims of
    the pair) into the qk-norm scales, expanded to one row a head. Classes
    2 and 3 gather the kept pairs of the rope frequency tables. An MLA unit
    folds its nope blocks ``w_uq_nope``/``w_uk_nope`` (L, rank, H, nope)
    as class 1, one group a head; it has no bias and no scales to fold."""
    new = dict(p)
    qk, kk = ("w_uq_nope", "w_uk_nope") if unit.kind == "mla" \
        else ("wq", "wk")
    wq, wk = p[qk], p[kk]                            # (L, D, H, dq)
    L = wq.shape[0]
    G, qpg = unit.n_groups, unit.q_per_group
    dq_full = wq.shape[-1]
    keep_t = _idx(keep, wq.device)                   # (L, G, ds)
    fq, fk, diag = _attn_solve(p2stats, unit, pc, L, keep_t.shape[-1])
    if unit.attn_class == 1:
        dim_keep = keep_t

        def mix(wS, f):
            return torch.einsum("ldgqs,lgst->ldgqt", wS, f)
    elif unit.attn_class == 2:
        dim_keep = solve_mod.pairs_to_dims(keep_t)   # (L, G, 2 ds)

        def mix(wS, f):
            pairs = wS.reshape(wS.shape[:-1] + (wS.shape[-1] // 2, 2))
            return torch.einsum("ldgqpi,lgpij->ldgqpj", pairs, f) \
                .reshape(wS.shape)
    else:                        # class 3: the fold goes into the scales
        dim_keep = solve_mod.pairs_to_dims(keep_t)

        def mix(wS, f):
            return wS
    n = dim_keep.shape[-1]

    def fold(w, n_per_group, f):
        # w: (L, D, G*n_per_group, dq) -> gather kept dims per (layer, group),
        # then apply that group's factor
        D = w.shape[1]
        wg = w.reshape(L, D, G, n_per_group, dq_full)
        idx = dim_keep[:, None, :, None, :].expand(L, D, G, n_per_group, n)
        wS = torch.gather(wg, 4, idx).float()
        return mix(wS, f).reshape(L, D, G * n_per_group, n).to(w.dtype)

    new[qk] = fold(wq, qpg, fq)
    new[kk] = fold(wk, 1, fk)
    if "bq" in p:
        # biases are pre-rope additive terms: same gather and fold
        new["bq"] = fold(p["bq"][:, None], qpg, fq)[:, 0].float()
        new["bk"] = fold(p["bk"][:, None], 1, fk)[:, 0].float()
    if "q_scale" in p:

        def scales(s, n_per_group, f):
            # (L, dq) shared by every head -> the kept dims of each head
            # (L, heads, n), class 3's scales folded in
            heads = G * n_per_group
            sg = s[:, None, :].expand(L, heads, dq_full) \
                .reshape(L, G, n_per_group, dq_full)
            idx = dim_keep[:, :, None, :].expand(L, G, n_per_group, n)
            sS = torch.gather(sg, 3, idx).float()
            if unit.attn_class == 3:
                sS = sS * f.repeat_interleave(2, dim=-1)[:, :, None, :]
            return sS.reshape(L, heads, n)
        new["q_scale"] = scales(p["q_scale"], qpg, fq)
        new["k_scale"] = scales(p["k_scale"], 1, fk)
    if "rope_inv_q" in p:
        # kept pairs' frequencies, per head (q) and per kv head (k)
        npair = keep_t.shape[-1]
        riq = p["rope_inv_q"].reshape(L, G, qpg, dq_full // 2)
        new["rope_inv_q"] = torch.gather(
            riq, 3, keep_t[:, :, None, :].expand(L, G, qpg, npair)) \
            .reshape(L, G * qpg, npair)
        new["rope_inv_k"] = torch.gather(p["rope_inv_k"], 2, keep_t)
    report[unit.name] = _host(diag)
    return new


# ---------------------------------------------------------------------------
# calibration passes
# ---------------------------------------------------------------------------

def _checkpointer(ckpt_dir: Optional[str], tag: str, every: int):
    if ckpt_dir is None:
        return None
    return CalibrationCheckpointer(os.path.join(ckpt_dir, tag), every=every)


def _speculative_pass(model, units, params, batches, pc: PruneConfig, *,
                      spec_margin: float, stats_dtype,
                      expert_moments: bool = False, ckpt_dir=None,
                      ckpt_every: int = 8):
    """One traversal gathering pass-1 and speculative pass-2 statistics.

    The candidate keep-sets come from the first batch's attention scores
    (one more forward of that batch, not another traversal), sized
    ``keep_n * (1 + spec_margin)``. Returns ``(p1, spec_plan,
    spec_stats)``."""
    it = iter(batches)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("empty calibration stream") from None
    # the selector needs only the attention scores, not the dense moments
    attn_units = [u for u in units if u.kind in _ATTN_KINDS]
    s0 = calib_mod.CalibrationEngine(model, attn_units, phase=1,
                                     stats_dtype=stats_dtype) \
        .run(params, [first])
    spec_plan = {}
    for u in attn_units:
        st = _host(s0[u.name])
        spec_plan[u.name] = rank_mod.candidate_attn(
            st, _attn_keep_n(u, st["rank"].shape[-1], pc), spec_margin)
    combined = calib_mod.CalibrationEngine(
        model, units, phase="1+2", spec_plan=spec_plan,
        stats_dtype=stats_dtype, expert_moments=expert_moments).run(
            params, itertools.chain([first], it),
            checkpointer=_checkpointer(ckpt_dir, "pass12", ckpt_every))
    return combined["p1"], spec_plan, combined["p2spec"]


def _resolve_attn_pass2(model, units, params, calib_batches, attn_plan,
                        spec_plan, spec_stats, *, stats_dtype, device,
                        ckpt_dir=None, ckpt_every: int = 8, say=None):
    """Pass-2 statistics of every unit in ``attn_plan``.

    Speculative (``spec_plan`` given): a unit whose keep-set lies inside
    its candidates reconstructs (G, h, t2) from the speculative sums; the
    units that escaped take ONE targeted pass 2 that reduces only theirs.
    Two-pass (``spec_plan`` None): the full pass 2. Returns ``(p2,
    misses)``."""
    say = say or (lambda s: None)
    p2, misses = {}, []
    if spec_plan is not None:
        for u in units:
            if u.name not in attn_plan:
                continue
            keep = np.asarray(attn_plan[u.name][0])
            if rank_mod.covers(spec_plan[u.name], keep):
                rec = stats_mod.spec_reconstruct(
                    _host(spec_stats[u.name]), spec_plan[u.name], keep, u)
                p2[u.name] = {k: torch.from_numpy(v).to(device)
                              for k, v in rec.items()}
            else:
                misses.append(u.name)
        todo = {k: attn_plan[k] for k in misses}
        if todo:
            say(f"pass 2 (targeted): {len(todo)} unit(s) escaped the "
                f"speculative candidates")
    else:
        todo = attn_plan
        if todo:
            say("pass 2: attention compensation statistics")
    if todo:
        p2.update(calib_mod.CalibrationEngine(
            model, units, phase=2, plan=todo, stats_dtype=stats_dtype).run(
                params, calib_batches(),
                checkpointer=_checkpointer(ckpt_dir, "pass2", ckpt_every)))
    return p2, misses


def _rank(units, p1, params, pc: PruneConfig) -> Dict:
    """unit.name -> (keep, prune) numpy index arrays, from pass 1.

    An MLP unit's ranking reads the diagonal of s2, the counts and the
    second matrix's column norms (``wv`` of a channel mix, ``out_proj``
    of a Mamba unit): only those leave the device, in fp32 (the norms in
    float64), not the (L, F, F) moments. A MoE unit ranks each expert's
    channels alike, on its ``wd`` (L, E, F, D) and its per-expert moments:
    keep / prune (L, E, n). Mamba units are ranked only with
    ``pc.include_mamba``."""
    plan = {}
    w2_key = {"rwkv_mlp": "wv", "mamba": "out_proj"}
    for u in units:
        st = p1[u.name]
        if u.kind in ("mlp", "rwkv_mlp", "moe", "mamba"):
            if pc.mlp_sparsity <= 0 or (u.kind == "mamba"
                                        and not pc.include_mamba):
                continue
            w2 = _unit_block(get_block(params, u), u)[
                w2_key.get(u.kind, "wd")]
            # float64 norms 1 GiB of rows at a time: qwen3-moe's wd is 8 x
            # 128 x 1536 x 4096, 48 GB in float64, jamba's expert 1.6 GB
            rows = w2.reshape(-1, w2.shape[-1])
            col = torch.cat([
                torch.linalg.vector_norm(r.double(), dim=-1) for r in
                rows.split(max(1, stats_mod._TEMP_BYTES // 8
                                  // rows.shape[-1]))]) \
                .reshape(w2.shape[:-1])
            keep_n = _keep_count(u.d_hidden, pc.mlp_sparsity, pc.round_to)
            host = [t.cpu().numpy() for t in (
                torch.diagonal(st["s2"], dim1=-2, dim2=-1), st["n"],
                st["na"], col)]
            plan[u.name] = rank_mod.rank_mlp(*host, keep_n, pc.rank_policy)
        elif u.kind in _ATTN_KINDS:
            if pc.attn_sparsity <= 0:
                continue
            st = _host(st)
            full = st["rank"].shape[-1]
            plan[u.name] = rank_mod.rank_attn(st, _attn_keep_n(u, full, pc))
    return plan


def _unit_block(block, u: Unit):
    """The params a unit prunes: a shared expert's MLP inside its MoE
    block, else the block."""
    return block["shared"] if u.shared_expert else block


def _to(stats, device):
    return map_tree(lambda t: t.to(device), stats)


def _park_moments(p1, units, attn_plan, device):
    """Pass 1's moments of every unit but the attention ones, moved to
    page-locked host memory when what must stay on the card until the
    fold, pass 2's class-1 G (deepseek-v3's MLA: 8.6 GB a layer) and the
    per-expert s2 (jamba's 16 experts of 24576: 38.7 GB a layer), would
    take more than half its free memory; else left as they are. Each fold
    copies its moments back, the MoE fold a chunk of experts at a time.
    Page-locked, the copies both ways run at the link's rate, several
    times a pageable copy's."""
    need = sum(4 * np.prod(np.shape(attn_plan[u.name][0])[:-1])
               * np.shape(attn_plan[u.name][0])[-1] ** 4
               for u in units if u.name in attn_plan
               and u.attn_class == 1)
    need += sum(p1[u.name]["s2"].numel() * 4 for u in units
                if u.kind == "moe" and u.name in p1)
    if device.type != "cuda" \
            or need < torch.cuda.mem_get_info(device)[0] // 2:
        return p1
    return {u.name: p1[u.name] if u.kind in _ATTN_KINDS else map_tree(
                lambda t: torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True).copy_(t),
                p1[u.name])
            for u in units if u.name in p1}


def _tick(report, stage: str, t0: float):
    timing = report["timing"]
    timing[stage] = timing.get(stage, 0.0) + time.time() - t0


def _prune_units(model, units, params, new_params, calib_batches,
                 pc: PruneConfig, report, *, device, say, stats_dtype,
                 one_traversal, spec_margin, ckpt_dir=None,
                 ckpt_every: int = 8):
    """Calibrate, rank, compensate and fold ``units``: statistics from
    ``params``, blocks folded from ``new_params``. Returns ``({(seg, layer
    key, param key): folded block}, plan)``; adds the stage times (each
    ending with a device synchronise), the units' diagnostics and, when it
    speculated, its hits and misses to ``report``."""
    speculate = (one_traversal and pc.attn_sparsity > 0
                 and any(u.kind in _ATTN_KINDS for u in units))
    # the expert-removal moments are reduced only when experts go
    experts = _experts_kept(model.cfg, pc) is not None \
        and any(u.kind == "moe" for u in units)
    spec_plan = spec_stats = None
    t0 = time.time()
    if speculate:
        say("pass 1+2: one-traversal speculative statistics")
        p1, spec_plan, spec_stats = _speculative_pass(
            model, units, params, calib_batches(), pc,
            spec_margin=spec_margin, stats_dtype=stats_dtype,
            expert_moments=experts, ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every)
    else:
        say("pass 1: ranking/MLP statistics")
        p1 = calib_mod.CalibrationEngine(
            model, units, phase=1, stats_dtype=stats_dtype,
            expert_moments=experts).run(
                params, calib_batches(),
                checkpointer=_checkpointer(ckpt_dir, "pass1", ckpt_every))
    _sync(device)
    _tick(report, "pass1", t0)

    t0 = time.time()
    plan = _rank(units, p1, params, pc)
    e_plan = _moe_expert_plan(units, p1, model.cfg, pc)
    attn_plan = {u.name: plan[u.name] for u in units
                 if u.kind in _ATTN_KINDS and u.name in plan}
    p1 = _park_moments(p1, units, attn_plan, device)
    _tick(report, "rank", t0)

    p2 = {}
    if attn_plan:
        t0 = time.time()
        p2, misses = _resolve_attn_pass2(
            model, units, params, calib_batches, attn_plan, spec_plan,
            spec_stats, stats_dtype=stats_dtype, device=device,
            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, say=say)
        _sync(device)
        _tick(report, "pass2", t0)
        if speculate:
            sp = report.setdefault("speculative", {
                "margin": spec_margin, "candidates": {}, "hits": [],
                "misses": []})
            sp["candidates"].update({k: int(v.shape[-1])
                                     for k, v in spec_plan.items()})
            sp["hits"] += sorted(set(attn_plan) - set(misses))
            sp["misses"] += sorted(misses)
    del spec_stats          # Gc (GBs at DeiT-Base) is not needed to fold

    t0 = time.time()
    say("closed-form compensation + fold")
    folds = {"mlp": _fold_mlp_block, "rwkv_mlp": _fold_mlp_block,
             "moe": _fold_moe_block, "mamba": _fold_mamba_block,
             "attn": _fold_attn_block, "mla": _fold_attn_block,
             "cross": _fold_attn_block}
    # attention units first, each statistic dropped once folded; a MoE
    # block's experts, expert removal and shared expert fold in turn
    blocks = {}
    for u in sorted(units, key=lambda u: u.kind not in _ATTN_KINDS):
        if u.name not in plan and u.name not in e_plan:
            continue
        key = (u.seg, u.layer_key, u.param_key)
        block = blocks.get(key, get_block(new_params, u))
        attn = u.kind in _ATTN_KINDS
        st = p2.pop(u.name) if attn else p1.pop(u.name)
        if u.name in plan:
            folded = _fold_as_stack(folds[u.kind], _unit_block(block, u),
                                    st, u, pc, *plan[u.name],
                                    report["units"])
            block = dict(block, shared=folded) if u.shared_expert \
                else folded
        if u.name in e_plan:
            block = _fold_as_stack(_fold_moe_experts, block, st, u, pc,
                                   *e_plan[u.name], report["units"])
        del st
        blocks[key] = block
    _sync(device)
    _tick(report, "fold", t0)
    plan.update({k + "/experts": v for k, v in e_plan.items()})
    return blocks, plan


def _set_blocks(new_params, units, blocks):
    """Put the folded blocks (keyed (seg, layer key, param key), as
    ``_prune_units`` returns them) into ``new_params``."""
    for u in units:
        key = (u.seg, u.layer_key, u.param_key)
        if key in blocks:
            set_block(new_params, u, blocks[key])


def _fold_as_stack(fold, block, st, u: Unit, pc: PruneConfig, keep, prune,
                   report):
    """``fold`` of a stacked unit; an unrolled layer folds as a stack of
    one, and its block and diagnostics lose the layer axis again."""
    if u.stacked:
        return fold(block, st, u, pc, keep, prune, report)
    one = {}
    new = fold(map_tree(lambda t: t[None], block),
               map_tree(lambda t: t[None], st), u, pc, np.asarray(keep)[None],
               np.asarray(prune)[None], one)
    for name, diag in one.items():
        report[name] = {k: v[0] for k, v in diag.items()}
    return map_tree(lambda t: t[0], new)


def _counted(calib_batches):
    """``calib_batches`` and a one-item list counting its calls (each call
    is one traversal of the calibration set)."""
    calls = [0]

    def counted():
        calls[0] += 1
        return calib_batches()
    return counted, calls


def _pruned_cfg(cfg, pc: PruneConfig):
    new = cfg.pruned(pc.mlp_sparsity if pc.mlp_sparsity > 0 else 0.0,
                     pc.attn_sparsity if pc.attn_sparsity > 0 else 0.0,
                     round_to=pc.round_to,
                     expert_sparsity=pc.expert_sparsity)
    if not pc.include_mamba and new.d_inner_kept is not None:
        new = new.replace(d_inner_kept=None)
    return new


def _refuse_unported(mesh):
    if mesh is not None:
        raise NotImplementedError("mesh-sharded calibration is not ported; "
                                  "see repro.core.calibrate"
                                  ".CalibrationEngine(mesh=)")


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def corp_prune(model, params, calib_batches: Callable[[], Iterable],
               pc: PruneConfig = PruneConfig(),
               progress: Optional[Callable[[str], None]] = None,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 8,
               mesh=None, stats_dtype="float32",
               one_traversal: bool = False, spec_margin: float = 0.25):
    """One-shot CORP (Alg. 1): calibrate -> rank -> compensate -> fold.

    Args:
      model: ``repro_torch.models.Model`` (``apply`` and ``cfg``).
      params: dense parameters (nested dict of tensors on one device); they
        are not modified. The pruned tree shares the leaves that pruning
        leaves as they were (embeddings, norms, routers of kept experts
        ...) with ``params``, so a model near the card's memory (qwen3-moe
        at 42 GB) is not held twice.
      calib_batches: zero-arg callable returning a fresh iterator of
        batches on the params' device (traversed twice: the ranking pass
        and the attention compensation pass; once with ``one_traversal`` on
        the speculative hit path).
      pc: sparsities, ridge and ranking policy (``PruneConfig``);
        ``expert_sparsity`` removes whole routed experts (MoE), after the
        hidden-channel fold.
      progress: optional ``fn(str)`` called at each stage.
      ckpt_dir: when set, each calibration pass checkpoints its statistics
        every ``ckpt_every`` batches under ``<ckpt_dir>/pass1``, ``pass2``
        (``pass12`` for the one-traversal pass) and resumes from the newest
        valid one.
      mesh: not ported; raises.
      stats_dtype: streaming dtype of the taps in every pass, "float32" or
        "bfloat16" (statistics accumulate in fp32 either way).
      one_traversal: fuse the two passes into one traversal (module
        docstring); ``spec_margin`` sizes the candidate sets (memory grows
        as ``(1 + margin)^4`` of pass 2's G for class-1 units).

    Returns:
      ``(pruned_params, pruned_config, report)``; ``report`` holds
      per-unit distortion diagnostics (``j_star``, ``j_uncomp``, ...), the
      stage timings ``pass1 / rank / pass2 / fold`` in seconds (each stage
      ends with a device synchronise), ``traversals`` (calibration-set
      traversals, counted) and, with ``one_traversal``, ``speculative``
      (margin, candidate sizes, hit and missed units).
    """
    _refuse_unported(mesh)
    cfg = model.cfg
    units = discover_units(cfg)
    device = next(iter(flatten(params).values())).device
    calib, calls = _counted(calib_batches)
    report = {"timing": {}, "units": {}}
    new_params = map_tree(lambda t: t, params)
    blocks, plan = _prune_units(
        model, units, params, new_params, calib, pc, report, device=device,
        say=progress or (lambda s: None), stats_dtype=stats_dtype,
        one_traversal=one_traversal, spec_margin=spec_margin,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)
    _set_blocks(new_params, units, blocks)
    report["plan_sizes"] = {k: v[0].shape for k, v in plan.items()}
    report["traversals"] = calls[0]
    return new_params, _pruned_cfg(cfg, pc), report


def corp_prune_streamed(model, params, calib_batches: Callable[[], Iterable],
                        pc: PruneConfig = PruneConfig(), *,
                        unit_group_size: int = 2,
                        progress: Optional[Callable[[str], None]] = None,
                        mesh=None, stats_dtype="float32",
                        one_traversal: bool = False,
                        spec_margin: float = 0.25):
    """Memory-bounded CORP: the output of ``corp_prune`` (statistics are
    linear, so partitioning the unit set changes nothing), with only
    ``unit_group_size`` units' statistics resident at a time; each group
    traverses the calibration set anew (twice for a group with attention,
    once on a speculative hit).

    Units are those of ``discover_units``, as in the JAX package: a stacked
    unit holds all its layers (DeiT-Base has 2 units, attention and MLP).

    Returns ``(pruned_params, pruned_config, report)`` as ``corp_prune``
    (stage times summed over the groups), with ``report["groups"]``
    counting the unit groups and ``report["traversals"]`` all traversals.
    """
    _refuse_unported(mesh)
    if unit_group_size < 1:
        raise ValueError(f"unit_group_size {unit_group_size} must be >= 1")
    cfg = model.cfg
    all_units = discover_units(cfg)
    say = progress or (lambda s: None)
    device = next(iter(flatten(params).values())).device
    calib, calls = _counted(calib_batches)
    report = {"timing": {}, "units": {}, "groups": 0}
    new_params = map_tree(lambda t: t, params)
    merged_plan = {}
    groups = [all_units[i:i + unit_group_size]
              for i in range(0, len(all_units), unit_group_size)]
    for gi, units in enumerate(groups):
        say(f"group {gi + 1}/{len(groups)}: "
            + ", ".join(u.name for u in units))
        blocks, plan = _prune_units(
            model, units, params, new_params, calib, pc, report,
            device=device, say=say, stats_dtype=stats_dtype,
            one_traversal=one_traversal, spec_margin=spec_margin)
        _set_blocks(new_params, units, blocks)
        merged_plan.update(plan)
        report["groups"] += 1
    report["plan_sizes"] = {k: v[0].shape for k, v in merged_plan.items()}
    report["traversals"] = calls[0]
    return new_params, _pruned_cfg(cfg, pc), report
