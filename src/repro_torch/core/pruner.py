"""CORP pipeline (paper Alg. 1, ``repro.core.pruner``): calibrate -> rank ->
compensate -> fold.

``corp_prune(model, params, calib_batches, pc)`` returns ``(pruned_params,
pruned_config, report)``: a physically smaller standard model (reduced d_ff
and per-head qk dims) that the same model code runs. This slice covers the
ViT path: dense MLP units and class-1 attention units (no rope, no
qk-norm), two calibration passes on one device. MoE, Mamba, RWKV, the rope
classes 2/3, ``one_traversal``, ``mesh=``, statistics checkpoints and
``corp_prune_streamed`` are not ported yet; they raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.core import calibrate as calib_mod
from repro_torch.core import ranking as rank_mod
from repro_torch.core import solve as solve_mod
from repro_torch.core.units import Unit, discover_units, get_block, set_block
from repro_torch.interop import map_tree


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    mlp_sparsity: float = 0.5
    attn_sparsity: float = 0.5
    expert_sparsity: float = 0.0  # whole routed experts (not ported)
    lam: float = 1e-4            # ridge, relative to mean diagonal
    rank_policy: str = "combined"
    compensate: bool = True      # False = rank-only baseline (paper ablation)
    round_to: int = 1            # kept counts rounded down to a multiple


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

def _gather_last(a, idx):
    """a (L, ..., F), idx (L, n) -> a[l, ..., idx[l]] (L, ..., n)."""
    view = idx.reshape((idx.shape[0],) + (1,) * (a.ndim - 2)
                       + (idx.shape[1],))
    return torch.gather(a, a.ndim - 1,
                        view.expand(a.shape[:-1] + (idx.shape[1],)))


def _fold_mlp_block(p, stats, unit: Unit, pc: PruneConfig, keep, prune,
                    report):
    """Dense MLP of a stacked unit. keep/prune: (L, n) index arrays."""
    w2 = p["wd"]                                     # (L, F, D)
    new = dict(p)
    keep_t, prune_t = _idx(keep, w2.device), _idx(prune, w2.device)
    mu, sigma = solve_mod.mlp_cov(stats)
    lam = pc.lam * torch.diagonal(sigma, dim1=-2, dim2=-1).mean(dim=-1)
    sol = solve_mod.ridge_affine(mu, sigma, keep_t, prune_t, lam)
    w2_S = solve_mod.gather_rows(w2, keep_t)
    w2_P = solve_mod.gather_rows(w2, prune_t).float()
    diag = solve_mod.mlp_distortion(sol, w2_P)
    if pc.compensate:
        comp = torch.einsum("rps,rpd->rsd", sol["B"], w2_P)
        bias = torch.einsum("rp,rpd->rd", sol["c"], w2_P)
        new["wd"] = (w2_S.float() + comp).to(w2.dtype)
        old_b = p.get("bd", torch.zeros_like(bias))
        new["bd"] = old_b.float() + bias
    else:
        new["wd"] = w2_S
    for k1 in ("wu", "wg"):
        if k1 in p:
            new[k1] = _gather_last(p[k1], keep_t)
    for bk in ("bu", "bg"):
        if bk in p:
            new[bk] = _gather_last(p[bk], keep_t)
    report[unit.name] = _host(diag)
    return new


def _fold_attn_block(p, p2stats, unit: Unit, pc: PruneConfig, keep, prune,
                     report):
    """Class-1 attention QK fold of a stacked unit, with the qkv bias.
    keep/prune: (L, G, n) kept / pruned dims per kv group."""
    new = dict(p)
    wq, wk = p["wq"], p["wk"]                        # (L, D, H, dq)
    L = wq.shape[0]
    G, qpg = unit.n_groups, unit.q_per_group
    dq_full = wq.shape[-1]
    keep_t = _idx(keep, wq.device)                   # (L, G, ds)
    ds = keep_t.shape[-1]

    Gm = p2stats["G"].reshape(L * G, ds * ds, ds * ds)
    hv = p2stats["h"].reshape(L * G, ds * ds)
    t2 = p2stats["t2"].reshape(L * G)
    lam = pc.lam * torch.diagonal(Gm, dim1=-2, dim2=-1).mean(dim=-1)
    sol = solve_mod.solve_full_m(Gm, hv, t2, lam)
    M = sol["M"] if pc.compensate else torch.zeros_like(sol["M"])
    fq, fk = solve_mod.fold_full_m(M)
    fq = fq.reshape(L, G, ds, ds)
    fk = fk.reshape(L, G, ds, ds)

    def fold(w, n_per_group, f):
        # w: (L, D, G*n_per_group, dq) -> gather kept dims per (layer, group),
        # then right-multiply by that group's factor
        D = w.shape[1]
        wg = w.reshape(L, D, G, n_per_group, dq_full)
        idx = keep_t[:, None, :, None, :].expand(L, D, G, n_per_group, ds)
        wS = torch.gather(wg, 4, idx).float()
        out = torch.einsum("ldgqs,lgst->ldgqt", wS, f)
        return out.reshape(L, D, G * n_per_group, ds).to(w.dtype)

    new["wq"] = fold(wq, qpg, fq)
    new["wk"] = fold(wk, 1, fk)
    if "bq" in p:
        # biases are pre-attention additive terms: same gather and fold
        new["bq"] = fold(p["bq"][:, None], qpg, fq)[:, 0].float()
        new["bk"] = fold(p["bk"][:, None], 1, fk)[:, 0].float()
    diag = {k: sol[k].reshape(L, G) for k in ("j_star", "j_uncomp", "rho2")}
    report[unit.name] = _host(diag)
    return new


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def corp_prune(model, params, calib_batches: Callable[[], Iterable],
               pc: PruneConfig = PruneConfig(),
               progress: Optional[Callable[[str], None]] = None,
               ckpt_dir: Optional[str] = None, mesh=None,
               stats_dtype="float32", one_traversal: bool = False):
    """One-shot CORP (Alg. 1): calibrate -> rank -> compensate -> fold.

    Args:
      model: ``repro_torch.models.Model`` (``apply`` and ``cfg``).
      params: dense parameters (nested dict of tensors on one device); they
        are not modified.
      calib_batches: zero-arg callable returning a fresh iterator of
        batches on the params' device (traversed twice: the ranking pass
        and the attention compensation pass).
      pc: sparsities, ridge and ranking policy (``PruneConfig``).
      progress: optional ``fn(str)`` called at each stage.

    Returns:
      ``(pruned_params, pruned_config, report)``; ``report`` holds
      per-unit distortion diagnostics (``j_star``, ``j_uncomp``, ...) and the
      stage timings ``pass1 / rank / pass2 / fold`` in seconds (each stage
      ends with a device synchronise).
    """
    if one_traversal:
        raise NotImplementedError("one-traversal calibration is not ported; "
                                  "see repro.core.pruner._speculative_pass")
    if ckpt_dir is not None:
        raise NotImplementedError("statistics checkpoints are not ported; "
                                  "see repro.distrib.fault")
    if pc.expert_sparsity > 0:
        raise NotImplementedError("expert pruning is not ported; see "
                                  "repro.core.pruner._fold_moe_experts")
    cfg = model.cfg
    units = discover_units(cfg)
    device = next(iter(params["seg0"]["p0"]["mlp"].values())).device
    say = progress or (lambda s: None)
    report = {"timing": {}, "units": {}}
    engine_kw = dict(mesh=mesh, stats_dtype=stats_dtype)

    t0 = time.time()
    say("pass 1: ranking/MLP statistics")
    p1 = calib_mod.CalibrationEngine(model, units, phase=1, **engine_kw) \
        .run(params, calib_batches())
    _sync(device)
    report["timing"]["pass1"] = time.time() - t0

    t0 = time.time()
    plan = {}       # unit.name -> (keep, prune) numpy arrays
    for u in units:
        st = _host(p1[u.name])
        if u.kind == "mlp":
            if pc.mlp_sparsity <= 0:
                continue
            w2 = get_block(params, u)["wd"].cpu().numpy()
            keep_n = _keep_count(u.d_hidden, pc.mlp_sparsity, pc.round_to)
            plan[u.name] = rank_mod.rank_mlp(st, w2, keep_n, pc.rank_policy)
        elif u.kind == "attn":
            if pc.attn_sparsity <= 0:
                continue
            full = st["rank"].shape[-1]
            plan[u.name] = rank_mod.rank_attn(st, _attn_keep_n(u, full, pc))
    report["timing"]["rank"] = time.time() - t0

    attn_plan = {u.name: plan[u.name] for u in units
                 if u.kind == "attn" and u.name in plan}
    p2 = {}
    if attn_plan:
        t0 = time.time()
        say("pass 2: attention compensation statistics")
        p2 = calib_mod.CalibrationEngine(model, units, phase=2,
                                         plan=attn_plan, **engine_kw) \
            .run(params, calib_batches())
        _sync(device)
        report["timing"]["pass2"] = time.time() - t0

    t0 = time.time()
    say("closed-form compensation + fold")
    new_params = map_tree(torch.clone, params)
    for u in units:
        if u.name not in plan:
            continue
        keep, prune = plan[u.name]
        block = get_block(new_params, u)
        if u.kind == "mlp":
            block = _fold_mlp_block(block, p1[u.name], u, pc, keep, prune,
                                    report["units"])
        else:
            block = _fold_attn_block(block, p2[u.name], u, pc, keep, prune,
                                     report["units"])
        set_block(new_params, u, block)
    _sync(device)
    report["timing"]["fold"] = time.time() - t0
    report["plan_sizes"] = {k: v[0].shape for k, v in plan.items()}
    report["traversals"] = 1 + bool(attn_plan)

    new_cfg = cfg.pruned(pc.mlp_sparsity if pc.mlp_sparsity > 0 else 0.0,
                         pc.attn_sparsity if pc.attn_sparsity > 0 else 0.0,
                         round_to=pc.round_to)
    return new_params, new_cfg, report


def corp_prune_streamed(*args, **kwargs):
    raise NotImplementedError("memory-bounded streamed CORP is not ported; "
                              "see repro.core.pruner.corp_prune_streamed")
