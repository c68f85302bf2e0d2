"""MLP mixers (``repro.models.mlp``): dense (plain / gated) and the
routed Mixture-of-Experts with capacity, with its always-on shared experts
(deepseek-v3: one dense GLU of ``num_shared * d_expert`` beside the routed
ones, whose ``h`` tap is the shared unit's).

CORP integration: the tap ``h`` is the activation entering the second
linear map, so one hidden channel is one structured unit. For MoE the tap
``moe_h`` is per expert and capacity slot, with the dispatch mask
``moe_mask``, so the statistics are expert-conditional.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import (activation, dense_init, dtype_of,
                                       expert_taps_on, no_tensor_parallel,
                                       row_share_of, tap)


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


def apply_mlp(p, x, cfg, taps=None, tp=None):
    """x: (..., D) -> (..., D). Biases are stored fp32 and cast to the
    activation dtype before they are added.

    Under ``tp`` (``common.TensorParallel``) ``wg`` and ``wu`` are the
    rank's column blocks of F and ``wd`` its row block, so the rank's
    hidden channels give a partial sum that one ``all_reduce`` completes;
    the biases of F are taken at the rank's block, ``bd`` is added once,
    after the reduction."""
    act = activation(cfg.act)
    dt = x.dtype
    u = x @ p["wu"]
    F_local = u.shape[-1]

    def vec(name):
        v = p[name] if tp is None else tp.local(p[name], F_local)
        return v.to(dt)
    if "bu" in p:
        u = u + vec("bu")
    if "wg" in p:
        gpre = x @ p["wg"]
        if "bg" in p:
            gpre = gpre + vec("bg")
        h = act(gpre) * u
    else:
        h = act(u)
    tap(taps, "h", h)
    y = h @ p["wd"]
    if tp is not None:
        y = tp.all_reduce(y)
    if "bd" in p:
        y = y + p["bd"].to(dt)
    return y


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard-style grouped dispatch with capacity)
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg):
    """Router fp32 (D, E), experts ``wg``/``wu`` (E, D, F), ``wd`` (E, F,
    D). A pruned config's template adds the compensation slots CORP
    writes, zeros fp32 (the JAX template has none, and its restore drops
    them): ``bd_moe`` (E, D) when hidden channels were pruned,
    ``moe_resid`` (D, D) and ``moe_out_b`` (D,) when experts were
    removed. Shared experts are one dense MLP ``shared`` of ``num_shared
    * d_expert`` hidden channels (``num_shared * d_ff_kept`` pruned, with
    its ``bd`` slot, see ``init_mlp``)."""
    dt = dtype_of(cfg)
    D, E = cfg.d_model, cfg.eff_num_experts
    F = cfg.eff_d_expert
    p = {"router": dense_init(gen, (D, E), torch.float32, scale=0.02),
         "wg": dense_init(gen, (E, D, F), dt),
         "wu": dense_init(gen, (E, D, F), dt),
         "wd": dense_init(gen, (E, F, D), dt)}
    if cfg.d_ff_kept is not None:
        p["bd_moe"] = torch.zeros(E, D)
    if cfg.experts_kept is not None:
        p["moe_resid"] = torch.zeros(D, D)
        p["moe_out_b"] = torch.zeros(D)
    m = cfg.moe
    if m.num_shared > 0:
        p["shared"] = init_mlp(gen, cfg.replace(
            d_ff=m.num_shared * m.d_expert,
            d_ff_kept=(None if cfg.d_ff_kept is None
                       else m.num_shared * cfg.d_ff_kept)))
    return p


def _group_size(n: int, target: int = 2048) -> int:
    """The routing-group size of n tokens: the largest divisor of n that
    is at most ``target``."""
    tg = min(target, n)
    while n % tg:
        tg -= 1
    return tg


def _group_tokens(x, cfg):
    """(B, T, D) -> (G, tg, D) routing groups, tg <= 2048 dividing B*T.

    Inside ``common.row_share`` (x holds rows [lo, hi) of a batch of
    ``total``: a rank's share under sharded calibration) the groups are the
    whole batch's, so that every (token, k) pair takes its slot, or is
    dropped, as in the whole batch; the share must then be whole groups of
    it. A share that is not is routed on its own groups only where no
    expert can overflow at either size (the capacity holds a whole group),
    which gives every token what the whole batch gives it; else it raises
    before routing."""
    B, T, D = x.shape
    tg = _group_size(B * T)
    share = row_share_of()
    if share is not None:
        lo, hi, total = share
        whole = _group_size(total * T)
        if (lo * T) % whole == 0 and (hi * T) % whole == 0:
            tg = whole
        elif capacity(whole, cfg) < whole or capacity(tg, cfg) < tg:
            rows = whole // math.gcd(whole, T)
            raise ValueError(
                f"routed MoE under a row split: rows [{lo}, {hi}) of a "
                f"{total}-row batch ({T} tokens a row) cut its routing "
                f"groups of {whole} tokens, and an expert's "
                f"{capacity(whole, cfg)} slots a group can overflow, so "
                f"the share would drop other tokens than the whole batch; "
                f"give each batch rank a multiple of {rows} rows")
    return x.reshape(B * T // tg, tg, D)


def capacity(tg: int, cfg) -> int:
    """Slots an expert takes per routing group of ``tg`` tokens."""
    m = cfg.moe
    K, E = m.top_k, cfg.eff_num_experts
    return min(tg, max(K, int(math.ceil(tg * K * m.capacity_factor / E))))


def apply_moe(p, x, cfg, taps=None, tp=None):
    """Top-k routed experts with capacity: x (B, T, D) -> (B, T, D).

    Routing is an fp32 softmax of ``x @ router``, its top k (ties to the
    lower expert index, as ``jax.lax.top_k``) renormalised. Each (token,
    k) pair takes the next slot of its expert's queue, in token-major,
    k-minor order; a pair past the capacity is dropped and contributes
    nothing. Dispatch and combine are index scatters and gathers (the
    reference's one-hot products select the same rows exactly); the gate
    weights are rounded to the model dtype before they combine, as the
    reference rounds its combine tensor. Shared experts add their dense
    MLP of x; its ``h`` tap lands beside ``moe_h``."""
    no_tensor_parallel(tp, "MoE (expert parallelism)")
    m = cfg.moe
    E, K = cfg.eff_num_experts, m.top_k
    B, T, D = x.shape
    dt = x.dtype
    xg = _group_tokens(x, cfg)
    G, tg, _ = xg.shape
    C = capacity(tg, cfg)

    probs = torch.softmax(xg.float() @ p["router"], dim=-1)   # (G, tg, E)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :K], order[..., :K]                 # (G, tg, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    flat = idx.reshape(G, tg * K)
    onehot = torch.nn.functional.one_hot(flat, E)             # (G, tg K, E)
    pos = (onehot.cumsum(1) - onehot).gather(2, flat[..., None])[..., 0]
    kept = pos < C
    slot = flat * C + pos                                     # (G, tg K)
    g_i, f_i = kept.nonzero(as_tuple=True)
    s_i = slot[g_i, f_i]
    xe = xg.new_zeros(G, E * C, D)
    xe[g_i, s_i] = xg[g_i, f_i // K]
    xe = xe.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)

    act = activation(cfg.act)
    h = act(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])  # (E, G C, F)
    ye = torch.bmm(h, p["wd"])                                # (E, G C, D)
    if taps is not None:
        tap(taps, "moe_h", h.reshape(E, G, C, -1).transpose(0, 1))
        mask = torch.zeros(G, E * C, dtype=torch.float32, device=x.device)
        mask[g_i, s_i] = 1.0
        taps["moe_mask"] = mask.reshape(G, E, C)
    if "bd_moe" in p:   # CORP hidden-channel compensation, per expert
        # inside the expert output, before combine: dispatched tokens get
        # it gate-weighted, empty capacity slots are never gathered
        ye = ye + p["bd_moe"].to(ye.dtype)[:, None, :]
    ye = ye.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)

    w = (gate.to(dt).float() * kept.reshape(G, tg, K)).reshape(G, tg * K)
    rows = ye.gather(1, (slot * kept)[..., None].expand(G, tg * K, D))
    contrib = w[..., None] * rows.float()                     # (G, tg K, D)
    if taps is not None and expert_taps_on():
        # expert-removal regressors (repro.core.stats._p1_moe): the block
        # input and each expert's gate-weighted contribution to each token
        tap(taps, "moe_x", xg)
        yc = contrib.new_zeros(G, tg, E, D)
        gi = torch.arange(G, device=x.device)[:, None].expand(G, tg * K)
        ti = torch.arange(tg * K, device=x.device)[None].expand(G, -1) // K
        yc[gi, ti, flat] = contrib
        tap(taps, "moe_yc", yc.to(dt))
    y = contrib.reshape(G, tg, K, D).sum(2).to(dt)
    if "moe_resid" in p:   # CORP expert-removal compensation (input map)
        y = y + (xg.float() @ p["moe_resid"]).to(dt)
    if "moe_out_b" in p:   # CORP expert-removal compensation bias
        y = y + p["moe_out_b"].to(dt)
    y = y.reshape(B, T, D)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg, taps=taps)
    return y
