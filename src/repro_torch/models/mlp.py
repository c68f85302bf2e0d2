"""MLP mixers (``repro.models.mlp``): dense (plain / gated) and the
routed Mixture-of-Experts with capacity, with its always-on shared experts
(deepseek-v3: one dense GLU of ``num_shared * d_expert`` beside the routed
ones, whose ``h`` tap is the shared unit's).

CORP integration: the tap ``h`` is the activation entering the second
linear map, so one hidden channel is one structured unit. For MoE the tap
``moe_h`` is per expert and capacity slot, with the dispatch mask
``moe_mask``, so the statistics are expert-conditional.

Under a mesh's ``tp`` (the serving and the sharded calibration forward)
the dense MLP is Megatron's split and the routed experts are split over
the model axis (``_apply_moe_tp``); the taps are then the rank's: the
hidden channels of its block, its experts' queues over its own rows.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import (activation, dense_init, dtype_of,
                                       expert_taps_on, tap)


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
    y = mlp_partial(p, x, cfg, taps, tp)
    if tp is not None:
        y = tp.all_reduce(y)
    if "bd" in p:
        y = y + p["bd"].to(x.dtype)
    return y


def mlp_partial(p, x, cfg, taps=None, tp=None):
    """``apply_mlp`` up to its reduction: the rank's partial sum under
    ``tp`` (the whole product without), ``bd`` not added."""
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
    return h @ p["wd"]


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
    """(B, T, D) -> (G, tg, D) routing groups, tg <= 2048 dividing B*T."""
    B, T, D = x.shape
    tg = _group_size(B * T)
    return x.reshape(B * T // tg, tg, D)


def capacity(tg: int, cfg) -> int:
    """Slots an expert takes per routing group of ``tg`` tokens."""
    m = cfg.moe
    K, E = m.top_k, cfg.eff_num_experts
    return min(tg, max(K, int(math.ceil(tg * K * m.capacity_factor / E))))


def _route(xg, router, cfg):
    """Routing of (G, tg, D) groups: an fp32 softmax of ``xg @ router``,
    its top k (ties to the lower expert index, as ``jax.lax.top_k``)
    renormalised; each (token, k) pair takes the next slot of its expert's
    queue, in token-major, k-minor order, and a pair past the capacity C is
    dropped. Returns (gate (G, tg, K), expert (G, tg K), queue position
    (G, tg K), kept (G, tg K), C, the (token, k) picks of each expert
    before capacity (E,), probs (G, tg, E))."""
    E, K = cfg.eff_num_experts, cfg.moe.top_k
    G, tg, _ = xg.shape
    C = capacity(tg, cfg)
    probs = torch.softmax(xg.float() @ router, dim=-1)        # (G, tg, E)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :K], order[..., :K]                 # (G, tg, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = idx.reshape(G, tg * K)
    onehot = torch.nn.functional.one_hot(flat, E)             # (G, tg K, E)
    pos = (onehot.cumsum(1) - onehot).gather(2, flat[..., None])[..., 0]
    return gate, flat, pos, pos < C, C, onehot.sum((0, 1)), probs


def _experts(p, xe, cfg):
    """The experts' GLU over their dispatched rows xe (E, N, D) -> (E, N,
    F) hidden and (E, N, D) outputs, ``bd_moe`` (CORP's hidden-channel
    compensation, per expert) added inside the output, before the combine:
    dispatched tokens get it gate-weighted, empty capacity slots are never
    gathered."""
    act = activation(cfg.act)
    h = act(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])  # (E, N, F)
    ye = torch.bmm(h, p["wd"])                                # (E, N, D)
    if "bd_moe" in p:
        ye = ye + p["bd_moe"].to(ye.dtype)[:, None, :]
    return h, ye


def _dispatch(p, xg, routed, sel, e_lo, cfg, dt):
    """The experts [e_lo, e_lo + n) that ``p`` holds over the pairs ``sel``
    (G, tg K; kept pairs of those experts) of ``_route``'s ``routed``: each
    pair's row scattered into its expert's queue slot, the experts run
    (``_experts``), each pair's output gathered back and gate-weighted, the
    gate rounded to ``dt`` as the reference rounds its combine tensor.
    Returns (hidden (G, n, C, F), the dispatched (group, slot) indices,
    each pair's contribution (G, tg K, D) fp32, zero outside ``sel``)."""
    gate, flat, pos, _, C = routed[:5]
    G, tg, D = xg.shape
    K, n = gate.shape[-1], p["wg"].shape[0]
    slot = ((flat - e_lo) * C + pos) * sel                    # (G, tg K)
    g_i, f_i = sel.nonzero(as_tuple=True)
    s_i = slot[g_i, f_i]
    xe = xg.new_zeros(G, n * C, D)
    xe[g_i, s_i] = xg[g_i, f_i // K]
    xe = xe.reshape(G, n, C, D).transpose(0, 1).reshape(n, G * C, D)
    h, ye = _experts(p, xe, cfg)
    ye = ye.reshape(n, G, C, D).transpose(0, 1).reshape(G, n * C, D)
    w = (gate.to(dt).float() * sel.reshape(G, tg, K)).reshape(G, tg * K)
    got = ye.gather(1, slot[..., None].expand(G, tg * K, D))
    return (h.reshape(n, G, C, -1).transpose(0, 1), (g_i, s_i),
            w[..., None] * got.float())


def load_balance(routed, E: int) -> torch.Tensor:
    """The Switch-style load-balancing loss of ``_route``'s ``routed``: E
    sum_e (fraction of the (token, k) picks of expert e before capacity,
    per token) (mean router probability of e), fp32."""
    picks, probs = routed[5], routed[6]
    G, tg = probs.shape[:2]
    frac_tokens = picks.float() / (G * tg)
    frac_probs = probs.mean((0, 1))
    return E * torch.sum(frac_tokens * frac_probs)


def apply_moe(p, x, cfg, taps=None, tp=None, aux=None):
    """Top-k routed experts with capacity: x (B, T, D) -> (B, T, D).

    Routing is ``_route``'s. Dispatch and combine are index scatters and
    gathers (``_dispatch``; the reference's one-hot products select the
    same rows exactly). Shared experts add their dense MLP of x; its ``h``
    tap lands beside ``moe_h``.

    ``aux``: a list the block's load-balancing loss (``load_balance``) is
    appended to, as the reference returns it beside y (training).

    Under ``tp`` the rank holds its block of the experts
    (``_apply_moe_tp``)."""
    if tp is not None:
        return _apply_moe_tp(p, x, cfg, tp, taps, aux)
    E, K = cfg.eff_num_experts, cfg.moe.top_k
    B, T, D = x.shape
    dt = x.dtype
    xg = _group_tokens(x, cfg)
    G, tg, _ = xg.shape
    routed = _route(xg, p["router"], cfg)
    if aux is not None:
        aux.append(load_balance(routed, E))
    h, (g_i, s_i), contrib = _dispatch(p, xg, routed, routed[3], 0, cfg, dt)
    if taps is not None:
        tap(taps, "moe_h", h)
        mask = torch.zeros(G, E * routed[4], dtype=torch.float32,
                           device=x.device)
        mask[g_i, s_i] = 1.0
        taps["moe_mask"] = mask.reshape(G, E, routed[4])
    if taps is not None and expert_taps_on():
        # expert-removal regressors (repro.core.stats._p1_moe): the block
        # input and each expert's gate-weighted contribution to each token
        tap(taps, "moe_x", xg)
        yc = contrib.new_zeros(G, tg, E, D)
        gi = torch.arange(G, device=x.device)[:, None].expand(G, tg * K)
        ti = torch.arange(tg * K, device=x.device)[None].expand(G, -1) // K
        yc[gi, ti, routed[1]] = contrib
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


def _apply_moe_tp(p, x, cfg, tp, taps=None, aux=None):
    """Expert parallelism over the model axis: ``wg``, ``wu``, ``wd`` and
    ``bd_moe`` are the rank's block [e_lo, e_hi) of the experts, the router
    is whole, ``moe_resid`` is the rank's block of its rows, the shared
    expert its Megatron blocks (``apply_mlp``).

    Every rank routes the same tokens with the whole router, so the top k,
    the queue positions and the drops are one device's; a rank dispatches
    only the kept pairs whose expert lies in its block, runs its experts
    and combines its own rows, adds ``x[..., rows] @ moe_resid[rows]`` and
    the shared expert's partial, and one fp32 ``all_reduce`` sums the
    ranks' partials; ``moe_out_b`` and the shared ``bd`` follow it. The
    sum over k becomes a sum a rank, then over the ranks: equal up to fp32
    reassociation.

    With ``tp.rows`` (rows split over a data axis: a sharded decode step's
    slots, a sharded calibration batch's share) x holds the rank's rows
    only, while capacity is shared by a routing group of the whole step:
    the rows are gathered over the data axis (``gather_rows``), routed as
    one batch, and only the rank's own rows are dispatched and returned,
    which is exact for any capacity factor and any split.

    The taps are the rank's: ``moe_h`` and ``moe_mask`` its experts'
    queues of the routing groups its rows fall in, filled by its own rows
    only; ``moe_x`` (N, D) and ``moe_yc`` (N, n, D) of its N own tokens
    and its n experts; the shared expert's ``h`` its hidden block. Summed
    over the ranks of the data axis and gathered over the model axis they
    give one device's statistics (``core.stats``). ``aux`` gets the
    load-balancing loss of the routed tokens: the whole step's."""
    K = cfg.moe.top_k
    B, T, D = x.shape
    dt = x.dtype
    rows = tp.rows
    whole, r_lo = (x, 0) if rows is None else rows.gather_rows(x)
    xg = _group_tokens(whole, cfg)
    G, tg, _ = xg.shape
    routed = _route(xg, p["router"], cfg)
    if aux is not None:
        aux.append(load_balance(routed, cfg.eff_num_experts))
    flat, n = routed[1], p["wg"].shape[0]
    e_lo = tp.index * n if n < cfg.eff_num_experts else 0
    t_lo, t_hi = r_lo * T, (r_lo + B) * T
    token = torch.arange(G * tg * K, device=x.device).reshape(G, tg * K) // K
    mine = routed[3] & (flat >= e_lo) & (flat < e_lo + n) \
        & (token >= t_lo) & (token < t_hi)
    h, (g_i, s_i), contrib = _dispatch(p, xg, routed, mine, e_lo, cfg, dt)
    if taps is not None:
        g0, g1 = t_lo // tg, -(-t_hi // tg)
        C = routed[4]
        tap(taps, "moe_h", h[g0:g1])
        mask = torch.zeros(G, n * C, dtype=torch.float32, device=x.device)
        mask[g_i, s_i] = 1.0
        taps["moe_mask"] = mask.reshape(G, n, C)[g0:g1]
    if taps is not None and expert_taps_on():
        gi, fi = mine.nonzero(as_tuple=True)
        yc = contrib.new_zeros(G * tg, n, D)
        yc[gi * tg + fi // K, flat[gi, fi] - e_lo] = contrib[gi, fi]
        tap(taps, "moe_x", x.reshape(B * T, D))
        tap(taps, "moe_yc", yc[t_lo:t_hi].to(dt))
    y = contrib.reshape(G * tg, K, D).sum(1)[t_lo:t_hi]
    xs = x.reshape(B * T, D)
    if "moe_resid" in p:
        r = p["moe_resid"].shape[0]
        lo = tp.index * r if r < D else 0
        y = y + xs[:, lo:lo + r].float() @ p["moe_resid"]
    if "shared" in p:
        y = y + mlp_partial(p["shared"], x, cfg, taps, tp) \
            .reshape(B * T, D).float()
    y = tp.all_reduce(y).to(dt)
    if "moe_out_b" in p:
        y = y + p["moe_out_b"].to(dt)
    if "shared" in p and "bd" in p["shared"]:
        y = y + p["shared"]["bd"].to(dt)
    return y.reshape(B, T, D)
