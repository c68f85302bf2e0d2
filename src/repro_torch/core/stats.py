"""Calibration statistics for CORP (``repro.core.stats``).

Two streaming passes over the unlabeled calibration set:

  pass 1: per MLP unit the moments n, s1 = sum_t x_t, s2 = sum_t x_t x_t^T
    and the activity counts na (fp32), through the gram kernel; per
    attention unit the logit-energy ranking statistic
      rank_j = sum_b (sum_{t,h} q_{t,j}^2)(sum_t k_{t,j}^2)   per kv group.
  pass 2: given the kept index sets from ranking, the ridge system inputs
    of paper Eq. 15 for class-1 (no rope, no qk-norm) attention units:
      G = sum_b (Q_S^T Q_S) (x) (K_S^T K_S),  h = sum_b vec((Q_S^T Q_P)(K_P^T K_S)),
      t2 = sum_b ||Q_P K_P^T||_F^2.

  one traversal (phase "1+2"): pass 1 plus speculative pass-2 sums
    against fixed candidate keep-sets C (``spec_pass2_reduce``), from which
    ``spec_reconstruct`` rebuilds the exact (G, h, t2) of any keep-set
    inside C, with no second traversal:
      Gc = sum_b A_CC (x) C_CC,  Hfull = sum_b (Q_C^T Q)(K^T K_C),
      t2_tot = sum_b <Q^T Q, K^T K>   (A = Q^T Q, C = K^T K per sample).

Class-2 (rope) attention units reduce over rotary pairs: a pair (2i, 2i+1)
of q or k is the complex number x + iy, and the statistics are the
Hadamard analogues on A = Q^H Q and C = K^H K (complex64):
  pass 1: rank_j = sum_b (sum |q_j|^2)(sum |k_j|^2) per pair;
  pass 2: G = sum_b A_SS (.) C_SS^T, h = sum_b diag(A_SP C_PS),
          t2 = sum_b ||Q_P K_P^H||_F^2;
  one traversal: Gc = sum_b E_CC, hfull = sum_b sum_p E_Cp, t2_tot =
          Re sum_b sum E, with E = A (.) conj(C).
These einsums are jnp in the reference, and plain torch ops here, but
for the one-traversal sums' per-sample grams, which the gram_cross kernel
takes (``_pair_gram`` turns a real gram of interleaved pairs into the
complex one). Class-3 (rope + qk-norm) units reduce exactly as class 2
and keep the real parts of pass 2's G and h (the speculative sums stay
complex; ``spec_reconstruct`` takes the real parts).

Every statistic is a sum over samples, accumulated in fp32. Taps arrive in
the engine's streaming dtype (fp32 or bf16): the dense second moments and
the speculative per-sample grams take it into the gram kernels, which
accumulate in fp32; every other reduction casts to fp32 first. The
layer-stacked taps (leading layer axis) are reduced for all layers at
once: one gram launch covers every layer of a unit. An unstacked unit (an
unrolled layer) has taps without that axis: it is reduced as a stack of
one layer and its statistics lose the axis again, the shapes JAX gives.

A routed-MoE unit reduces per expert (``_p1_moe``): the hidden taps of
every (layer, expert) queue, masked to the filled capacity slots, go
through the gram kernel as one stack of L x E items, one launch a batch.
Its expert-removal moments (``yn``, ``ys1``, ``ys2`` of the block input
and the experts' contributions, ((E+1) D)^2 a layer) are reduced only
when the forward recorded their taps (``models.common.expert_taps``),
i.e. when experts are pruned. A shared expert is an ``mlp`` unit on the
block's ``h`` tap. An MLA unit (deepseek-v3) is a class-1 unit with one
group a head, on the taps of its nope block. Pass 2's class-1 ``G`` is
accumulated in place (``_add_kron``): at MLA's full width it is (H,
ds^2, ds^2) = 8.6 GB a layer, and a batch adds into it one chunk of heads
at a time, so no batch allocates a second one. Pass 1 adds each unit's
batch sums into the running ones as soon as they are reduced, per-expert
s2 a chunk of queues at a time (``_expert_moments``: one chunk when a
batch's s2 is at most ``_MOE_WHOLE`` bytes; jamba's 16 experts of 24576,
38.7 GB a layer, one a launch). A Mamba unit is an MLP-like unit on its
``mamba_y`` tap (the gated inner channels entering ``out_proj``). A
cross-attention unit (enc-dec) is a class-1 unit on its ``cross_q``
(B, T, H, d) and ``cross_k`` (B, S, Hkv, d) taps: the query rows are
the decoder's and the key rows the memory's, T and S taken as they come.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.units import Unit
from repro_torch.kernels.gram import ops as gram_ops

ACTIVE_EPS = 1e-2   # |x| > eps counts as 'active' (appendix E ranking)
# Byte budgets of pruning's large temporaries on the card, for this module
# and the pruner. A batch's per-expert s2 takes one gram launch when it is
# at most _MOE_WHOLE, else one a chunk of queues within _MOE_CHUNK (jamba's
# 24576-wide experts: one a launch); _MOE_CHUNK also bounds a chunk of the
# MoE fold's float64 covariances (one expert at jamba's width: 4.8 GB). A
# chunk of pass 2's G product (_KRON_CHUNK fp32 values) and of the
# ranking's float64 column norms take _TEMP_BYTES.
_MOE_WHOLE = 16 << 30
_MOE_CHUNK = 4 << 30
_TEMP_BYTES = 1 << 30
_KRON_CHUNK = _TEMP_BYTES // 4


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


def _masked_moments(h, mask):
    """h: (R, N, F) per-queue hidden taps; mask: (R, N) fp32 slot validity
    -> dict(n (R,), s1 (R,F), s2 (R,F,F), na (R,F)), fp32. The R queues
    take one gram launch in h's own dtype (the 0/1 mask is exact in it)."""
    hf = h * mask.to(h.dtype)[..., None]
    g = gram_ops.gram(hf)
    return {"n": mask.sum(dim=1),
            "s1": g["s1"],
            "s2": g["s2"],
            "na": ((hf.abs() > ACTIVE_EPS) * mask[..., None])
            .sum(dim=1, dtype=torch.float32)}


def _group_q(q, n_groups):
    """(L, B, T, H, d) -> (L, B, G, T*qpg, d): stack group queries along
    tokens."""
    L, B, T, H, d = q.shape
    qpg = H // n_groups
    return q.reshape(L, B, T, n_groups, qpg, d).permute(0, 1, 3, 2, 4, 5) \
        .reshape(L, B, n_groups, T * qpg, d)


def _to_complex_pairs(q):
    """(..., D) fp32 -> complex64 (..., D/2): rotary pair (2i, 2i+1) ->
    x + iy, the interleaved pairs the rope rotates."""
    return torch.complex(q[..., 0::2], q[..., 1::2])


def _qk_taps(taps, unit: Unit):
    """An attention unit's query and key taps, with the layer axis: ``q``
    and ``k``, a cross unit's ``cross_q`` and ``cross_k``."""
    pre = f"{unit.tap_prefix}/{'cross_' if unit.kind == 'cross' else ''}"
    return _stacked(unit, taps[pre + "q"]), _stacked(unit, taps[pre + "k"])


def _stacked(unit: Unit, x):
    """A tap or index array with the layer axis: an unstacked unit's gets
    one of length 1."""
    return x if unit.stacked else x[None]


def _unstack(unit: Unit, tree):
    """Statistics of ``_stacked`` inputs -> the unit's own shapes: an
    unstacked unit's leaves lose the length-1 layer axis."""
    if unit.stacked:
        return tree
    return {k: v[0] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# pass 1
# ---------------------------------------------------------------------------

def _p1_mlp(taps, unit: Unit):
    """Moments of an MLP-like unit's hidden tap: ``h``, or a Mamba unit's
    ``mamba_y``."""
    key = "mamba_y" if unit.kind == "mamba" else "h"
    h = _stacked(unit, taps[f"{unit.tap_prefix}/{key}"])  # (L, B, T, F)
    return _unstack(unit, _moments(h.reshape(h.shape[0], -1, h.shape[-1])))


def _expert_moments(h, mask, acc=None):
    """``_masked_moments`` of R queues, one gram launch a chunk of them:
    all R when their s2 is at most ``_MOE_WHOLE`` bytes, else as many as
    fit in ``_MOE_CHUNK``. Each chunk's s2 is added in place into the
    running sums ``acc['s2']`` (then left out of the result) or, on the
    first batch, into the result's s2: the launch's own when one chunk
    holds all R, else a zero buffer. The same sums as one launch: each
    queue's gram is its own."""
    R, _, F = h.shape
    step = R if R * F * F * 4 <= _MOE_WHOLE \
        else max(1, _MOE_CHUNK // (F * F * 4))
    s2 = acc["s2"].view(R, F, F) if acc is not None else \
        None if step >= R else h.new_zeros((R, F, F), dtype=torch.float32)
    parts = []
    for r in range(0, R, step):
        m = _masked_moments(h[r:r + step], mask[r:r + step])
        if s2 is None:
            s2 = m.pop("s2")
        else:   # the chunk's s2 is freed before the next launch
            s2[r:r + step] += m.pop("s2")
        parts.append(m)
    out = {k: torch.cat([m[k] for m in parts]) for k in parts[0]}
    if acc is None:
        out["s2"] = s2
    return out


def _p1_moe(taps, unit: Unit, acc=None):
    """Per-expert moments of a routed-MoE unit: ``moe_h`` (L, G, E, C, F)
    with its ``moe_mask`` (L, G, E, C), the groups merged into the
    capacity axis -> n (L, E), s1 (L, E, F), s2 (L, E, F, F), na (L, E,
    F); s2 added a chunk of queues at a time into the running sums
    ``acc`` when given (``_expert_moments``). With the expert-removal taps, also the
    moments of z_t = [x_t, c_t1..c_tE] ((E+1) D wide): yn (L,), ys1 (L,
    V), ys2 (L, V, V)."""
    pre = unit.tap_prefix
    h = _stacked(unit, taps[f"{pre}/moe_h"])
    mask = _stacked(unit, taps[f"{pre}/moe_mask"])
    L, G, E, C, F = h.shape
    out = _expert_moments(h.transpose(1, 2).reshape(L * E, G * C, F),
                          mask.transpose(1, 2).reshape(L * E, G * C), acc)
    out = {k: v.reshape((L, E) + v.shape[1:]) for k, v in out.items()}
    if f"{pre}/moe_yc" in taps:
        yc = _stacked(unit, taps[f"{pre}/moe_yc"])     # (L, G, tg, E, D)
        x = _stacked(unit, taps[f"{pre}/moe_x"])       # (L, G, tg, D)
        D = yc.shape[-1]
        z = torch.cat([x.reshape(L, -1, D), yc.reshape(L, -1, E * D)],
                      dim=-1)
        g = gram_ops.gram(z)
        out.update(yn=torch.full((L,), float(z.shape[1]),
                                 dtype=torch.float32, device=z.device),
                   ys1=g["s1"], ys2=g["s2"])
    return _unstack(unit, out)


def _p1_attn(taps, unit: Unit):
    q, k = _qk_taps(taps, unit)                       # (L, B, T|S, H, d)
    q, k = q.float(), k.float()
    qg = _group_q(q, unit.n_groups)                   # (L, B, G, TQ, d)
    kg = k.permute(0, 1, 3, 2, 4)                     # (L, B, G, T, d)
    if unit.attn_class == 1:
        eq = qg.square().sum(dim=3)                   # (L, B, G, d)
        ek = kg.square().sum(dim=3)
    else:                                             # per rotary pair
        eq = _to_complex_pairs(qg).abs().square().sum(dim=3)
        ek = _to_complex_pairs(kg).abs().square().sum(dim=3)
    L, B = q.shape[0], q.shape[1]
    return _unstack(unit, {"rank": (eq * ek).sum(dim=1),
                           "n": torch.full((L,), float(B),
                                           dtype=torch.float32,
                                           device=q.device)})


# ---------------------------------------------------------------------------
# pass 2 (class-1 attention compensation inputs)
# ---------------------------------------------------------------------------

def _take(x, idx):
    """x: (B, G, T, d), idx: (G, n) -> (B, G, T, n)."""
    B, G, T, _ = x.shape
    return torch.gather(x, 3, idx[None, :, None, :].expand(B, G, T,
                                                          idx.shape[-1]))


def _add_kron(out, A, C):
    """out (G, ds^2, ds^2) += sum_b A[g, b, i, j] C[g, b, l, k] at [g, (i
    l), (j k)], in place; A, C (G, B, ds, ds). The batch contraction is
    one bmm a chunk of groups, in the (i j),(l k) layout, added into
    ``out``'s layout through a transposed view: a batch allocates one
    chunk's product (``_KRON_CHUNK`` values), never a second G."""
    n_g, B, ds, _ = A.shape
    Af = A.reshape(n_g, B, ds * ds).transpose(1, 2)       # (G, ds^2, B)
    Cf = C.reshape(n_g, B, ds * ds)                       # (G, B, ds^2)
    o = out.view(n_g, ds, ds, ds, ds)                     # [g, i, l, j, k]
    step = max(1, _KRON_CHUNK // ds ** 4)
    for g0 in range(0, n_g, step):
        prod = torch.bmm(Af[g0:g0 + step], Cf[g0:g0 + step])
        o[g0:g0 + step].add_(prod.view(-1, ds, ds, ds, ds).transpose(2, 3))


def _p2_layer(qg, kg, keep, prune, G_out):
    """One layer. qg (B, G, TQ, d), kg (B, G, T, d); keep (G, ds),
    prune (G, dp); G_out (G, ds^2, ds^2) -> {h (G, ds^2), t2 (G,)}, and
    G[i, l, j, k] = sum_b A_ss[b, i, j] C_ss[b, l, k] added into G_out
    (``_add_kron``): no per-sample (B, ds, ds, ds, ds) product is formed."""
    qS, qP = _take(qg, keep), _take(qg, prune)
    kS, kP = _take(kg, keep), _take(kg, prune)
    A_ss = torch.einsum("bgts,bgtu->gbsu", qS, qS)
    C_ss = torch.einsum("bgts,bgtu->gbsu", kS, kS)
    A_sp = torch.einsum("bgts,bgtp->gbsp", qS, qP)
    C_ps = torch.einsum("bgtp,bgts->gbps", kP, kS)
    _add_kron(G_out, A_ss, C_ss)
    h_vec = torch.einsum("gbsp,gbpu->gsu", A_sp, C_ps).reshape(
        keep.shape[0], -1)
    t2 = torch.einsum("bgtp,bgup->bgtu", qP, kP).square().sum(dim=(0, 2, 3))
    return {"h": h_vec, "t2": t2}


def _p2_layer_complex(qg, kg, keep, prune):
    """One layer of a class-2 unit, over rotary pairs. qg (B, G, TQ, dp),
    kg (B, G, T, dp) complex64; keep (G, ds), prune (G, dp - ds) pair
    indices
    -> {G (G, ds, ds), h (G, ds) complex64, t2 (G,)}: the Hadamard
    reduction, Gd[s, u] = sum_b A_SS[b, s, u] C_SS[b, u, s]."""
    qS, qP = _take(qg, keep), _take(qg, prune)
    kS, kP = _take(kg, keep), _take(kg, prune)
    A_ss = torch.einsum("bgts,bgtu->bgsu", qS.conj(), qS)
    C_ss = torch.einsum("bgts,bgtu->bgsu", kS.conj(), kS)
    A_sp = torch.einsum("bgts,bgtp->bgsp", qS.conj(), qP)
    C_ps = torch.einsum("bgtp,bgts->bgps", kP.conj(), kS)
    Gd = (A_ss * C_ss.transpose(2, 3)).sum(dim=0)
    hd = torch.einsum("bgsp,bgps->gs", A_sp, C_ps)
    t2 = torch.einsum("bgtp,bgup->bgtu", qP, kP.conj()).abs().square() \
        .sum(dim=(0, 2, 3))
    return {"G": Gd, "h": hd, "t2": t2}


def _p2_attn(taps, unit: Unit, keep, prune, acc=None):
    """keep/prune: int64 tensors (L, G, ds) / (L, G, dp) of kept / pruned
    dims (class 1) or rotary pairs (classes 2, 3); (G, ..) for an unstacked
    unit -> class 1: {G (L, G, ds^2, ds^2), h (L, G, ds^2), t2 (L, G)};
    class 2: {G (L, G, ds, ds), h (L, G, ds) complex64, t2 (L, G)}; class
    3: class 2's real parts (fp32).

    ``acc``: the unit's running pass-2 sums. A class-1 unit then adds this
    batch's G into ``acc["G"]`` in place and returns only h and t2 (for
    ``tree_add``); without it a zero G is made and returned."""
    q, k = _qk_taps(taps, unit)
    q, k = q.float(), k.float()
    keep, prune = _stacked(unit, keep), _stacked(unit, prune)
    qg = _group_q(q, unit.n_groups)
    kg = k.permute(0, 1, 3, 2, 4)
    L = q.shape[0]
    if unit.attn_class == 1:
        n_g, ds = keep.shape[1:]
        G = q.new_zeros(L, n_g, ds * ds, ds * ds) if acc is None \
            else _stacked(unit, acc["G"])
        per_layer = [_p2_layer(qg[i], kg[i], keep[i], prune[i], G[i])
                     for i in range(L)]
    else:
        qg, kg = _to_complex_pairs(qg), _to_complex_pairs(kg)
        per_layer = [_p2_layer_complex(qg[i], kg[i], keep[i], prune[i])
                     for i in range(L)]
    out = {key: torch.stack([s[key] for s in per_layer])
           for key in per_layer[0]}
    if unit.attn_class == 1 and acc is None:
        out["G"] = G
    if unit.attn_class == 3:
        out["G"], out["h"] = out["G"].real, out["h"].real
    return _unstack(unit, out)


# ---------------------------------------------------------------------------
# speculative pass-2 reductions (one-traversal calibration)
# ---------------------------------------------------------------------------

def _bgram(x, y):
    """Per-sample rectangular grams through the gram_cross kernel:
    x (..., N, Fx), y (..., N, Fy) -> (..., Fx, Fy) fp32 ``X_b^T Y_b``.
    The kernel folds every leading dim into its work items, so all
    samples, groups and layers take one launch; inputs keep their
    streaming dtype."""
    return gram_ops.gram_cross(x, y)["s2"]


def _rows(M, idx):
    """M (L, B, G, d, e), idx (L, G, c) -> M[l, b, g, idx[l, g], :]."""
    L, B, G, _, e = M.shape
    c = idx.shape[-1]
    return torch.gather(M, 3, idx[:, None, :, :, None].expand(L, B, G, c, e))


def _cols(M, idx):
    """M (L, B, G, e, d), idx (L, G, c) -> M[l, b, g, :, idx[l, g]]."""
    L, B, G, e, _ = M.shape
    c = idx.shape[-1]
    return torch.gather(M, 4, idx[:, None, :, None, :].expand(L, B, G, e, c))


def _pair_gram(R):
    """A per-sample real gram R = X^T X (..., d, d) of interleaved rotary
    pairs -> the complex gram (..., d/2, d/2) of the pairs, Z^H Z with
    z = x + iy: Re = R[x, x] + R[y, y], Im = R[x, y] - R[y, x]."""
    return torch.complex(R[..., 0::2, 0::2] + R[..., 1::2, 1::2],
                         R[..., 0::2, 1::2] - R[..., 1::2, 0::2])


def _p2spec_complex(q, k, unit: Unit, cand):
    """The speculative sums of classes 2 and 3 over rotary pairs
    (complex64). Per (layer, group), with E = A (.) conj(C), A = Q^H Q,
    C = K^H K per sample:
      Gc     (c, c)  cplx  sum_b E[C, C]
      hfull  (c,)    cplx  sum_b sum_p E[C, p]
      t2_tot ()            Re sum_b sum E
    A and C come from the per-sample real grams of the taps, taken in their
    streaming dtype by the gram_cross kernel (``_bgram``, fp32 sums) and
    paired by ``_pair_gram``: the same sums as the reference's complex
    einsums, in another order. Per-sample A and C are (dp, dp), so nothing
    here is large."""
    qg = _group_q(q, unit.n_groups)                   # (L, B, G, TQ, d)
    kg = k.permute(0, 1, 3, 2, 4)                     # (L, B, G, T, d)
    A_ff = _pair_gram(_bgram(qg, qg))                 # (L, B, G, dp, dp)
    C_ff = _pair_gram(_bgram(kg, kg))
    E = A_ff * C_ff.conj()
    Ec = _rows(E, cand)                               # candidate rows
    return {"Gc": _cols(Ec, cand).sum(dim=1),
            "hfull": Ec.sum(dim=(1, 4)),
            "t2_tot": E.real.sum(dim=(1, 3, 4))}


def _p2spec_attn(taps, unit: Unit, cand):
    """Speculative pass-2 sums of one attention unit (classes 2 and 3: see
    ``_p2spec_complex``).

    cand: int64 candidate keep-indices (L, G, c), dims (class 1) or rotary
    pairs (classes 2, 3), fixed for the whole traversal; (G, c) and
    leaves without the layer axis for an unstacked unit. Per (layer,
    group) of a class-1 unit:
      Gc     (c, c, c, c)  sum_b A_CC (x) C_CC, order [i, l, j, k]
      Hfull  (c, c)        sum_b (Q_C^T Q)(K^T K_C)
      t2_tot ()            sum_b <Q^T Q, K^T K>  (full Frobenius)
    The taps keep their streaming dtype into ``_bgram``; the candidate
    gathers run on its fp32 results. Gc is contracted over the batch inside
    one product, so no per-sample (B, c, c, c, c) tensor is formed."""
    q, k = _qk_taps(taps, unit)
    cand = _stacked(unit, cand)
    if unit.attn_class != 1:
        return _unstack(unit, _p2spec_complex(q, k, unit, cand))
    qg = _group_q(q, unit.n_groups)                   # (L, B, G, TQ, d)
    kg = k.permute(0, 1, 3, 2, 4)                     # (L, B, G, T, d)
    A_ff = _bgram(qg, qg)                             # (L, B, G, d, d)
    C_ff = _bgram(kg, kg)
    A_cf = _rows(A_ff, cand)                          # Q_C^T Q (L,B,G,c,d)
    C_fc = _cols(C_ff, cand)                          # K^T K_C (L,B,G,d,c)
    A_cc = _cols(A_cf, cand)
    C_cc = _rows(C_fc, cand)
    return _unstack(unit, {
        "Gc": torch.einsum("xbgij,xbglk->xgiljk", A_cc, C_cc),
        "Hfull": torch.einsum("xbgcp,xbgpu->xgcu", A_cf, C_fc),
        "t2_tot": (A_ff * C_ff).sum(dim=(1, 3, 4))})


def spec_pass2_reduce(taps: Dict, units: List[Unit], spec_plan: Dict) -> Dict:
    """Per-batch speculative pass-2 sums for every attention unit with a
    candidate set in ``spec_plan`` ({unit.name: (L, G, c) int64})."""
    out = {}
    for u in units:
        if u.kind in ("attn", "mla", "cross") and u.name in spec_plan:
            out[u.name] = _p2spec_attn(taps, u, spec_plan[u.name])
    return out


def spec_reconstruct(spec, cand, keep, unit: Unit) -> Dict:
    """Exact pass-2 statistics of ``keep`` from the speculative sums.

    Host numpy with float64 (complex128 for classes 2 and 3)
    intermediates (``repro.core.stats.spec_reconstruct``): valid when
    every group's keep-set lies inside its candidate set
    (``ranking.covers``); both are sorted. Returns numpy ``{"G", "h",
    "t2"}`` of the shapes and dtypes (fp32, complex64 for class 2; class 3
    takes the real parts, fp32) that a pass-2 traversal gives. The
    complement terms are differences of candidate and full sums, not
    direct sums over the pruned set, so they differ from pass 2 in rounding
    only (``t2`` is clamped at 0)."""
    cand = np.asarray(cand)
    keep = np.asarray(keep)
    lead = cand.shape[:-1]                  # (L, G)
    c, n = cand.shape[-1], keep.shape[-1]
    cf = cand.reshape(-1, c)
    kf = keep.reshape(-1, n)
    rows = cf.shape[0]
    if unit.attn_class != 1:
        out = _spec_reconstruct_complex(spec, cf, kf, lead)
        if unit.attn_class == 3:            # real restriction of class 2
            out["G"], out["h"] = (out[k].real.astype(np.float32)
                                  for k in ("G", "h"))
        return out
    Gc = np.asarray(spec["Gc"], np.float64).reshape(rows, c, c, c, c)
    Hf = np.asarray(spec["Hfull"], np.float64).reshape(rows, c, c)
    tt = np.asarray(spec["t2_tot"], np.float64).reshape(rows)
    Gs, hs, t2s = [], [], []
    for r in range(rows):
        pos = np.searchsorted(cf[r], kf[r])
        Gq = Gc[r]
        Gs.append(Gq[np.ix_(pos, pos, pos, pos)].reshape(n * n, n * n))
        # T_s = Gc[:, s, s, :] is the per-keep outer-product slice;
        # subtracting it from H_full leaves the pruned-set cross term
        sum_t = Gq[:, pos, pos, :].sum(axis=1)
        hs.append((Hf[r] - sum_t)[np.ix_(pos, pos)].reshape(-1))
        e_cc = np.einsum("iijj->ij", Gq)
        t2 = tt[r] - 2.0 * np.diagonal(Hf[r])[pos].sum() \
            + e_cc[np.ix_(pos, pos)].sum()
        t2s.append(max(t2, 0.0))
    G_arr, h_arr = np.stack(Gs), np.stack(hs)
    return {"G": G_arr.astype(np.float32).reshape(lead + G_arr.shape[1:]),
            "h": h_arr.astype(np.float32).reshape(lead + h_arr.shape[1:]),
            "t2": np.asarray(t2s, np.float32).reshape(lead)}


def _spec_reconstruct_complex(spec, cf, kf, lead):
    """Classes 2, 3 of ``spec_reconstruct``: G = Gc[S, S], h = hfull[S] - the
    row sums of G (the pruned-set cross term), t2 = t2_tot - 2 Re
    sum_S hfull + Re sum G. cf (rows, c), kf (rows, n) sorted indices."""
    rows, c = cf.shape
    Gc = np.asarray(spec["Gc"], np.complex128).reshape(rows, c, c)
    hf = np.asarray(spec["hfull"], np.complex128).reshape(rows, c)
    tt = np.asarray(spec["t2_tot"], np.float64).reshape(rows)
    Gs, hs, t2s = [], [], []
    for r in range(rows):
        pos = np.searchsorted(cf[r], kf[r])
        Gd = Gc[r][np.ix_(pos, pos)]
        Gs.append(Gd)
        hs.append(hf[r][pos] - Gd.sum(axis=1))
        t2 = tt[r] - 2.0 * np.real(hf[r][pos].sum()) + np.real(Gd.sum())
        t2s.append(max(t2, 0.0))
    G_arr, h_arr = np.stack(Gs), np.stack(hs)
    return {"G": G_arr.astype(np.complex64).reshape(lead + G_arr.shape[1:]),
            "h": h_arr.astype(np.complex64).reshape(lead + h_arr.shape[1:]),
            "t2": np.asarray(t2s, np.float32).reshape(lead)}


# ---------------------------------------------------------------------------
# per-batch reductions over every unit
# ---------------------------------------------------------------------------

def pass1_reduce(taps: Dict, units: List[Unit],
                 acc: Dict | None = None) -> Dict:
    """Per-batch pass-1 sums: mlp, rwkv_mlp, mamba -> {n, s1, s2, na}; moe
    -> per expert {n, s1, s2, na} (+ {yn, ys1, ys2}); attn, mla, cross ->
    {rank, n}.
    With the running accumulator ``acc``, each unit's sums are added into
    it in place as soon as they are reduced and left out of the result, so
    that no two units' batch moments are held at once (large per-expert
    s2 a chunk at a time: ``_expert_moments``)."""
    out = {}
    for u in units:
        if u.kind in ("mlp", "rwkv_mlp", "mamba"):
            st = _p1_mlp(taps, u)
        elif u.kind == "moe":
            st = _p1_moe(taps, u, None if acc is None else acc[u.name])
        elif u.kind in ("attn", "mla", "cross"):
            st = _p1_attn(taps, u)
        else:
            raise ValueError(f"unit {u.name}: unknown kind {u.kind!r}")
        if acc is None:
            out[u.name] = st
        else:
            tree_add(acc[u.name], st)
    return out


def pass2_reduce(taps: Dict, units: List[Unit], plan: Dict,
                 acc: Dict | None = None) -> Dict:
    """Per-batch pass-2 sums of every attention unit in ``plan``; with the
    running accumulator ``acc``, class-1 units add their G into it in
    place and leave it out of the result (``_p2_attn``)."""
    out = {}
    for u in units:
        if u.kind in ("attn", "mla", "cross") and u.name in plan:
            keep, prune = plan[u.name]
            out[u.name] = _p2_attn(taps, u, keep, prune,
                                   None if acc is None else acc[u.name])
    return out


def tree_add(a, b):
    """a + b leafwise; ``a`` is updated in place (it is the running
    accumulator, and its largest leaf, pass 2's G, is hundreds of MB at
    DeiT-Base), ``None`` starts a new one. Raises on a leaf whose shape
    differs (a restored accumulator of another configuration), which an
    in-place add could otherwise broadcast."""
    if a is None:
        return b
    for k, v in b.items():
        if isinstance(v, dict):
            tree_add(a[k], v)
        elif a[k].shape != v.shape:
            raise ValueError(f"accumulator leaf {k}: shape "
                             f"{tuple(a[k].shape)} != {tuple(v.shape)}")
        else:
            a[k].add_(v)
    return a
