"""Ranking policies (paper §3.3, Alg. 2/4, appendix E).

MLP channels:
  'act'      E_i = E[x_i^2]                 (activation energy)
  'mag'      ||W_{:,i}||_2                  (second-matrix column norm)
  'combined' E_i * ||W_{:,i}||_2            (default — best in the paper)
  'active'   P(|x_i| > eps)                 (activation frequency)

Attention head dims (per kv group): logit energy s_j = E[||q_j||^2 ||k_j||^2]
(accumulated in pass 1; complex-pair energies for rope archs).

Selection returns sorted kept/pruned index arrays; all scores are reduced on
host (numpy) — they are tiny compared to the statistics themselves.
"""
from __future__ import annotations

import numpy as np

POLICIES = ("act", "mag", "combined", "active")


def _select(scores: np.ndarray, keep_n: int):
    """scores: (..., F) -> kept (..., keep_n), pruned (..., F-keep_n), sorted."""
    order = np.argsort(-scores, axis=-1, kind="stable")
    keep = np.sort(order[..., :keep_n], axis=-1)
    prune = np.sort(order[..., keep_n:], axis=-1)
    return keep.astype(np.int32), prune.astype(np.int32)


def rank_mlp(s2_diag, n, na, col, keep_n: int, policy: str = "combined"):
    """Kept/pruned MLP channels from the diagonal of the pass-1 second
    moment s2 (..., F), the counts ``n`` and ``na`` and the second matrix's
    column norms ``col`` (..., F): all that ranking reads of the (F, F)
    moments. Float64 arithmetic."""
    n = np.maximum(np.asarray(n, np.float64), 1.0)
    if policy == "act":
        scores = np.asarray(s2_diag, np.float64) / n[..., None]
    elif policy == "mag":
        scores = np.asarray(col, np.float64)
    elif policy == "combined":
        scores = (np.asarray(s2_diag, np.float64) / n[..., None]
                  * np.asarray(col, np.float64))
    elif policy == "active":
        scores = np.asarray(na, np.float64) / n[..., None]
    else:
        raise ValueError(policy)
    return _select(scores, keep_n)


def rank_attn(stats, keep_n: int):
    """stats['rank']: (..., G, d or d/2 pairs) energy products."""
    return _select(np.asarray(stats["rank"], np.float64), keep_n)


def expert_scores(stats) -> np.ndarray:
    """Per-expert contribution energy from pass-1 moments.

    ``stats['ys2']`` is the (..., (E+1)D, (E+1)D) second moment of the MoE
    block input concatenated with the gate-weighted expert contributions
    (repro.core.stats._p1_moe); the trace of expert e's diagonal block is
    ``E[||c_te||^2]`` — how much of the MoE output's energy that expert
    carries under the calibration distribution. Block 0 (the input) is
    skipped.
    """
    n = np.maximum(np.asarray(stats["yn"], np.float64), 1.0)
    s2 = np.asarray(stats["ys2"], np.float64)
    e_num = np.asarray(stats["n"], np.float64).shape[-1]   # (..., E) counts
    diag = np.einsum("...ii->...i", s2)                     # (..., (E+1)D)
    per = diag.reshape(diag.shape[:-1] + (e_num + 1, -1)).sum(-1)
    return per[..., 1:] / n[..., None]


def rank_experts(stats, keep_n: int):
    """Kept/pruned routed-expert indices by contribution energy."""
    return _select(expert_scores(stats), keep_n)


# ---------------------------------------------------------------------------
# speculative candidate selection (one-traversal calibration)
# ---------------------------------------------------------------------------

def candidate_count(full: int, keep_n: int, margin: float) -> int:
    """Candidate keep-set size for speculative pass-2 accumulation:
    ``keep_n`` final slots plus a safety margin, clipped to the unit width.

    The margin buys hit-rate: the final keep-set is chosen from the *full*
    calibration set's ranking scores, while candidates are chosen from the
    running scores of the stream prefix — the top-``keep_n`` sets differ
    wherever scores are close, and the extra ``keep_n * margin`` slots
    absorb that churn (docs/pipeline.md quantifies margin vs hit-rate)."""
    assert margin >= 0.0, margin
    c = int(np.ceil(keep_n * (1.0 + margin)))
    return max(keep_n, min(full, c))


def candidate_attn(stats, keep_n: int, margin: float) -> np.ndarray:
    """Top-k candidate keep-set per kv group from *running* ranking scores.

    stats['rank']: (..., G, d or pairs) energy sums accumulated so far
    (any stream prefix — the scores only need to get the top-k set right,
    not converged values). Returns sorted int32 candidate indices
    (..., G, c) with ``c = candidate_count(full, keep_n, margin)``, a
    superset-in-expectation of the final ``rank_attn`` keep-set."""
    scores = np.asarray(stats["rank"], np.float64)
    c = candidate_count(scores.shape[-1], keep_n, margin)
    order = np.argsort(-scores, axis=-1, kind="stable")
    return np.sort(order[..., :c], axis=-1).astype(np.int32)


def covers(cand: np.ndarray, keep: np.ndarray) -> bool:
    """True iff every group's final keep-set is inside its candidate set —
    the speculative *hit* condition. cand: (..., G, c), keep: (..., G, n),
    matching leading dims, both index arrays."""
    c2 = np.asarray(cand).reshape(-1, cand.shape[-1])
    k2 = np.asarray(keep).reshape(-1, keep.shape[-1])
    assert c2.shape[0] == k2.shape[0], (cand.shape, keep.shape)
    return all(bool(np.isin(k, c).all()) for c, k in zip(c2, k2))
