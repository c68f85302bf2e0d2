"""Closed-form CORP solvers and folds (``repro.core.solve``), classes 1,
2 and 3.

MLP affine compensation (paper Eq. 9):
    B = Sigma_PS (Sigma_SS + lam I)^-1,   c = mu_P - B mu_S
Attention logit compensation, class 1 (Eq. 15, no rope / no qk-norm):
    (G + lam I) vec(M) = h, folded as I + M = U S V^T into
    W_Q U S^{1/2} and W_K V S^{1/2} (Eq. 16).
Class 2 (rope, no qk-norm): a diagonal complex compensator m over the kept
rotary pairs, (Gd + lam I) m = hd in complex64, folded per pair as the
2x2 real blocks of a = sqrt(rho) e^{i phi/2} into W_Q and b = sqrt(rho)
e^{-i phi/2} into W_K (a conj(b) = 1 + m = rho e^{i phi}).
Class 3 (rope + qk-norm): its real restriction, (Gd + lam I) m = hd over
real-reduced systems, folded into the qk-norm scales as sign(1 + m)
sqrt|1 + m| (Q) and sqrt|1 + m| (K), whose product is 1 + m.

Every function takes a leading batch of independent systems (the stacked
layers, or layers x groups) and solves them at once; the Cholesky factor
and solve are ``torch.linalg.cholesky`` / ``torch.cholesky_solve``, the
complex and real-diagonal ones ``torch.linalg.solve``.
"""
from __future__ import annotations

import torch


def mlp_cov(stats):
    """{'n' (R,), 's1' (R,F), 's2' (R,F,F)} -> mu (R,F), Sigma (R,F,F).
    Sigma is formed in place past one new (R,F,F) tensor (9 GB at
    Qwen2-1.5B's 28 x 8960^2)."""
    n = stats["n"].clamp_min(1.0)
    mu = stats["s1"] / n[:, None]
    sigma = stats["s2"] / n[:, None, None]
    for r in range(sigma.shape[0]):
        sigma[r].sub_(torch.outer(mu[r], mu[r]))
    return mu, sigma


def gather_rows(a, idx):
    """a (R, F, ...), idx (R, n) -> a[r, idx[r]] (R, n, ...)."""
    shape = idx.shape + a.shape[2:]
    return torch.gather(a, 1, idx.reshape(idx.shape + (1,) * (a.ndim - 2))
                        .expand(shape))


def gather_cols(a, idx):
    """a (R, M, F), idx (R, n) -> a[r, :, idx[r]] (R, M, n)."""
    return torch.gather(a, 2, idx[:, None, :].expand(a.shape[0], a.shape[1],
                                                     idx.shape[1]))


def ridge_affine(mu, sigma, keep, prune, lam):
    """Closed-form (B, c) of Eq. 9 plus the terms J* needs.

    mu (R,F), sigma (R,F,F), keep (R,ds), prune (R,dp) int64, lam (R,).
    Returns B (R,dp,ds), c (R,dp), mu_p, sigma_pp and the Schur residual
    sigma_p_given_s."""
    S_SS = gather_cols(gather_rows(sigma, keep), keep)
    S_PS = gather_cols(gather_rows(sigma, prune), keep)
    S_PP = gather_cols(gather_rows(sigma, prune), prune)
    eye = torch.eye(keep.shape[1], dtype=sigma.dtype, device=sigma.device)
    reg = S_SS + lam[:, None, None] * eye
    chol = torch.linalg.cholesky(reg)
    B = torch.cholesky_solve(S_PS.transpose(1, 2), chol).transpose(1, 2)
    mu_s, mu_p = gather_rows(mu, keep), gather_rows(mu, prune)
    c = mu_p - (B @ mu_s[:, :, None])[:, :, 0]
    return {"B": B, "c": c, "mu_p": mu_p, "sigma_pp": S_PP,
            "sigma_p_given_s": S_PP - B @ S_PS.transpose(1, 2)}


def mlp_distortion(sol, w_p):
    """J* and gain (Eqs. 11/64). w_p: (R, dp, D) pruned rows of the second
    matrix (y = h @ W, W (F, D))."""
    wp = w_p.float()
    j_star = ((sol["sigma_p_given_s"] @ wp) * wp).sum(dim=(1, 2))
    j_uncomp = ((sol["sigma_pp"] @ wp) * wp).sum(dim=(1, 2)) \
        + (sol["mu_p"][:, None, :] @ wp)[:, 0].square().sum(dim=1)
    return {"j_star": j_star, "j_uncomp": j_uncomp, "gain": j_uncomp - j_star}


def solve_full_m(G, h, t2, lam):
    """Class 1: vec(M) = (G + lam I)^-1 h (row-major vec).

    G (R, ds^2, ds^2), h (R, ds^2), t2 (R,), lam (R,)."""
    d2 = G.shape[-1]
    ds = int(round(d2 ** 0.5))
    eye = torch.eye(d2, dtype=G.dtype, device=G.device)
    chol = torch.linalg.cholesky(G + lam[:, None, None] * eye)
    m = torch.cholesky_solve(h[:, :, None], chol)[:, :, 0]
    hm = (h * m).sum(dim=1)
    return {"M": m.reshape(-1, ds, ds), "j_star": t2 - hm, "j_uncomp": t2,
            "rho2": torch.where(t2 > 0, hm / t2, torch.zeros_like(t2))}


def fold_full_m(M):
    """I + M = U S V^T -> (Fq, Fk) with Fq Fk^T = I + M (Eq. 16).
    The SVD is unique only up to paired signs: compare model outputs, not
    the folded weights."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    u, s, vh = torch.linalg.svd(eye + M)
    sq = s.sqrt()
    return u * sq[:, None, :], vh.transpose(1, 2) * sq[:, None, :]


def solve_diag_complex(Gd, hd, t2, lam):
    """Class 2: m = (Gd + lam I)^-1 hd over complex pairs.

    Gd (R, dp, dp) and hd (R, dp) complex64, t2 (R,), lam (R,) real."""
    eye = torch.eye(Gd.shape[-1], dtype=Gd.dtype, device=Gd.device)
    m = torch.linalg.solve(Gd + lam[:, None, None].to(Gd.dtype) * eye,
                           hd[:, :, None])[:, :, 0]
    gain = (hd.conj() * m).sum(dim=1).real
    return {"m": m, "j_star": t2 - gain, "j_uncomp": t2,
            "rho2": torch.where(t2 > 0, gain / t2, torch.zeros_like(t2))}


def solve_diag_real(Gd, hd, t2, lam):
    """Class 3: m = (Gd + lam I)^-1 hd, the real restriction of class 2.

    Gd (R, dp, dp), hd (R, dp) real (already real-reduced), t2, lam (R,)."""
    eye = torch.eye(Gd.shape[-1], dtype=Gd.dtype, device=Gd.device)
    m = torch.linalg.solve(Gd + lam[:, None, None] * eye,
                           hd[:, :, None])[:, :, 0]
    gain = (hd * m).sum(dim=1)
    return {"m": m, "j_star": t2 - gain, "j_uncomp": t2,
            "rho2": torch.where(t2 > 0, gain / t2, torch.zeros_like(t2))}


def fold_diag_real(m):
    """1 + m real -> per-pair scales (Q: sign(1 + m) sqrt|1 + m|, K:
    sqrt|1 + m|), whose product is 1 + m; the sign goes to the Q side."""
    w = 1.0 + m
    s = w.abs().sqrt()
    return torch.sign(w) * s, s


def fold_diag_complex(m):
    """1 + m = rho e^{i phi} -> per-pair 2x2 real blocks (..., dp, 2, 2) of
    a = sqrt(rho) e^{i phi/2} (Q) and b = sqrt(rho) e^{-i phi/2} (K): each
    right-multiplies the (even, odd) row vector of its kept rotary pair."""
    w = 1.0 + m
    rho = w.abs().sqrt()
    half = w.angle() / 2.0

    def blocks(z):
        re, im = z.real, z.imag
        # complex right-multiplication as a 2x2 acting on (x, y) rows
        return torch.stack([torch.stack([re, im], -1),
                            torch.stack([-im, re], -1)], -2)
    return blocks(torch.polar(rho, half)), blocks(torch.polar(rho, -half))


def pairs_to_dims(pair_idx):
    """Rotary pair indices (..., p) -> interleaved dim indices (..., 2p)."""
    even = 2 * pair_idx
    return torch.stack([even, even + 1], dim=-1).reshape(
        pair_idx.shape[:-1] + (2 * pair_idx.shape[-1],))
