"""Can CORP's ridge compensation help a seeded routed expert? A CPU run of
the MLP fold on one expert of a MoE config's shape, scaled down.

    PYTHONPATH=src python tests/moe_ridge_witness.py [--shape deepseek-v3]
        [--jax]

The expert is a GLU MLP drawn as the port's ``init_moe`` draws one (normal
weights over sqrt(E)), fp32: by default at d_model 512 and d_expert 192,
the ratio 1536 / 4096 of qwen3-moe-235b-a22b (E = 128); ``--shape
deepseek-v3`` at d_model 896 and d_expert 256, the ratio 2048 / 7168 of
deepseek-v3-671b (E = 256). Its inputs are standard normal rows (the
rms-normed block input). Half the hidden channels are kept
(``ranking.rank_mlp``, policy "combined") and the rest folded by
``pruner._fold_mlp_block`` from the moments of N calibration rows, N a
multiple of the kept channels. Each line gives the relative error of the
pruned expert's output to the dense one, plain and compensated, on 4096
held-out rows and on the first N/32 calibration rows (in-sample, as
``chip_smoke.py``'s gate reads 4 of its 128 batches). ``--jax`` also
folds the same weights and moments with the JAX package
(``repro.core.pruner._fold_mlp_block``, its own ranking) and prints its
line below the port's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import ranking
from repro_torch.core.pruner import PruneConfig, _fold_mlp_block
from repro_torch.core.units import Unit
from repro_torch.kernels.gram import ref as gram_ref

# (d_model, d_expert, experts, rows a kept channel) of each shape
SHAPES = {"qwen3-moe": (512, 192, 128, (5, 21, 100, 400)),
          "deepseek-v3": (896, 256, 256, (4, 14, 100, 400))}


def expert(gen, D, F, E):
    def w(*shape):
        return torch.randn(shape, generator=gen) / E ** 0.5
    return {"wg": w(1, D, F), "wu": w(1, D, F), "wd": w(1, F, D)}


def jax_fold(p, stats, keep_n, comp):
    """JAX's ranking and ``_fold_mlp_block`` on the same weights and
    moments: (kept channels, folded ``wd``, ``bd`` or None) as torch."""
    import jax.numpy as jnp
    from repro.core import pruner as jax_pruner
    from repro.core import ranking as jax_ranking
    from repro.core.units import Unit as JaxUnit
    st = {k: np.asarray(v) for k, v in stats.items()}
    keep, prune = jax_ranking.rank_mlp(st, p["wd"].numpy(), keep_n)
    unit = JaxUnit("expert", "seg0", "p0", True, 1, "mlp", "seg0/p0",
                   d_hidden=p["wd"].shape[1])
    new = jax_pruner._fold_mlp_block(
        {k: jnp.asarray(v.numpy()) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in st.items()}, unit,
        jax_pruner.PruneConfig(compensate=comp), keep, prune, {})
    bd = new.get("bd")
    return (keep, torch.from_numpy(np.array(new["wd"])),
            None if bd is None else torch.from_numpy(np.array(bd)))


def hidden(p, x):
    return torch.nn.functional.silu(x @ p["wg"][0]) * (x @ p["wu"][0])


def rel(a, b):
    return float((a - b).norm() / b.norm())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", default="qwen3-moe", choices=sorted(SHAPES))
    ap.add_argument("--jax", action="store_true",
                    help="also fold with the JAX package")
    args = ap.parse_args()
    D, F, E, per = SHAPES[args.shape]
    keep_n = F // 2
    unit = Unit("expert", "seg0", "p0", True, 1, "mlp", "seg0/p0",
                d_hidden=F)
    gen = torch.Generator().manual_seed(0)
    p = expert(gen, D, F, E)
    held = torch.randn(4096, D, generator=gen)
    for per_kept in per:
        n = per_kept * keep_n
        x = torch.randn(n, D, generator=gen)
        h = hidden(p, x)
        g = gram_ref.gram(h[None])
        stats = {"n": torch.full((1,), float(n)), "s1": g["s1"],
                 "s2": g["s2"],
                 "na": (h.abs() > 1e-2).sum(0, dtype=torch.float32)[None]}
        col = torch.linalg.vector_norm(p["wd"].double(), dim=-1)
        keep, prune = ranking.rank_mlp(
            torch.diagonal(stats["s2"], dim1=-2, dim2=-1).numpy(),
            stats["n"].numpy(), stats["na"].numpy(), col.numpy(), keep_n)
        folds = {"port": []}
        for comp in (False, True):
            new = _fold_mlp_block(dict(p), {k: v.clone() for k, v in
                                            stats.items()}, unit,
                                  PruneConfig(compensate=comp), keep, prune,
                                  {})
            folds["port"].append((keep, new["wd"], new.get("bd")))
        if args.jax:
            folds["jax"] = [jax_fold(p, stats, keep_n, comp)
                            for comp in (False, True)]
        for pkg, pair in folds.items():
            out = []
            for kept, wd, bd in pair:
                errs = []
                for rows in (held, x[: n // 32]):
                    hh = hidden(p, rows)
                    want = hh @ p["wd"][0]
                    got = hh[:, torch.as_tensor(kept[0]).long()] @ wd[0] \
                        + (torch.zeros(1, D) if bd is None else bd)[0]
                    errs.append(rel(got, want))
                out.append(errs)
            print(f"{args.shape} {pkg:4s} {per_kept:4d} rows a kept channel "
                  f"(N {n:6d}): held-out plain {out[0][0]:.4f} compensated "
                  f"{out[1][0]:.4f}; in-sample plain {out[0][1]:.4f} "
                  f"compensated {out[1][1]:.4f}")


if __name__ == "__main__":
    main()
