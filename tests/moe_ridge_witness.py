"""Can CORP's ridge compensation help a seeded routed expert? A CPU run of
the port's own MLP fold on one expert of qwen3-moe's shape, scaled down.

    PYTHONPATH=src python tests/moe_ridge_witness.py

The expert is a GLU MLP drawn as the port's ``init_moe`` draws one (normal
weights over sqrt(E), E = 128) at d_model 512 and d_expert 192, the ratio
1536 / 4096 of qwen3-moe-235b-a22b, fp32; its inputs are standard normal
rows (the rms-normed block input). Half the hidden channels are kept
(``ranking.rank_mlp``, policy "combined") and the rest folded by
``pruner._fold_mlp_block`` from the moments of N calibration rows, N a
multiple of the 96 kept channels. Each line gives the relative error of
the pruned expert's output to the dense one, plain and compensated, on
4096 held-out rows and on the first N/32 calibration rows (in-sample, as
``chip_smoke.py``'s gate reads 4 of its 128 batches).
"""
from __future__ import annotations

import torch

from repro_torch.core import ranking
from repro_torch.core.pruner import PruneConfig, _fold_mlp_block
from repro_torch.core.units import Unit
from repro_torch.kernels.gram import ref as gram_ref

D, F, E = 512, 192, 128
KEEP = F // 2
UNIT = Unit("expert", "seg0", "p0", True, 1, "mlp", "seg0/p0",
            d_hidden=F)


def expert(gen):
    def w(*shape):
        return torch.randn(shape, generator=gen) / E ** 0.5
    return {"wg": w(1, D, F), "wu": w(1, D, F), "wd": w(1, F, D)}


def hidden(p, x):
    return torch.nn.functional.silu(x @ p["wg"][0]) * (x @ p["wu"][0])


def rel(a, b):
    return float((a - b).norm() / b.norm())


def main():
    gen = torch.Generator().manual_seed(0)
    p = expert(gen)
    held = torch.randn(4096, D, generator=gen)
    for per_kept in (5, 21, 100, 400):
        n = per_kept * KEEP
        x = torch.randn(n, D, generator=gen)
        h = hidden(p, x)
        g = gram_ref.gram(h[None])
        stats = {"n": torch.full((1,), float(n)), "s1": g["s1"],
                 "s2": g["s2"],
                 "na": (h.abs() > 1e-2).sum(0, dtype=torch.float32)[None]}
        col = torch.linalg.vector_norm(p["wd"].double(), dim=-1)
        keep, prune = ranking.rank_mlp(
            torch.diagonal(stats["s2"], dim1=-2, dim2=-1).numpy(),
            stats["n"].numpy(), stats["na"].numpy(), col.numpy(), KEEP)
        out = []
        for comp in (False, True):
            new = _fold_mlp_block(dict(p), stats, UNIT,
                                  PruneConfig(compensate=comp), keep, prune,
                                  {})
            errs = []
            for rows in (held, x[: n // 32]):
                hh = hidden(p, rows)
                want = hh @ p["wd"][0]
                got = hh[:, torch.as_tensor(keep[0]).long()] @ new["wd"][0] \
                    + new.get("bd", torch.zeros(1, D))[0]
                errs.append(rel(got, want))
            out.append(errs)
        print(f"{per_kept:4d} rows a kept channel (N {n:6d}): held-out "
              f"plain {out[0][0]:.4f} compensated {out[1][0]:.4f}; "
              f"in-sample plain {out[0][1]:.4f} compensated "
              f"{out[1][1]:.4f}")


if __name__ == "__main__":
    main()
