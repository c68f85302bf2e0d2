"""CORP pruning entry point of the port (``repro.launch.prune``).

    PYTHONPATH=src python -m repro_torch.launch.prune --arch deit-base \\
        --sparsity 0.5 --calib 128 --calib-batch 16 --out /tmp/pruned

Initialises dense DeiT parameters from seed 0 (no pretrained weights are in
the repository), runs the one-shot CORP pipeline over the synthetic
calibration stream on the GPU (``--device cpu`` for the plain PyTorch path)
and, with ``--out``, writes the pruned checkpoint in the JAX package's
layout plus ``report.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import resolve_config
from repro_torch.core import PruneConfig, corp_prune
from repro_torch.data import calib_stream
from repro_torch.models import build_model


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="One-shot CORP pruning over a calibration stream")
    ap.add_argument("--arch", required=True,
                    help="DeiT config name, e.g. deit-base; a '-reduced' "
                         "suffix shrinks it for smoke runs")
    ap.add_argument("--sparsity", type=float, default=0.5,
                    help="fraction of MLP hidden dims and attention qk dims "
                         "to REMOVE (the per-kind flags below win)")
    ap.add_argument("--mlp-sparsity", type=float, default=None,
                    help="override --sparsity for MLP hidden channels "
                         "(0 disables MLP pruning)")
    ap.add_argument("--attn-sparsity", type=float, default=None,
                    help="override --sparsity for attention qk dims "
                         "(0 disables attention pruning)")
    ap.add_argument("--calib", type=int, default=128,
                    help="number of calibration samples (unlabeled)")
    ap.add_argument("--calib-batch", type=int, default=8,
                    help="calibration batch size")
    ap.add_argument("--rank-policy", default="combined",
                    choices=["act", "mag", "combined", "active"],
                    help="MLP ranking statistic (core.ranking.mlp_scores)")
    ap.add_argument("--no-compensate", action="store_true",
                    help="rank-only baseline: prune without the closed-form "
                         "ridge compensation (paper ablation)")
    ap.add_argument("--round-to", type=int, default=1,
                    help="round kept counts down to a multiple")
    ap.add_argument("--lam", type=float, default=1e-4,
                    help="ridge strength, relative to mean(diag(Sigma))")
    ap.add_argument("--ckpt-in", default=None,
                    help="dense checkpoint to load (not ported yet)")
    ap.add_argument("--out", default=None,
                    help="output dir for the pruned checkpoint + "
                         "report.json (print-only when omitted)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; raises without it)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns the dense and pruned params, configs and the
    report, for callers that drive it in-process."""
    args = parse_args(argv)
    if args.ckpt_in:
        raise NotImplementedError("--ckpt-in is not ported; see "
                                  "repro.launch.prune --ckpt-in")
    device = resolve_device(args.device)
    cfg = resolve_config(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    pc = PruneConfig(
        mlp_sparsity=(args.mlp_sparsity if args.mlp_sparsity is not None
                      else args.sparsity),
        attn_sparsity=(args.attn_sparsity if args.attn_sparsity is not None
                       else args.sparsity),
        lam=args.lam,
        rank_policy=args.rank_policy,
        compensate=not args.no_compensate,
        round_to=args.round_to,
    )
    stream = calib_stream(cfg, n_samples=args.calib, batch=args.calib_batch,
                          device=device)
    t0 = time.time()
    new_params, new_cfg, report = corp_prune(model, params, stream, pc,
                                             progress=print)
    dt = time.time() - t0
    timing = ", ".join(f"{k} {v:.3f}s" for k, v in report["timing"].items())
    print(f"[prune] done in {dt:.1f}s on {device} ({timing}); "
          f"d_ff {cfg.d_ff} -> {new_cfg.eff_d_ff}, "
          f"qk {cfg.qk_full} -> {new_cfg.eff_qk}")
    if args.out:
        save_checkpoint(args.out, 0, new_params,
                        extra={"config": new_cfg.name,
                               "mlp_sparsity": pc.mlp_sparsity,
                               "attn_sparsity": pc.attn_sparsity,
                               "expert_sparsity": pc.expert_sparsity})
        with open(os.path.join(args.out, "report.json"), "w") as f:
            json.dump({u: {k: v.tolist() for k, v in d.items()}
                       for u, d in report["units"].items()}, f, indent=1)
        print(f"[prune] saved to {args.out}")
    return {"model": model, "params": params, "pruned_params": new_params,
            "pruned_cfg": new_cfg, "report": report}


if __name__ == "__main__":
    main()
