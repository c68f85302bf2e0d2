"""CORP pruning entry point of the port (``repro.launch.prune``).

    PYTHONPATH=src python -m repro_torch.launch.prune --arch deit-base \\
        --sparsity 0.5 --calib 128 --calib-batch 16 --out /tmp/pruned

    PYTHONPATH=src python -m repro_torch.launch.prune \
        --arch qwen2-1.5b-reduced --calib-seq 16 --device cpu --out /tmp/lm

    PYTHONPATH=src python -m repro_torch.launch.prune \
        --arch qwen3-moe-235b-a22b-reduced --sparsity 0.5 \
        --expert-sparsity 0.5 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.prune \
        --arch deit-base-reduced --mesh 2x2 --calib-sharded \
        --dist-backend gloo --device cpu --out /tmp/sharded

Initialises dense parameters (DeiT, Qwen2-1.5B, granite-8b, deepseek-7b,
gemma3-1b, RWKV6-3B, internvl2-26b, qwen3-moe-235b-a22b, deepseek-v3-671b,
jamba-1.5-large-398b or seamless-m4t-large-v2) from seed 0
(no pretrained weights are in the repository), or loads them from a train
checkpoint (``--ckpt-in``), runs the one-shot CORP pipeline over the
synthetic calibration stream (images, or ``--calib-seq`` tokens a sequence
from the reference's Markov chain, whose V x V table suits reduced
vocabularies only, with 8 patch embeddings a sequence for internvl2-26b
and ``--calib-seq`` encoder frames a sequence for seamless-m4t-large-v2)
on the GPU (``--device cpu`` for the plain PyTorch
path) and, with ``--out``,
writes the pruned checkpoint in the JAX package's layout plus
``report.json``. ``--one-traversal``, ``--stats-dtype bfloat16`` and
resumable statistics checkpoints (``--calib-ckpt``) are ported.

``--mesh DxM`` (or ``PxDxM``) runs the pipeline on prod(shape) ranks
(``launch.mesh.launch``: spawned, or joined under torchrun), each with the
same parameters and stream; alone it gives the unsharded result, as the JAX
CLI's mesh context does. ``--calib-sharded`` shards calibration over the
mesh (``corp_prune(mesh=)``): each rank builds the dense tree in host
memory, and each pass places only the rank's blocks of it on its card and
runs the forward tensor-parallel; the statistics are sharded, and every
rank is checked to fold bitwise the same parameters. The mesh's first rank
prints and writes, and prints each rank's parameter bytes on its card
against the whole tree's. ``--dist-backend`` defaults to nccl for CUDA
ranks (one card a rank) and gloo for CPU ranks; ``--dist-backend gloo
--device cuda`` puts several ranks on one card. ``--gram-tiles`` (the TPU
autotuner's tiles) parses and raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import resolve_config
from repro_torch.core import PruneConfig, corp_prune
from repro_torch.data import calib_stream
from repro_torch.distrib.sharding import CalibSharding
from repro_torch.interop import flatten
from repro_torch.launch.mesh import (check_backend, default_backend,
                                     host_ranks, joined, launch, make_mesh,
                                     parse_shape)
from repro_torch.models import build_model

# flags of the JAX CLI whose layers are not carried over: they parse, so
# that they are refused by name
_UNPORTED = {
    "gram_tiles": "the TPU gram autotuner (repro.kernels.gram.autotune), "
                  "which is not carried over: the CUDA kernel's 128x128 "
                  "tiles are fixed",
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="One-shot CORP pruning over a calibration stream")
    ap.add_argument("--arch", required=True,
                    help="config name, e.g. deit-base, qwen2-1.5b or "
                         "rwkv6-3b; a '-reduced' suffix shrinks it for smoke "
                         "runs")
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
    ap.add_argument("--calib-seq", type=int, default=64,
                    help="calibration sequence length (LM archs only)")
    ap.add_argument("--rank-policy", default="combined",
                    choices=["act", "mag", "combined", "active"],
                    help="MLP ranking statistic (core.ranking.rank_mlp)")
    ap.add_argument("--no-compensate", action="store_true",
                    help="rank-only baseline: prune without the closed-form "
                         "ridge compensation (paper ablation)")
    ap.add_argument("--round-to", type=int, default=1,
                    help="round kept counts down to a multiple")
    ap.add_argument("--lam", type=float, default=1e-4,
                    help="ridge strength, relative to mean(diag(Sigma))")
    ap.add_argument("--ckpt-in", default=None,
                    help="train checkpoint dir to load dense params from: "
                         "the params of its (params, opt_state) tuple at "
                         "the newest valid step (seed-0 init when omitted)")
    ap.add_argument("--out", default=None,
                    help="output dir for the pruned checkpoint + "
                         "report.json (print-only when omitted)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; raises without it)")
    ap.add_argument("--calib-ckpt", default=None,
                    help="directory for resumable calibration-statistics "
                         "checkpoints: each pass saves its accumulator every "
                         "--calib-ckpt-every batches and resumes from the "
                         "newest valid one")
    ap.add_argument("--calib-ckpt-every", type=int, default=8,
                    help="batches between calibration checkpoints")
    ap.add_argument("--one-traversal", action="store_true",
                    help="fuse the two calibration passes into ONE "
                         "traversal: pass 1 also accumulates pass-2 "
                         "statistics for top-k candidate keep-sets; units "
                         "whose final keep-set lands inside them need no "
                         "second pass (misses take a targeted pass 2)")
    ap.add_argument("--spec-margin", type=float, default=0.25,
                    help="candidate margin for --one-traversal: keep_n * "
                         "margin extra candidate dims per kv group")
    ap.add_argument("--stats-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="dtype the activation taps are STREAMED in during "
                         "calibration (every statistic accumulates fp32)")
    ap.add_argument("--expert-sparsity", type=float, default=0.0,
                    help="fraction of WHOLE routed experts to remove (MoE "
                         "archs): their contributions are ridge-folded "
                         "into a residual map of the block input")
    ap.add_argument("--mesh", default=None,
                    help="mesh shape 'DxM' (data x model) or 'PxDxM': the "
                         "pipeline runs on that many ranks")
    ap.add_argument("--calib-sharded", action="store_true",
                    help="shard calibration over --mesh: each rank's card "
                         "holds its blocks of the parameters, the forward "
                         "runs tensor-parallel over the model axis, batch "
                         "rows split over the data axes, the statistics "
                         "in column blocks (requires --mesh)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend of the --mesh ranks "
                         "(default nccl for cuda, one card a rank; gloo for "
                         "cpu, or for several ranks on one card)")
    # not carried over: parsed so that it is refused by name
    ap.add_argument("--gram-tiles", default=None,
                    help="not carried over (the TPU gram autotuner's tiles)")
    args = ap.parse_args(argv)
    for flag, layer in _UNPORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} needs {layer}, which is not "
                f"ported to repro_torch")
    if args.calib_sharded and not args.mesh:
        ap.error("--calib-sharded requires --mesh")
    return args


def main(argv=None):
    """Run the CLI; returns the dense and pruned params, configs and the
    report, for callers that drive it in-process. With ``--mesh`` the ranks
    are spawned and it returns None (under torchrun: this rank's result)."""
    args = parse_args(argv)
    if not args.mesh:
        return _run(args, resolve_device(args.device))
    shape = parse_shape(args.mesh)
    world = math.prod(shape)
    backend = args.dist_backend or default_backend(args.device)
    check_backend(backend, host_ranks(world), args.device)
    if resolve_device(args.device).type == "cuda" and not joined():
        from repro_torch.kernels import _build
        _build.library()        # once, before the spawned ranks load it
    return launch(_mesh_rank, world, backend=backend, device=args.device,
                  args=(args, shape))


def _mesh_rank(device, args, shape):
    """One rank of a ``--mesh`` run."""
    mesh = make_mesh(shape, device_type=device.type)
    shard = CalibSharding(mesh) if args.calib_sharded else None
    first = not any(mesh.get_coordinate())
    return _run(args, device, shard, first)


def _run(args, device, shard=None, first=True) -> dict:
    """The pipeline on ``device``; ``shard`` shards its statistics, and
    only the ``first`` rank prints and writes."""
    say = print if first else (lambda *a, **k: None)
    cfg = resolve_config(args.arch)
    model = build_model(cfg)
    # sharded calibration places each rank's blocks on its card
    params = model.init(torch.Generator().manual_seed(0),
                        device="cpu" if shard is not None else device)
    if args.ckpt_in:
        last = latest_step(args.ckpt_in)
        if last is None:
            raise FileNotFoundError(f"no valid checkpoint in {args.ckpt_in}")
        # train checkpoints hold (params, opt_state): restore the params
        params, _ = restore_checkpoint(args.ckpt_in, last, params,
                                       prefix="0/")
        say(f"[prune] loaded step {last} from {args.ckpt_in}")
    pc = PruneConfig(
        mlp_sparsity=(args.mlp_sparsity if args.mlp_sparsity is not None
                      else args.sparsity),
        attn_sparsity=(args.attn_sparsity if args.attn_sparsity is not None
                       else args.sparsity),
        lam=args.lam,
        rank_policy=args.rank_policy,
        compensate=not args.no_compensate,
        round_to=args.round_to,
        expert_sparsity=args.expert_sparsity,
    )
    stream = calib_stream(cfg, n_samples=args.calib, batch=args.calib_batch,
                          seq=args.calib_seq, device=device)
    t0 = time.time()
    new_params, new_cfg, report = corp_prune(
        model, params, stream, pc, progress=say, ckpt_dir=args.calib_ckpt,
        ckpt_every=args.calib_ckpt_every, stats_dtype=args.stats_dtype,
        one_traversal=args.one_traversal, spec_margin=args.spec_margin,
        mesh=shard)
    dt = time.time() - t0
    timing = ", ".join(f"{k} {v:.3f}s" for k, v in report["timing"].items())
    if shard is not None:
        whole = sum(t.numel() * t.element_size()
                    for t in flatten(params).values())
        say(f"[prune] mesh {args.mesh} {shard.axis_names}, statistics "
            f"sharded over {math.prod(shard.shape)} ranks; parameter "
            f"checksums: {json.dumps(report['checksums'])}")
        say(f"[prune] parameter bytes on each rank's {device.type}: "
            f"{json.dumps(report['param_bytes'])} of the whole tree's "
            f"{whole} (on the host)")
    say(f"[prune] done in {dt:.1f}s on {device} ({timing}); "
          f"d_ff {cfg.d_ff} -> {new_cfg.eff_d_ff}, "
          + (f"dense d_ff {cfg.dense_d_ff} -> {new_cfg.eff_dense_d_ff}, "
             if cfg.dense_d_ff else "")
          + f"qk {cfg.qk_full} -> {new_cfg.eff_qk}"
          + (f", experts {cfg.moe.num_experts} -> "
             f"{new_cfg.eff_num_experts}" if cfg.moe is not None else "")
          + (f", d_inner {cfg.eff_d_inner} -> {new_cfg.eff_d_inner}"
             if cfg.mamba is not None else ""))
    if "speculative" in report:
        sp = report["speculative"]
        say(f"[prune] one-traversal: {report['traversals']} traversal(s), "
              f"margin {sp['margin']}, {len(sp['hits'])} hit / "
              f"{len(sp['misses'])} miss"
              + (f" (re-passed: {', '.join(sp['misses'])})"
                 if sp["misses"] else ""))
    if args.out and first:
        save_checkpoint(args.out, 0, new_params,
                        extra={"config": new_cfg.name,
                               "mlp_sparsity": pc.mlp_sparsity,
                               "attn_sparsity": pc.attn_sparsity,
                               "expert_sparsity": pc.expert_sparsity})
        with open(os.path.join(args.out, "report.json"), "w") as f:
            json.dump({u: {k: v.tolist() for k, v in d.items()}
                       for u, d in report["units"].items()}, f, indent=1)
        say(f"[prune] saved to {args.out}")
    return {"model": model, "params": params, "pruned_params": new_params,
            "pruned_cfg": new_cfg, "report": report}


if __name__ == "__main__":
    main()
