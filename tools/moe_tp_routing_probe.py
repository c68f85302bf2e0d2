#!/usr/bin/env python3
"""How far a routed MoE's calibration statistics under a tensor-parallel
forward land from one device's, on a machine with one CUDA card:

    python3 tools/moe_tp_routing_probe.py

qwen3-moe-235b-a22b at 1 of its 94 layers and full width, in bf16 and in
fp32, seeded random weights drawn on the card by every rank: four
``gloo`` ranks on ``cuda:0`` run pass 1 of ``CalibrationEngine`` as a
2 data x 2 model mesh (each rank on its ``forward_specs`` blocks) over 32
Zipf sequences of 512 in batches of 16, and rank 0 runs the single-device
engine on the whole model over the same batches, and again over batches
of 8 (another shape for every product of the forward, on one device).
Each dtype runs twice: with the tokens drawn by ``torch.multinomial`` on
the card in every rank, and drawn on the host. It prints each rank's
token checksum, each statistic's relative Frobenius error (sharded
against one device, and one device's batches of 8 against 16) and how
many (token, expert) picks the routed counts differ by; the JSON goes to
``build/moe_tp_routing_probe.json``.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
SEQS, SEQ, BATCH, SEED = 32, 512, 16, 23


def rank_body(device, dtype, tokens_on, out_path):
    import chip_smoke
    from repro_torch.configs import resolve_config
    from repro_torch.core import CalibrationEngine, discover_units
    from repro_torch.distrib import CalibSharding
    from repro_torch.interop import flatten
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    shard = CalibSharding(make_mesh((2, 2), device_type="cuda"))
    cfg = resolve_config("qwen3-moe-235b-a22b").replace(n_layers=1,
                                                         dtype=dtype)
    model = build_model(cfg)

    def draw():
        return model.init(torch.Generator(device=device).manual_seed(0),
                          device=device)
    for turn in range(dist.get_world_size()):     # the card holds one tree
        if turn == rank:
            blocks = shard.place(draw())
            torch.cuda.empty_cache()
        dist.barrier()
    src = device if tokens_on == "card" else torch.device("cpu")
    tokens = chip_smoke.zipf_tokens(cfg.vocab_size, SEQS, SEQ, SEED,
                                    src).to(device)
    pos = torch.arange(tokens.numel(), device=device).reshape(tokens.shape)
    checksum = [int(tokens.long().sum()), int((tokens.long() * pos).sum())]
    sums = [None] * dist.get_world_size()
    dist.all_gather_object(sums, checksum)

    def batches(b):
        return [{"tokens": tokens[i:i + b]} for i in range(0, SEQS, b)]
    units = discover_units(cfg)
    got = flatten(CalibrationEngine(model, units, phase=1, mesh=shard).run(
        blocks, batches(BATCH)))
    del blocks
    torch.cuda.empty_cache()
    if rank == 0:
        whole = draw()
        one = flatten(CalibrationEngine(model, units, phase=1).run(
            whole, batches(BATCH)))
        half = flatten(CalibrationEngine(model, units, phase=1).run(
            whole, batches(BATCH // 2)))

        def rel(a, b):
            return float((a.double() - b.double()).norm()
                         / b.double().norm())
        n = "seg0/p0/moe/n"
        rec = {"dtype": dtype, "tokens_on": tokens_on,
               "token_checksums": sums,
               "sharded_vs_one": {k: rel(got[k], one[k]) for k in one},
               "one_batch8_vs_16": {k: rel(half[k], one[k]) for k in one},
               "routed_picks": float(one[n].sum()),
               "picks_moved_sharded": float((got[n] - one[n]).abs().sum()),
               "picks_moved_batch8": float((half[n] - one[n]).abs().sum())}
        print(json.dumps(rec), flush=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    dist.barrier()


def main() -> int:
    import subprocess
    if not torch.cuda.is_available():
        print("moe_tp_routing_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import launch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.library()
    out = os.path.join(ROOT, "build", "moe_tp_routing_probe.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    for dtype in ("bfloat16", "float32"):
        for tokens_on in ("card", "host"):
            t0 = time.time()
            launch(rank_body, 4, backend="gloo", device="cuda",
                   args=(dtype, tokens_on, out))
            print(f"[probe] {dtype}, tokens on the {tokens_on}: "
                  f"{time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
