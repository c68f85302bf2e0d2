"""Stage times of ``chip_smoke.py``'s two-pass qwen3-moe prune, for the
``repro_torch`` package of any checkout, so that two trees are compared on
one card in one run.

qwen3-moe-235b-a22b at full width and 8 layers (seeded bf16 weights drawn
on the card), ``--seqs`` Zipf sequences of 512 tokens in batches of 4,
sparsity 0.5/0.5, as ``[prune moe]`` runs it. The prune runs ``--reps``
times in one process; each prints one JSON line with the report's stage
times and the rank stage split into its parts (``_rank``,
``_moe_expert_plan``, ``_park_moments``, each timed between device
synchronisations), the bytes ``_park_moments`` moved to page-locked host
memory and the card's free bytes when it was called. Usage, on a machine
with one CUDA card (parent checkout unpacked under ``build/``):

    python3 scripts/moe_prune_stages.py --src build/parent/src --label parent
    python3 scripts/moe_prune_stages.py --src src --label change
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the directory that holds the repro_torch package")
    ap.add_argument("--label", default="")
    ap.add_argument("--seqs", type=int, default=128)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path[:0] = [src, ROOT]          # the package, then chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("moe_prune_stages: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import PruneConfig, corp_prune
    from repro_torch.core import pruner
    from repro_torch.kernels import _build
    if not os.path.abspath(pruner.__file__).startswith(src):
        raise RuntimeError(f"repro_torch imported from {pruner.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.library()
    parts, park = {}, {}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize(dev)
            if name == "_park_moments":
                park["free_bytes"] = torch.cuda.mem_get_info(dev)[0]
            t0 = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize(dev)
            parts[name] = parts.get(name, 0.0) + time.time() - t0
            if name == "_park_moments":
                park["parked_bytes"] = sum(
                    t.numel() * t.element_size()
                    for st in out.values() for t in st.values()
                    if t.is_pinned())
            return out
        return run
    for name in ("_rank", "_moe_expert_plan", "_park_moments"):
        setattr(pruner, name, timed(name, getattr(pruner, name)))

    model, params = cs.big_lm("qwen3-moe-235b-a22b", dev, cs.MOE["layers"])
    spec = dict(cs.MOE, seqs=args.seqs)
    calib, _ = cs.lm_calib(model.cfg, dev, seed=23, spec=spec)
    sp = cs.MOE["sparsity"]
    for rep in range(args.reps):
        parts.clear()
        park.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        new, _, report = corp_prune(model, params, calib, PruneConfig(sp, sp))
        torch.cuda.synchronize(dev)
        wall = time.time() - t0
        del new
        print(json.dumps({
            "label": args.label, "rep": rep, "seqs": args.seqs,
            "wall_s": wall, "stages_s": report["timing"],
            "rank_parts_s": dict(parts), **park,
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
