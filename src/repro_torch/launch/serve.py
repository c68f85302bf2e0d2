"""Serving entry point of the port (``repro.launch.serve``).

Continuous batching over a synthetic ragged trace, through the slot engine
(``repro_torch.serve.ServeEngine.run``); prints the latency-percentile
table and the engine's stats:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --trace 32 --slots 8 --max-len 1024 --prompt-range 64,512 \\
        --gen-range 32,256 [--compare-static] [--prefill-chunk N]

Fixed-batch baseline loop (the default without ``--trace``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --batch 4 --prompt-len 32 --gen 16

``--arch rwkv6-3b`` serves RWKV-6 under the recurrent slot-cache contract
(exact-length prefill, a fixed-size state per slot); ``--compare-static``
then raises after the engine's run, as the JAX CLI does (the static
baseline needs ragged prefill).

Weights are seeded random (seed 0), drawn on the CPU, or on the serving
device with ``--init-on-device`` (other values; a 20-billion-parameter
model in seconds, not minutes); ``--n-layers N`` cuts the depth (widths
unchanged); ``--sparsity S --ckpt-in DIR`` serves
a pruned checkpoint written by ``repro.launch.prune`` (or the port's),
with its compensation leaves (``mlp/bd``, ``mlp/bv_comp``; a MoE's
``mlp/bd_moe`` and, with ``--expert-sparsity``, ``mlp/moe_resid`` and
``mlp/moe_out_b``; a shared expert's ``mlp/shared/bd``; a Mamba mixer's
``mixer/out_b``), which the JAX CLI's template drops; a
``--no-compensate`` checkpoint has none and serves them as zeros. A pruned qk-norm model (gemma3-1b) restores its per-head
qk-norm scales, ``(H, qk_kept)`` and ``(Hkv, qk_kept)``, which the JAX
CLI's template cannot take (its restore fails). It
runs on CUDA and raises without it; ``--device cpu`` runs the plain
PyTorch path. The JAX CLI drives ``--trace`` through its async front-end;
the front-end is not ported, so its flags (queue, deadlines, prefix cache,
shortest-prompt-first, replicas, mesh) raise here.
``--arch internvl2-26b`` serves the VLM's language backbone on token
prompts (the engine sends no patch embeddings). ``--arch
deepseek-v3-671b`` serves MLA from its latent cache (``ckv`` and
``k_rope``, (512 + 64) values a token and layer). ``--arch
jamba-1.5-large-398b`` serves the Mamba hybrid under the recurrent
contract: each slot holds the Mamba layers' conv rows and SSM states and
the attention layers' K/V rows (the stats line splits a slot's bytes into
the two). ``--arch seamless-m4t-large-v2 --mem-len S`` serves the
encoder-decoder: every request of the trace carries S frames (drawn from
the trace's seed), the decoder prompt is the request's tokens, and a slot
holds the decoder's K/V beside the memory K/V of S rows (the stats line
splits the two); the fixed-batch loop draws frames of ``--prompt-len``
rows, as the JAX CLI does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs import resolve_config
from repro_torch.models import build_model
from repro_torch.serve import (ServeEngine, percentile_table,
                               run_static_trace, synthetic_trace)
from repro_torch.serve.engine import format_table

# flag -> the unported layer it needs
_UNPORTED = {
    "queue_depth": "the serving front-end (repro/serve/frontend.py)",
    "deadline_ms": "the serving front-end (repro/serve/frontend.py)",
    "deadline_frac": "the serving front-end (repro/serve/frontend.py)",
    "prefix_cache": "the prefix cache (repro/serve/prefix.py)",
    "prefix_len": "the prefix cache (repro/serve/prefix.py)",
    "spf": "the front-end's admission queue (repro/serve/frontend.py)",
    "replicas": "the replica router (repro/serve/router.py)",
    "route": "the replica router (repro/serve/router.py)",
    "mesh_shape": "mesh-sharded serving (repro/serve/sharding.py)",
    "serve_sharded": "mesh-sharded serving (repro/serve/sharding.py)",
}


# leaves CORP pruning adds: a pruned template holds them (zeros), and a
# pruned checkpoint fills them when it was compensated
COMPENSATION_LEAVES = ("mlp/bd", "mlp/bv_comp", "mlp/bd_moe",
                       "mlp/moe_resid", "mlp/moe_out_b", "mlp/shared/bd",
                       "mixer/out_b")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_loop(model, params, *, batch, prompt_len, gen, max_len, device,
               seed=0, log=print):
    """Fixed-batch prefill + greedy decode; returns exactly ``gen`` tokens
    per request (the prefill argmax plus ``gen - 1`` timed decode steps),
    the prefill seconds and the decode seconds."""
    cfg = model.cfg
    rng = np.random.RandomState(seed)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                        size=(batch, prompt_len))
                            .astype(np.int32)).to(device)
    req = {"tokens": toks}
    if cfg.family == "encdec":
        req["frames"] = torch.from_numpy(
            rng.randn(batch, prompt_len, cfg.d_model).astype(np.float32)) \
            .to(device)

    def argmax(logits):
        return logits[:, -1, : cfg.vocab_size].argmax(-1)[:, None] \
            .to(torch.int32)

    # warm up (kernel build, cuBLAS handles) outside the timed region
    logits, cache = model.prefill(params, req, max_len)
    model.decode_step(params, argmax(logits), cache)
    _sync(device)

    t0 = time.perf_counter()
    logits, cache = model.prefill(params, req, max_len)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = argmax(logits)          # first generated token (from prefill)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = model.decode_step(params, tok, cache)
        tok = argmax(logits)
        out_tokens.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    steps = gen - 1
    log(f"[serve] prefill {t_prefill * 1e3:.1f} ms "
        f"({batch}x{prompt_len} tokens); decode "
        f"{steps} steps in {t_decode * 1e3:.1f} ms -> "
        f"{batch * steps / max(t_decode, 1e-9):.1f} tok/s")
    return torch.cat(out_tokens, dim=1), t_prefill, t_decode


def serve_trace(model, params, *, n, slots, max_len, prompt_range,
                gen_range, rate=None, seed=0, compare_static=False,
                prefill_chunk=None, mem_len=None, log=print):
    """Continuous-batching engine over a synthetic ragged trace (warmed
    first, outside the timed region); ``mem_len``: the enc-dec requests'
    frame count. Returns (completions, table, engine stats, the warmup's
    engine stats)."""
    cfg = model.cfg
    trace = synthetic_trace(n, cfg.vocab_size, seed=seed,
                            prompt_range=prompt_range, gen_range=gen_range,
                            rate=rate, mem_len=mem_len, d_model=cfg.d_model)
    eng = ServeEngine(model, params, n_slots=slots, max_len=max_len,
                      mem_len=mem_len)
    warm = eng.warmup(prompt_lens=[len(r.tokens) for r in trace],
               prefill_chunk=prefill_chunk)
    t0 = time.perf_counter()
    comps = eng.run(trace, prefill_chunk=prefill_chunk)
    wall = time.perf_counter() - t0
    table = percentile_table(comps, wall)
    table["mode"] = "continuous"
    rows = [table]
    st = eng.stats
    prefills = sum(v for k, v in st.items() if k.startswith("prefill_b"))
    log(f"[serve] engine: {st['admits']} admits ({st['refills']} refills), "
        f"{st['decode_steps']} decode steps at "
        f"{1e3 * st['decode_s'] / max(1, st['decode_steps']):.2f} ms/step, "
        f"prefill {1e3 * st['prefill_s'] / max(1, prefills):.2f} ms/admit, "
        f"lane utilization "
        f"{st['decode_lanes'] / max(1, st['decode_steps'] * slots):.0%}, "
        f"{st['walk_steps']} batch-1 walk steps, "
        f"cache {eng.cache_bytes / 1e6:.2f} MB "
        f"({eng.slotcache.slot_bytes / 1e6:.2f} MB per slot"
        + ("".join(f", {k} {v / 1e6:.2f} MB" for k, v in
                   eng.slotcache.slot_parts.items())
           if eng.contract in ("recurrent", "encdec") else "")
        + f", {eng.contract} contract)")
    if compare_static:
        comps_s = run_static_trace(model, params, trace, n_slots=slots,
                                   max_len=max_len)
        ts = percentile_table(comps_s, max(c.t_done for c in comps_s))
        ts["mode"] = "static"
        rows.append(ts)
    keys = ["mode", "requests", "tokens", "tok_per_s", "lat_p50_ms",
            "lat_p99_ms", "ttft_p50_ms", "ttft_p99_ms"]
    log(format_table(rows, keys))
    return comps, table, dict(st), warm


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve an LM through the continuous-batching engine")
    ap.add_argument("--arch", required=True,
                    help="LM config name, e.g. qwen2-1.5b or rwkv6-3b; a "
                         "'-reduced' suffix shrinks it for smoke runs")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sparsity", type=float, default=0.0,
                    help="serve the config pruned at this sparsity (MLP "
                         "and attention qk dims), e.g. with --ckpt-in")
    ap.add_argument("--expert-sparsity", type=float, default=0.0,
                    help="serve with this fraction of routed experts "
                         "removed (MoE archs; as repro_torch.launch.prune)")
    ap.add_argument("--ckpt-in", default=None,
                    help="checkpoint directory to load (latest valid step)")
    ap.add_argument("--trace", type=int, default=0,
                    help="serve N synthetic ragged requests through the "
                         "continuous-batching engine instead of the "
                         "fixed-batch loop")
    ap.add_argument("--slots", type=int, default=4,
                    help="engine slots (concurrent requests)")
    ap.add_argument("--max-len", type=int, default=128,
                    help="per-slot sequence budget (prompt + gen)")
    ap.add_argument("--prompt-range", default="8,48",
                    help="trace prompt lengths, 'lo,hi'")
    ap.add_argument("--gen-range", default="4,48",
                    help="trace generation lengths, 'lo,hi'")
    ap.add_argument("--rate", type=float, default=None,
                    help="trace arrival rate (req/s); default all at t=0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-static", action="store_true",
                    help="also run the fixed-batch baseline on the same "
                         "trace and print both rows")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="max prompt tokens a cold admit prefills per "
                         "engine iteration (chunked prefill)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; raises without it)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="serve the config cut to this depth (widths "
                         "unchanged), e.g. a model too deep for one card")
    ap.add_argument("--init-on-device", action="store_true",
                    help="draw the seeded weights with a generator on the "
                         "serving device (fast at full width; other values "
                         "than the default CPU draw)")
    ap.add_argument("--mem-len", type=int, default=None,
                    help="enc-dec only: fixed encoder-memory length; trace "
                         "requests carry synthetic frames of this length")
    # flags of layers that are not ported yet: each raises when given
    ap.add_argument("--queue-depth", type=int, default=None)
    ap.add_argument("--deadline-ms", default=None)
    ap.add_argument("--deadline-frac", type=float, default=None)
    ap.add_argument("--prefix-cache", type=int, default=None)
    ap.add_argument("--prefix-len", type=int, default=None)
    ap.add_argument("--spf", action="store_true", default=None)
    ap.add_argument("--replicas", type=int, default=None)
    ap.add_argument("--route", default=None)
    ap.add_argument("--mesh-shape", default=None)
    ap.add_argument("--serve-sharded", action="store_true", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns the model, params and what was served, for
    callers that drive it in-process."""
    args = parse_args(argv)
    for flag, layer in _UNPORTED.items():
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} needs {layer}, which is not "
                f"ported to repro_torch yet")
    device = resolve_device(args.device)
    cfg = resolve_config(args.arch)
    if args.n_layers is not None:
        cfg = cfg.replace(n_layers=args.n_layers)
    if args.sparsity > 0 or args.expert_sparsity > 0:
        cfg = cfg.pruned(args.sparsity, args.sparsity,
                         expert_sparsity=args.expert_sparsity)
    model = build_model(cfg)
    gen = torch.Generator(device=device if args.init_on_device else "cpu")
    params = model.init(gen.manual_seed(0), device=device)
    if args.ckpt_in:
        last = latest_step(args.ckpt_in)
        if last is None:
            raise FileNotFoundError(f"no valid checkpoint in {args.ckpt_in}")
        # the compensation biases of a pruned template: a --no-compensate
        # prune writes none, which serves as zeros
        params, _ = restore_checkpoint(args.ckpt_in, last, params,
                                       zero_if_absent=COMPENSATION_LEAVES)
        print(f"[serve] loaded {args.ckpt_in} step {last}")
    out = {"model": model, "params": params}
    if args.trace > 0:
        pr = tuple(int(x) for x in args.prompt_range.split(","))
        gr = tuple(int(x) for x in args.gen_range.split(","))
        (out["completions"], out["table"], out["stats"],
         out["warmup_stats"]) = serve_trace(
            model, params, n=args.trace, slots=args.slots,
            max_len=args.max_len, prompt_range=pr, gen_range=gr,
            rate=args.rate, seed=args.seed,
            compare_static=args.compare_static,
            prefill_chunk=args.prefill_chunk, mem_len=args.mem_len)
    else:
        out["tokens"], out["prefill_s"], out["decode_s"] = serve_loop(
            model, params, batch=args.batch, prompt_len=args.prompt_len,
            gen=args.gen, max_len=args.prompt_len + args.gen + 1,
            device=device)
    return out


if __name__ == "__main__":
    main()
