"""Serving entry point of the port (``repro.launch.serve``).

Continuous batching over a synthetic ragged trace, driven through the
serving front-end (``repro_torch.serve.ServeFrontend``: bounded queue,
deadlines, prefix cache) over the slot engine; prints per-status counts,
the latency-percentile table and the engine's stats:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --trace 32 --slots 8 --max-len 1024 --prompt-range 64,512 \\
        --gen-range 32,256 [--compare-static] [--prefill-chunk N]

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --trace 16 --slots 8 --max-len 1024 --prompt-range 4,16 \\
        --gen-range 16,64 --queue-depth 4 --deadline-ms 500,4000 \\
        --deadline-frac 0.5 --prefix-cache 8 --prefix-len 384

``--replicas N`` serves the trace by N engines behind a
``ReplicaRouter`` (``--route least-loaded`` or ``prefix-affinity``, whose
per-replica prefix caches hold ``--prefix-cache`` entries each); the
replicas share one params tree on one card and step from a thread each.
The table's ``mode`` column reads ``frontend`` or ``fleet-xN``.

Fixed-batch baseline loop (the default without ``--trace``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --batch 4 --prompt-len 32 --gen 16

``--arch rwkv6-3b`` serves RWKV-6 under the recurrent slot-cache contract
(exact-length prefill, a fixed-size state per slot; its prefix cache
reuses whole-prompt state snapshots); ``--compare-static`` then raises
after the front-end's run, as the JAX CLI does (the static baseline needs
ragged prefill).

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
PyTorch path.

Mesh-sharded serving (``--serve-sharded --mesh-shape DxM``; without
``--mesh-shape`` a usage error, as in the JAX CLI) runs the trace on DxM
ranks (``launch.mesh.launch``: spawned, or joined under torchrun), each
with its blocks of the params and of the slot cache and a tensor-parallel
forward over the model axis; the mesh's first rank runs the front-end and
prints, besides the table, the JAX CLI's ``sharded over {...}:
per-device cache ... MB (...x smaller than unsharded)`` line.
``--dist-backend`` is nccl for cuda (one card a rank) or gloo (cpu, or
ranks that share a card, whose forward then reduces through shared
memory: ``serve.sharding.shares_card``). Each rank draws (or restores)
the whole tree on the host and moves only its blocks to its card; its
cache blocks are allocated at their own shapes. The lead also prints each
rank's parameter and cache bytes and, on CUDA, its card's peak allocation
over the set-up:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-7b-reduced --trace 6 --slots 2 --max-len 48 \
        --prompt-range 4,10 --gen-range 2,6 --serve-sharded \
        --mesh-shape 2x2 --dist-backend gloo --device cpu

Every config serves sharded: the enc-dec with ``--mem-len`` (each
request's frames go with its prefill to the ranks that hold its slot),
routed MoE with its experts over the model axis, MLA (deepseek-v3) over
heads with its latent cache split on its dims, the Mamba hybrid (jamba)
over the inner channels. A config whose slot cache does not split
(``shard_ineligible``) is refused before any rank starts, and so is a MoE
whose experts do not divide the model axis, as are ``--prefix-cache``,
``--replicas`` and ``--compare-static``
beside ``--serve-sharded``, and ``--serve-sharded`` without ``--trace``
(the fixed-batch loop is not sharded).
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
import collections
import math
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs import resolve_config
from repro_torch.distrib.sharding import check_forward_split
from repro_torch.launch.mesh import (AXES, check_backend, default_backend,
                                     host_ranks, joined, launch, make_mesh,
                                     parse_shape)
from repro_torch.models import build_model
from repro_torch.serve import (Completion, PrefixCache, ReplicaRouter,
                               ServeEngine, ServeFrontend, frontend_table,
                               percentile_table, run_static_trace,
                               synthetic_trace)
from repro_torch.serve.cache import _infer_batch_axes, cache_contract
from repro_torch.serve.engine import format_table
from repro_torch.serve.errors import msg
from repro_torch.serve.router import ROUTES
from repro_torch.serve.sharding import ServeSharding, slot_specs


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
                queue_depth=16, deadline_ms=None, deadline_frac=1.0,
                prefix_cache=0, prefix_len=0, spf=False, replicas=1,
                route="least-loaded", prefill_chunk=None, mem_len=None,
                sharding=None, log=print):
    """The front-end over the continuous-batching engine (each engine
    warmed first, outside the timed region) on a synthetic trace: Poisson
    arrivals (``rate``), a deadline mix (``deadline_ms`` range on
    ``deadline_frac`` of the requests), bounded-queue admission
    (``queue_depth``, FIFO or shortest-prompt-first) and optional reuse of
    a shared ``prefix_len``-token system prompt through a
    ``prefix_cache``-entry cache. With ``replicas > 1`` a
    ``ReplicaRouter`` (``route``) serves the trace from that many engines
    on one params tree; its per-replica prefix caches replace the
    front-end's. ``mem_len``: the enc-dec requests' frame count.
    ``sharding``: this is the lead rank of a sharded engine, whose other
    ranks run ``follow_trace`` with the same arguments; they are released
    at the end.

    Returns (completions in rid order, one per handle with the tokens it
    got, the table, the engine or fleet stats, the warmup's stats, the
    front-end)."""
    cfg = model.cfg
    dl_range = None if deadline_ms is None else \
        tuple(x / 1e3 for x in deadline_ms)
    trace = synthetic_trace(n, cfg.vocab_size, seed=seed,
                            prompt_range=prompt_range, gen_range=gen_range,
                            rate=rate, deadline_range=dl_range,
                            deadline_frac=deadline_frac,
                            prefix_len=prefix_len, mem_len=mem_len,
                            d_model=cfg.d_model)
    engines = [ServeEngine(model, params, n_slots=slots, max_len=max_len,
                           mem_len=mem_len, sharding=sharding)
               for _ in range(max(1, replicas))]
    warm = collections.Counter()
    for e in engines:
        warm.update(e.warmup(prompt_lens=[len(r.tokens) for r in trace],
                             prefix=prefix_cache > 0,
                             prefill_chunk=prefill_chunk))
    if replicas > 1:
        eng = ReplicaRouter(engines, route=route, prefix_cap=prefix_cache)
        pc = None
    else:
        eng = engines[0]
        pc = PrefixCache(cap=prefix_cache) if prefix_cache > 0 else None
    fe = ServeFrontend(eng, queue_depth=queue_depth,
                       policy="spf" if spf else "fifo", prefix_cache=pc,
                       prefill_chunk=prefill_chunk)
    t0 = time.perf_counter()
    handles = fe.run(trace, log=log)
    wall = time.perf_counter() - t0
    if sharding is not None:
        engines[0].stop()
    table = frontend_table(handles, wall)
    table["mode"] = f"fleet-x{replicas}" if replicas > 1 else "frontend"
    rows = [table]
    st = eng.stats
    e0 = engines[0]
    prefills = sum(v for k, v in st.items() if k.startswith("prefill_b"))
    log(f"[serve] frontend: {st['admits']} admits ({st['refills']} "
        f"refills), {st['decode_steps']} decode steps at "
        f"{1e3 * st['decode_s'] / max(1, st['decode_steps']):.2f} ms/step, "
        f"prefill {1e3 * st['prefill_s'] / max(1, prefills):.2f} ms/admit, "
        f"lane utilization "
        f"{st['decode_lanes'] / max(1, st['decode_steps'] * slots):.0%}, "
        f"{st['walk_steps']} batch-1 walk steps at "
        f"{1e3 * st['walk_s'] / max(1, st['walk_steps']):.2f} ms/step, "
        f"{st['prefix_hits']} prefix hits, "
        f"cache {sum(e.cache_bytes for e in engines) / 1e6:.2f} MB "
        f"({e0.slotcache.slot_bytes / 1e6:.2f} MB per slot"
        + ("".join(f", {k} {v / 1e6:.2f} MB" for k, v in
                   e0.slotcache.slot_parts.items())
           if e0.contract in ("recurrent", "encdec") else "")
        + f", {e0.contract} contract)")
    if sharding is not None:
        log(f"[serve] sharded over {dict(sharding.sizes)}: per-device "
            f"cache {e0.device_cache_bytes / 1e6:.2f} MB "
            f"({e0.cache_bytes / max(e0.device_cache_bytes, 1):.2f}x "
            f"smaller than unsharded)")
        peak = "" if e0.device.type != "cuda" else \
            f"; the card's peak over the set-up {e0.rank_setup_peak} B"
        log(f"[serve] per rank ({sharding.transport} collectives): "
            f"params {e0.rank_param_bytes} B, cache "
            f"{e0.slotcache.rank_bytes} B{peak}")
    if replicas > 1:
        log(f"[serve] router: {dict(eng.rstats)}; "
            f"states {[s.value for s in eng.states]}")
        if eng.prefix_stats() is not None:
            for i, pst in enumerate(eng.prefix_stats()):
                log(f"[serve] replica {i} prefix cache: {pst}")
    if pc is not None:
        log(f"[serve] prefix cache: {pc.stats()}")
    if compare_static:
        comps_s = run_static_trace(model, params, trace, n_slots=slots,
                                   max_len=max_len)
        ts = percentile_table(comps_s, max(c.t_done for c in comps_s))
        ts["mode"] = "static"
        rows.append(ts)
    keys = ["mode", "requests", "done", "rejected", "expired", "failed",
            "tokens", "tok_per_s", "lat_p50_ms", "lat_p99_ms",
            "ttft_p50_ms", "ttft_p99_ms"]
    log(format_table(rows, keys))
    comps = [Completion(rid=h.rid, tokens=np.asarray(h.tokens, np.int32),
                        prompt_len=h.prompt_len, arrival=h.req.arrival,
                        t_admit=h.t_admit, t_first=h.t_first,
                        t_done=h.t_done) for h in handles]
    return comps, table, dict(st), dict(warm), fe


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
    ap.add_argument("--queue-depth", type=int, default=16,
                    help="bounded admission queue beyond the slots; "
                         "requests past it are rejected (backpressure)")
    ap.add_argument("--deadline-ms", default=None,
                    help="per-request deadline budget, 'lo,hi' ms after "
                         "arrival; expired requests keep partial tokens")
    ap.add_argument("--deadline-frac", type=float, default=1.0,
                    help="fraction of requests given a deadline "
                         "(the deadline mix)")
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="prefix-cache capacity in entries; 0 disables "
                         "(pure global-attention LMs and recurrent "
                         "stacks only)")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="shared system-prompt tokens prepended to every "
                         "trace request (the prefix-cache workload)")
    ap.add_argument("--spf", action="store_true",
                    help="shortest-prompt-first admission instead of FIFO")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the ReplicaRouter; 1 "
                         "serves through a single engine (no router)")
    ap.add_argument("--route", default="least-loaded", choices=ROUTES,
                    help="fleet routing policy: fewest occupied slots, or "
                         "longest cached prefix (per-replica caches)")
    ap.add_argument("--mesh-shape", default=None,
                    help="mesh shape 'DxM' (data x model) for "
                         "--serve-sharded, e.g. 2x2")
    ap.add_argument("--serve-sharded", action="store_true",
                    help="serve on the --mesh-shape ranks: params and slot "
                         "cache in blocks, a tensor-parallel forward "
                         "(requires --mesh-shape)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend of the --serve-sharded "
                         "ranks (default nccl for cuda, one card a rank; "
                         "gloo for cpu, or for several ranks on one card)")
    args = ap.parse_args(argv)
    if args.serve_sharded and not args.mesh_shape:
        ap.error("--serve-sharded requires --mesh-shape")
    if args.serve_sharded and args.init_on_device:
        ap.error("--serve-sharded draws the weights on the host and places "
                 "each rank's blocks on its card; drop --init-on-device, "
                 "which draws the whole tree on the card")
    return args


def _config(args):
    cfg = resolve_config(args.arch)
    if args.n_layers is not None:
        cfg = cfg.replace(n_layers=args.n_layers)
    if args.sparsity > 0 or args.expert_sparsity > 0:
        cfg = cfg.pruned(args.sparsity, args.sparsity,
                         expert_sparsity=args.expert_sparsity)
    return cfg


def _load(args, device, say=print):
    """The config's model and its seeded params on ``device`` (restored
    from ``--ckpt-in`` when given)."""
    model = build_model(_config(args))
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
        say(f"[serve] loaded {args.ckpt_in} step {last}")
    return model, params


def _trace_kw(args) -> dict:
    """serve_trace's keyword arguments from the flags."""
    return dict(
        n=args.trace, slots=args.slots, max_len=args.max_len,
        prompt_range=tuple(int(x) for x in args.prompt_range.split(",")),
        gen_range=tuple(int(x) for x in args.gen_range.split(",")),
        rate=args.rate, seed=args.seed, compare_static=args.compare_static,
        queue_depth=args.queue_depth,
        deadline_ms=None if args.deadline_ms is None else
        tuple(float(x) for x in args.deadline_ms.split(",")),
        deadline_frac=args.deadline_frac, prefix_cache=args.prefix_cache,
        prefix_len=args.prefix_len, spf=args.spf, replicas=args.replicas,
        route=args.route, prefill_chunk=args.prefill_chunk,
        mem_len=args.mem_len)


def check_shardable(cfg, shape, *, slots: int, max_len: int,
                    mem_len=None) -> None:
    """Refuse, before any rank loads its weights, a config that a
    ``shape`` mesh cannot serve: its slot cache by ``slot_specs``
    (``shard_ineligible``, as the JAX engine), then heads, channels or
    experts that do not divide the model axis
    (``distrib.sharding.check_forward_split``)."""
    model = build_model(cfg)
    meta = torch.device("meta")
    if cache_contract(cfg) == "encdec" and mem_len is None:
        raise ValueError(msg("encdec_needs_mem_len"))

    def template(batch):
        kw = {} if mem_len is None or cfg.family != "encdec" \
            else {"mem_len": mem_len}
        return model.init_cache(batch, max_len, meta, **kw)
    sizes = dict(zip(AXES[-len(shape):], shape))
    slot_specs(template(slots), _infer_batch_axes(template(1), template(2)),
               sizes, name=cfg.name)
    check_forward_split(cfg, sizes["model"])


def follow_trace(model, params, *, slots, max_len, mem_len=None,
                 sharding) -> None:
    """A rank of a sharded ``serve_trace`` other than the lead: build the
    engine with the lead's arguments and run its posted operations until
    the lead releases it."""
    ServeEngine(model, params, n_slots=slots, max_len=max_len,
                mem_len=mem_len, sharding=sharding).follow()


def _serve_sharded(args):
    """``--serve-sharded``: refuse what the ranks cannot serve, then start
    them."""
    for flag, given in (("--prefix-cache", args.prefix_cache > 0),
                        ("--replicas", args.replicas > 1),
                        ("--compare-static", args.compare_static),
                        ("no --trace", args.trace <= 0)):
        if given:
            raise NotImplementedError(
                f"--serve-sharded with {flag} is not ported (a prefix "
                f"cache and replicas on a sharded engine: ROADMAP Queue 1 "
                f"item 2b-ii; the static baseline and the fixed-batch loop "
                f"run on one device); serve sharded with --trace alone")
    shape = parse_shape(args.mesh_shape)
    check_shardable(_config(args), shape, slots=args.slots,
                    max_len=args.max_len, mem_len=args.mem_len)
    world = math.prod(shape)
    backend = args.dist_backend or default_backend(args.device)
    check_backend(backend, host_ranks(world), args.device)
    if resolve_device(args.device).type == "cuda" and not joined():
        from repro_torch.kernels import _build
        _build.library()        # once, before the spawned ranks load it
    return launch(_serve_rank, world, backend=backend, device=args.device,
                  args=(args, shape))


def _serve_rank(device, args, shape):
    """One rank of ``--serve-sharded``: its blocks of the params, drawn or
    restored on the host and cut there; then the lead serves the trace
    through the front-end, the others follow it."""
    sharding = ServeSharding(make_mesh(shape, device_type=device.type))
    model, params = _load(args, torch.device("cpu"),
                          say=print if sharding.lead else lambda *a: None)
    params = sharding.take_params(params, device)
    if not sharding.lead:
        follow_trace(model, params, slots=args.slots, max_len=args.max_len,
                     mem_len=args.mem_len, sharding=sharding)
        return None
    return _serve(args, model, params, sharding)


def _serve(args, model, params, sharding=None) -> dict:
    out = {"model": model, "params": params}
    (out["completions"], out["table"], out["stats"], out["warmup_stats"],
     out["frontend"]) = serve_trace(model, params, sharding=sharding,
                                    **_trace_kw(args))
    out["handles"] = [out["frontend"].handles[c.rid]
                      for c in out["completions"]]
    return out


def main(argv=None) -> dict:
    """Run the CLI; returns the model, params and what was served, for
    callers that drive it in-process. With ``--serve-sharded`` the ranks
    are spawned and it returns None (under torchrun: this rank's
    result)."""
    args = parse_args(argv)
    if args.serve_sharded:
        return _serve_sharded(args)
    device = resolve_device(args.device)
    model, params = _load(args, device)
    out = {"model": model, "params": params}
    if args.trace > 0:
        out = _serve(args, model, params)
    else:
        out["tokens"], out["prefill_s"], out["decode_s"] = serve_loop(
            model, params, batch=args.batch, prompt_len=args.prompt_len,
            gen=args.gen, max_len=args.prompt_len + args.gen + 1,
            device=device)
    return out


if __name__ == "__main__":
    main()
