"""Rank code of the port's sharded-serving tests
(tests/test_torch_serve_sharded*.py). It imports no jax: the ranks are
spawned processes that load their weights from an ``.npz`` the test wrote
(numpy, carried across from the JAX package) and write what they served
and what they hold back as ``.json`` for the test to hold against the JAX
package's single-device engine.

A task is a dict; every rank runs the same tasks in the same order, since
each mesh and engine creates process groups collectively.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distrib.sharding import forward_specs, param_specs
from repro_torch.interop import flatten
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.serve import ServeFrontend, synthetic_trace
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve import sharding as serve_sharding
from repro_torch.serve.sharding import ServeSharding
from torch_dist_parity import load_job


def _sharding(shape, device, transport="group"):
    """A ``ServeSharding`` on a ``shape`` mesh; ``transport="host"`` takes
    the shared-memory collectives of ranks that share a card
    (``shares_card`` answers yes while it is built)."""
    rule = serve_sharding.shares_card
    if transport == "host":
        serve_sharding.shares_card = lambda mesh: True
    try:
        return ServeSharding(make_mesh(shape, device_type=device.type))
    finally:
        serve_sharding.shares_card = rule


def _numpy(tree):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in flatten(tree).items()}


def trace_of(cfg, task):
    """``task["trace"]`` ((n, seed, prompt_range, gen_range)) drawn, with
    frames of ``task["mem_len"]`` rows a request when given."""
    n, seed, pr, gr = task["trace"]
    return synthetic_trace(n, cfg.vocab_size, seed=seed,
                           prompt_range=tuple(pr), gen_range=tuple(gr),
                           mem_len=task.get("mem_len"), d_model=cfg.d_model)


def _serve(eng, task):
    """The lead's run of the task's trace: through ``run`` or, with
    ``prefill_chunk``, through the front-end. Returns {rid: tokens}."""
    trace = trace_of(eng.cfg, task)
    if task.get("prefill_chunk") is None:
        comps = eng.run(trace)
        return {c.rid: [int(t) for t in c.tokens] for c in comps}
    fe = ServeFrontend(eng, queue_depth=len(trace),
                       prefill_chunk=task["prefill_chunk"])
    return {h.rid: [int(t) for t in h.tokens] for h in fe.run(trace)}


def _retire_check(eng, lead):
    """Admit two requests into slots 0 and 1, decode a step, cancel slot 0:
    on every rank, the lanes it holds of slot 0 are the empty state and
    those of slot 1 are as they were. Returns this rank's counts."""
    if lead:
        eng.begin()
        eng.admit(Request(rid=0, tokens=np.arange(1, 5, dtype=np.int32),
                          gen=8), 0)
        eng.admit(Request(rid=1, tokens=np.arange(2, 8, dtype=np.int32),
                          gen=8), 1)
        eng.decode_step()
        eng.stop()
    else:
        eng.follow()
    before = _numpy(eng.slotcache.cache)
    if lead:
        eng.cancel(0)
        eng.stop()
    else:
        eng.follow()
    after = _numpy(eng.slotcache.cache)
    sc = eng.slotcache
    lo, hi = sc.slot_range()
    out = {"zeroed": 0, "kept": 0, "was_set": 0, "bad": []}
    for path, b in before.items():
        ax = sc.batch_axes[path]
        b, a = np.moveaxis(b, ax, 0), np.moveaxis(after[path], ax, 0)
        for slot in range(lo, hi):
            lane = slot - lo
            if slot == 0:
                if a[lane].any():
                    out["bad"].append(f"{path}: slot 0 not reset")
                out["zeroed"] += 1
                out["was_set"] += int(b[lane].any())
            elif not np.array_equal(a[lane], b[lane]):
                out["bad"].append(f"{path}: slot {slot} changed")
            else:
                out["kept"] += 1
    if lead:
        eng.decode_step()       # the survivor still decodes
        eng.stop()
    else:
        eng.follow()
    return out


def _first_logits(eng, task):
    """Every rank: the trace's first request's prefill logits through the
    rank's blocks, the vocab blocks gathered -> (V,) numpy."""
    req = trace_of(eng.cfg, task)[0]
    batch = {"tokens": torch.from_numpy(req.tokens[None].astype(np.int64))}
    if req.frames is not None:
        batch["frames"] = torch.from_numpy(req.frames[None])
    logits, _ = eng.model.prefill(eng.params, batch, task["max_len"],
                                  tp=eng.tp)
    last = logits[:, -1]
    if eng.tp is not None and last.shape[-1] != eng.cfg.padded_vocab:
        last = eng.tp.all_gather(last, -1)
    return last[0].numpy()


class DropCounter:
    """Counts, while installed, the routing groups of routed MoE and the
    (token, k) pairs they drop, by group size (a decode step's groups are
    its slots, or a rank's share of them when it routes them alone), by
    wrapping ``mlp._route``: ``{tg: [groups, drops]}``."""

    def __init__(self):
        from repro_torch.models import mlp
        self.mlp, self.by_size = mlp, {}
        self.route = mlp._route

    def __enter__(self):
        def route(xg, router, cfg):
            out = self.route(xg, router, cfg)
            n = self.by_size.setdefault(int(xg.shape[1]), [0, 0])
            n[0] += xg.shape[0]
            n[1] += int((~out[3]).sum())
            return out
        self.mlp._route = route
        return self

    def __exit__(self, *exc):
        self.mlp._route = self.route
        return False


def serve_ranks(device, job_dir, tasks):
    """Sharded engines on meshes. Each task: ``job`` (the ``.npz`` name),
    ``cfg`` (the port's config), ``tag``, ``shape``, ``slots``,
    ``max_len``, and ``trace`` (n, seed, prompt range, gen range) served
    through ``run``, or through the front-end with ``prefill_chunk``;
    ``transport`` is the forward's (``"host"``: as where the ranks share a
    card; default ``"group"``), ``mem_len`` gives an enc-dec's requests
    frames of that many rows, ``route_local`` has a MoE decode step route
    each rank's slots alone (no gather over the data axis), ``logits``
    gathers the first request's prefill logits, ``retire`` runs
    ``_retire_check`` after it, ``save_cache`` has every
    rank write its cache blocks to ``<tag>_cache_rank<r>.npz``. The lead
    writes
    ``<tag>.json`` (the streams, the logits); every rank writes
    ``<tag>_rank<r>.json`` (its cache and parameter leaves' shapes, the
    cache specs, the sizes, its coordinates, the retire check, the pairs
    its MoE layers routed and dropped, by group size)."""
    torch.set_num_threads(1)
    rank = dist.get_rank()
    for task in tasks:
        params = load_job(os.path.join(job_dir, task["job"] + ".npz"))[0]
        model = build_model(task["cfg"])
        sharding = _sharding(task["shape"], device,
                             task.get("transport", "group"))
        eng = ServeEngine(model, params, n_slots=task["slots"],
                          max_len=task["max_len"], sharding=sharding,
                          mem_len=task.get("mem_len"))
        if task.get("route_local"):
            eng._rows = None
        prefill_frames = []
        if task.get("frames"):
            run_op = eng._run_op

            def recording(op, slot, a, b, payload, floats=None):
                # the sum of the frames of each prefill this rank runs
                if op == "prefill" and eng.slotcache.owns(slot):
                    prefill_frames.append(None if floats is None else float(
                        floats.astype(np.float64).sum()))
                return run_op(op, slot, a, b, payload, floats)
            eng._run_op = recording
        streams = None
        with DropCounter() as drops:
            if sharding.lead:
                streams = _serve(eng, task)
                eng.stop()
            else:
                eng.follow()
        logits = _first_logits(eng, task) if task.get("logits") else None
        retire = _retire_check(eng, sharding.lead) if task.get("retire") \
            else None
        tag = os.path.join(job_dir, task["tag"])
        sc = eng.slotcache
        if task.get("save_cache"):
            np.savez(f"{tag}_cache_rank{rank}.npz", **_numpy(sc.cache))
        with open(f"{tag}_rank{rank}.json", "w") as f:
            json.dump({
                "coords": sharding.coords,
                "transport": sharding.transport,
                "rank_param_bytes": eng.rank_param_bytes,
                "sizes": sharding.sizes,
                "cache_shapes": {k: list(v.shape) for k, v in
                                 flatten(sc.cache).items()},
                "cache_specs": {k: list(v) for k, v in
                                flatten(sc.specs).items()},
                "param_shapes": {k: list(v.shape) for k, v in
                                 flatten(eng.params).items()},
                "param_specs": {k: list(v) for k, v in
                                flatten(eng.param_specs).items()},
                "jax_rule_specs": {k: list(v) for k, v in flatten(
                    param_specs(params, sharding)).items()},
                "forward_rule": flatten(forward_specs(params, sharding))
                == flatten(eng.param_specs),
                "rank_bytes": sc.rank_bytes,
                "device_bytes": eng.device_cache_bytes,
                "cache_bytes": eng.cache_bytes,
                "routed": drops.by_size,
                "prefill_frames": prefill_frames,
                "retire": retire}, f)
        if sharding.lead:
            with open(tag + ".json", "w") as f:
                json.dump({"streams": streams, "logits": None if logits
                           is None else logits.tolist()}, f)


def cli_ranks(device, argv, out_path):
    """A rank of the serve CLI's ``--serve-sharded`` (its own rank body,
    ``launch.serve._serve_rank``, on the parsed ``argv``); the lead writes
    the streams it served to ``out_path`` as ``{rid: tokens}``."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.mesh import parse_shape
    args = serve_cli.parse_args(argv)
    out = serve_cli._serve_rank(device, args, parse_shape(args.mesh_shape))
    if out is not None:
        with open(out_path, "w") as f:
            json.dump({h.rid: [int(t) for t in h.tokens]
                       for h in out["handles"]}, f)


def host_collective_ranks(device, out_dir):
    """Each rank: the shared-memory collectives of a 2 x 2 mesh's model
    groups (the shared-memory transport) on messages past a slot
    (chunked) and of several dtypes, against the expected values; writes
    ``host_rank<r>.json``."""
    torch.set_num_threads(1)
    rank = dist.get_rank()
    sh = _sharding((2, 2), device, "host")
    tp = sh.tp
    n = 3 * (1 << 20) + 5                       # 12 MB of fp32: 3 slots
    base = torch.arange(n, dtype=torch.float32) % 1000
    got = tp.all_reduce(base * (rank + 1))
    # the model group's ranks: this rank's data index, both model indices
    mates = [sh.data_index * 2 + m for m in range(2)]
    want = base * sum(r + 1 for r in mates)
    gathered = {str(dt): tp.all_gather(
        torch.full((3, 2), float(rank), dtype=dt), dim=-1)
        for dt in (torch.bfloat16, torch.float64, torch.float32)}
    ok_gather = all(torch.equal(g, torch.cat(
        [torch.full((3, 2), float(r), dtype=g.dtype) for r in mates], -1))
        for g in gathered.values())
    with open(os.path.join(out_dir, f"host_rank{rank}.json"), "w") as f:
        json.dump({"reduce_exact": bool(torch.equal(got, want)),
                   "gather_exact": ok_gather, "calls": tp.calls}, f)
