"""Rank code of the port's sharded-calibration tests
(tests/test_torch_calib_sharded*.py). It imports no jax: the ranks are
spawned processes that load their weights, batches and plans from an
``.npz`` the test wrote (numpy, carried across from the JAX package) and
write what they computed back as ``.npz`` and ``.json`` for the test to
hold against the JAX package's single-device results.

A task is a dict; every rank runs the same tasks in the same order, since
each mesh and engine creates process groups collectively.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.core import (CalibrationEngine, PruneConfig, corp_prune,
                              corp_prune_streamed, discover_units)
from repro_torch.distrib import CalibrationCheckpointer, remesh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model


def write_job(path, params, batches, plans=None):
    """The test's side: numpy params (nested), batches (a list of dicts)
    and named plans (``{name: {unit: array or (keep, prune)}}``) -> one
    ``.npz``."""
    arrays = {f"p/{k}": v for k, v in interop.flatten(params).items()}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    for name, plan in (plans or {}).items():
        for unit, v in plan.items():
            parts = v if isinstance(v, tuple) else (v,)
            for j, a in enumerate(parts):
                arrays[f"{name}:{j}/{unit}"] = np.asarray(a)
    np.savez(path, **arrays)


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def load_job(path):
    """-> (params nested tensors, batches, plans) on the CPU."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    params = _unflatten({k[2:]: torch.from_numpy(v) for k, v in
                         arrays.items() if k.startswith("p/")})
    batches = []
    while any(k.startswith(f"b{len(batches)}/") for k in arrays):
        pre = f"b{len(batches)}/"
        batches.append({k[len(pre):]: torch.from_numpy(v)
                        for k, v in arrays.items() if k.startswith(pre)})
    plans = {}
    for k, v in arrays.items():
        if ":" in k:
            head, unit = k.split("/", 1)
            name, j = head.split(":")
            plans.setdefault(name, {}).setdefault(unit, {})[int(j)] = v
    plans = {name: {u: parts[0] if len(parts) == 1
                    else tuple(parts[j] for j in sorted(parts))
                    for u, parts in plan.items()}
             for name, plan in plans.items()}
    return params, batches, plans


def save_tree(path, tree):
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in interop.flatten(tree).items()})


def load_params(path):
    """A ``save_tree`` of a parameter tree -> nested numpy."""
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


def load_stats(path):
    """A ``save_tree`` of a statistics tree -> ``[{"p1"|"p2spec":}]
    {unit: {stat: numpy}}``: a unit name holds ``/``, a stat's does not."""
    tree = {}
    with np.load(path) as z:
        for k in z.files:
            node = tree
            head, rest = k.split("/", 1)
            if head in ("p1", "p2spec"):
                node, k = tree.setdefault(head, {}), rest
            unit, stat = k.rsplit("/", 1)
            node.setdefault(unit, {})[stat] = z[k if node is tree
                                                 else f"{head}/{k}"]
    return tree


def _setup(job_dir, task, cache):
    key = task["job"]
    if key not in cache:
        params, batches, plans = load_job(os.path.join(job_dir, key + ".npz"))
        model = build_model(task["cfg"])
        cache[key] = (model, params, batches, plans,
                      discover_units(task["cfg"]))
    return cache[key]


def stats_ranks(device, job_dir, tasks):
    """Calibration passes on meshes. Each task: ``job`` (the ``.npz`` name),
    ``cfg`` (the port's config), ``tag``, ``shape`` (the mesh), ``phase``,
    and optionally ``plan`` / ``spec_plan`` (a plan name of the job),
    ``stats_dtype``, ``expert_moments``, ``ckpt`` ((directory, batches of a
    first, interrupted run, or 0): the pass checkpoints every batch, is cut
    there and resumed), ``plain`` (rank 0 also runs the engine without a
    mesh), ``placed`` (the rank places its blocks itself and passes them).
    Rank 0 writes ``<tag>.npz`` (and ``<tag>_plain.npz``); every rank
    writes ``<tag>_rank<r>.json`` (fingerprint, its statistics blocks' and
    its placed parameter blocks' shapes and bytes). A task ``{"remesh":
    hints, "tag": t}`` builds ``fault.remesh(hint)`` for each hint; rank 0
    writes their shapes and axis names to ``<t>.json``."""
    torch.set_num_threads(1)
    cache = {}
    rank = dist.get_rank()
    for task in tasks:
        if "remesh" in task:        # {"remesh": [shape hints], "tag": ...}
            meshes = [remesh(h, device_type=device.type)
                      for h in task["remesh"]]
            if rank == 0:
                with open(os.path.join(job_dir, task["tag"] + ".json"),
                          "w") as f:
                    json.dump([[list(m.mesh.shape), list(m.mesh_dim_names)]
                               for m in meshes], f)
            continue
        model, params, batches, plans, units = _setup(job_dir, task, cache)
        kw = dict(phase=task["phase"],
                  plan=plans.get(task.get("plan")),
                  spec_plan=plans.get(task.get("spec_plan")),
                  stats_dtype=task.get("stats_dtype", "float32"),
                  expert_moments=task.get("expert_moments", False))
        mesh = make_mesh(task["shape"], device_type=device.type)
        eng = CalibrationEngine(model, units, mesh=mesh, **kw)
        if task.get("placed"):
            params = eng.shard.place(params)
        if "ckpt" in task:
            ck, first = task["ckpt"]
            if first:
                eng.run(params, batches[:first],
                        checkpointer=CalibrationCheckpointer(ck, every=1))
            out = eng.run(params, batches,
                          checkpointer=CalibrationCheckpointer(ck, every=1))
        else:
            out = eng.run(params, batches)
        tag = os.path.join(job_dir, task["tag"])
        with open(f"{tag}_rank{rank}.json", "w") as f:
            json.dump({"fingerprint": eng.fingerprint,
                       "local_shapes": eng.local_shapes,
                       "local_bytes": eng.local_bytes,
                       "param_shapes": eng.param_shapes,
                       "param_bytes": eng.param_bytes}, f)
        if rank == 0:
            save_tree(tag + ".npz", out)
            if task.get("plain"):
                save_tree(tag + "_plain.npz", CalibrationEngine(
                    model, units, **kw).run(params, batches))


def prune_ranks(device, job_dir, tasks):
    """CORP on meshes. Each task: ``job``, ``cfg``, ``tag``, ``shape``,
    ``streamed`` (``corp_prune_streamed``), ``kw`` (keyword arguments of
    the call), optionally ``ckpt`` (a directory: the prune runs twice on
    it, the second restoring every pass). Rank 0 writes ``<tag>.npz`` (the
    pruned params; ``<tag>_again.npz`` the second run's) and ``<tag>.json``
    (checksums, traversals, speculative hits and misses)."""
    torch.set_num_threads(1)
    cache = {}
    for task in tasks:
        model, params, batches, _, _ = _setup(job_dir, task, cache)
        mesh = make_mesh(task["shape"], device_type=device.type)
        fn = corp_prune_streamed if task.get("streamed") else corp_prune
        kw = dict(task.get("kw", {}))
        runs = 1
        if "ckpt" in task:
            kw.update(ckpt_dir=task["ckpt"], ckpt_every=1)
            runs = 2
        outs = [fn(model, params, lambda: iter(batches), PruneConfig(0.5, 0.5),
                   mesh=mesh, **kw) for _ in range(runs)]
        if dist.get_rank() == 0:
            tag = os.path.join(job_dir, task["tag"])
            new, _, rep = outs[0]
            save_tree(tag + ".npz", new)
            if runs == 2:
                save_tree(tag + "_again.npz", outs[1][0])
            sp = rep.get("speculative", {})
            with open(tag + ".json", "w") as f:
                json.dump({"checksums": rep["checksums"],
                           "traversals": rep["traversals"],
                           "hits": sp.get("hits"),
                           "misses": sp.get("misses")}, f)
