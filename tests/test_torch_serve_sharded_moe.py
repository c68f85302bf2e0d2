"""The port's mesh-sharded ServeEngine on routed MoE, expert-parallel over
the model axis, against the JAX package's single-device engine on the
carried weights (tests/test_torch_serve_sharded.py has the harness).

The config is qwen3-moe-235b-a22b-reduced with 4 kv heads (its one kv
head splits over no model axis), 8 experts (so that the pruned model's 4
split 4 ways too), one shared expert (split as a dense MLP) and a
capacity factor of 1.0, at which routing groups drop pairs. A decode
step over 4 slots routes one group of 4 tokens, whose experts take 2
pairs each; at 2x2 a data index holds 2 of the slots, and 2 tokens never
overflow an expert. So it is the gather of the step's rows over the data
axis that makes the drops, and the streams, one device's: without it the
streams differ. A JAX-pruned variant (0.5 of the hidden channels and of
the experts, the in-process params with ``bd_moe``, ``moe_resid`` and
``moe_out_b``) is served 1x4. One spawn of four CPU ``gloo`` ranks serves
every case.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from helpers import tiny_cfg  # noqa: E402
from repro.core import PruneConfig as JaxPC  # noqa: E402
from repro.core import corp_prune as jax_corp_prune  # noqa: E402
from repro.data import calib_stream as jax_stream  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.launch.mesh import launch  # noqa: E402
from test_torch_serve_sharded import (MAX_LEN, TRACE,  # noqa: E402
                                      check_blocks, first_logits, ranks,
                                      reference, streams)
from torch_parity import jax_params  # noqa: E402
from torch_serve_dist import DropCounter, serve_ranks  # noqa: E402

SLOTS = 4
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


def moe_cfg():
    cfg = tiny_cfg("qwen3-moe-235b-a22b", n_kv_heads=4)
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, num_experts=8, num_shared=1, capacity_factor=1.0))


def pruned(cfg, params):
    """JAX's CORP at 0.5 of the hidden channels, of the qk dims and of the
    experts -> (numpy params, config)."""
    new, ncfg, _ = jax_corp_prune(
        jax_build(cfg), jax.tree.map(jnp.asarray, params),
        jax_stream(cfg, n_samples=16, batch=8, seq=32),
        JaxPC(0.5, 0.5, expert_sparsity=0.5))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), new), ncfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_sharded_moe")
    cfg = moe_cfg()
    params = jax_params(cfg, seed=3)
    with DropCounter() as drops:
        dense = reference(cfg, d, slots=SLOTS, job="dense", params=params)
    new, ncfg = pruned(cfg, params)
    prune = reference(ncfg, d, slots=SLOTS, job="pruned", params=new)
    base = dict(job="dense", cfg=dense["cfg"], slots=SLOTS, max_len=MAX_LEN,
                trace=TRACE, logits=True)
    tasks = [dict(base, tag=mesh, shape=shape)
             for mesh, shape in MESHES.items()]
    tasks.append(dict(base, tag="2x2_host", shape=(2, 2), transport="host"))
    tasks.append(dict(base, tag="local", shape=(2, 2), route_local=True))
    tasks.append(dict(base, job="pruned", cfg=prune["cfg"], tag="pruned",
                      shape=(1, 4)))
    launch(serve_ranks, 4, backend="gloo", device="cpu",
           init_method=f"file://{d}/rdzv4", args=(str(d), tasks))
    return d, {"dense": dense, "pruned": prune, "drops": drops.by_size}


def test_single_device_decode_steps_drop_pairs(runs):
    """The port's unsharded engine, which the JAX engine's streams equal:
    its decode steps' groups of 4 slots drop pairs (a prefill's group is
    its prompt's bucket, 8 tokens or more; a walk step's one token)."""
    _, refs = runs
    assert refs["dense"]["port"] == refs["dense"]["jax"]
    groups, dropped = refs["drops"][SLOTS]
    assert groups > 0 and dropped > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_streams_token_identical_to_jax_single_device(runs, mesh):
    """Every rank routes each decode step's whole batch as one group of 4
    tokens (none of 2) and drops the pairs one device drops."""
    d, refs = runs
    assert streams(d, mesh) == refs["dense"]["jax"]
    data, model = MESHES[mesh]
    for f in ranks(d, mesh, data * model):
        assert f["routed"][str(SLOTS)] == refs["drops"][SLOTS]
        assert str(SLOTS // 2) not in f["routed"]


def test_data_gather_through_shared_memory(runs):
    """2x2 with every collective through shared memory, as where ranks
    share a card: the model axis' reductions and the data axis' gather of
    a decode step's rows."""
    d, refs = runs
    assert streams(d, "2x2_host") == refs["dense"]["jax"]
    for f in ranks(d, "2x2_host", 4):
        assert f["transport"] == "host"
        assert f["routed"][str(SLOTS)] == refs["drops"][SLOTS]


def test_without_the_data_gather_the_streams_differ(runs):
    """At 2x2, a decode step whose ranks route their own 2 slots alone
    drops no pair (2 tokens never overflow an expert's 2 slots), so its
    streams leave one device's: the whole-step routing is what makes them
    match."""
    d, refs = runs
    for f in ranks(d, "local", 4):
        assert str(SLOTS) not in f["routed"]
        assert f["routed"][str(SLOTS // 2)][1] == 0
    assert streams(d, "local") != refs["dense"]["jax"]
    assert streams(d, "2x2") == refs["dense"]["jax"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_first_step_logits_match_jax(runs, mesh):
    d, refs = runs
    want = refs["dense"]["logits"]
    got = first_logits(d, mesh)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rank_blocks_hold_jax_specs(runs, mesh):
    """Experts over the model axis (8 / m a rank), the router whole, the
    shared expert in Megatron's blocks, every rank at JAX's
    ``param_specs`` counts; the cache on kv heads and slots."""
    d, refs = runs
    data, model = MESHES[mesh]
    files = ranks(d, mesh, data * model)
    check_blocks(refs["dense"], files, {"data": data, "model": model})
    for f in files:
        shapes = f["param_shapes"]
        assert shapes["seg0/p0/mlp/wg"][1] == 8 // model
        assert shapes["seg0/p0/mlp/router"] == [2, 64, 8]
        assert shapes["seg0/p0/mlp/shared/wu"][-1] == 128 // model


def test_pruned_model_served_1x4(runs):
    """The JAX-pruned MoE with its compensation leaves: 4 experts, one a
    rank, with its block of ``bd_moe``, its rows of ``moe_resid`` and the
    whole ``moe_out_b``."""
    d, refs = runs
    ref = refs["pruned"]
    leaves = set(ref["port_engine"].params["seg0"]["p0"]["mlp"])
    assert {"bd_moe", "moe_resid", "moe_out_b"} <= leaves
    assert ref["cfg"].eff_num_experts == 4
    assert ref["port"] == ref["jax"]
    assert streams(d, "pruned") == ref["jax"]
    want = ref["logits"]
    got = first_logits(d, "pruned")
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5
    files = ranks(d, "pruned", 4)
    check_blocks(ref, files, {"data": 1, "model": 4})
    for f in files:
        shapes = f["param_shapes"]
        assert shapes["seg0/p0/mlp/bd_moe"] == [2, 1, 64]
        assert shapes["seg0/p0/mlp/moe_resid"] == [2, 16, 64]
        assert shapes["seg0/p0/mlp/moe_out_b"] == [2, 64]
