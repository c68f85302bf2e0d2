"""The port's mesh-sharded ServeEngine on the Mamba hybrid:
jamba-1.5-large-398b-reduced (8 layers: Mamba mixers, attention at index
4, routed MoE on the odd layers; d_inner 128), fp32, against the JAX
package's single-device engine on the carried weights
(tests/test_torch_serve_sharded.py has the harness). Its one kv head
splits over no model axis (JAX's ``slot_specs`` refuses it), so both
packages take a variant with 4 kv heads, served at 1x4 and 2x2 (the 2x2
also retires a slot on sharded state), and a JAX-pruned variant (0.5 of
the Mamba inner channels, of the hidden channels and of the qk dims, the
in-process params with ``out_b``, which JAX's checkpoint drops: reference
fault 2) at 1x4. One spawn of four CPU ``gloo`` ranks serves every case,
while this process runs the references (the JAX package's compiles take
most of the file's time).

A rank runs its block of the inner channels: ``in_proj`` holds the same
block of x's and of z's columns (the paired halves), and its ``ssm`` and
``conv`` states hold the block's channels (JAX's ``slot_specs``).
"""
from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import tiny_cfg  # noqa: E402
from repro.core import PruneConfig as JaxPC  # noqa: E402
from repro.core import corp_prune as jax_corp_prune  # noqa: E402
from repro.data import calib_stream as jax_stream  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.launch.mesh import launch  # noqa: E402
from test_torch_serve_sharded import (MAX_LEN, SLOTS, TRACE,  # noqa: E402
                                      check_blocks, first_logits, ranks,
                                      reference, streams)
from torch_dist_parity import write_job  # noqa: E402
from torch_parity import jax_params, to_port_cfg  # noqa: E402
from torch_serve_dist import serve_ranks  # noqa: E402

MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


def pruned(cfg, params):
    """JAX's CORP at 0.5 of the MLP channels (the Mamba inner channels
    among them) and of the qk dims -> (numpy params, config)."""
    new, ncfg, _ = jax_corp_prune(
        jax_build(cfg), jax.tree.map(jnp.asarray, params),
        jax_stream(cfg, n_samples=8, batch=8, seq=16), JaxPC(0.5, 0.5))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), new), ncfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_sharded_mamba")
    cfg = tiny_cfg("jamba-1.5-large-398b", n_kv_heads=4)
    params = jax_params(cfg, seed=3)
    new, ncfg = pruned(cfg, params)
    write_job(d / "dense.npz", params, [])
    write_job(d / "pruned.npz", new, [])
    base = dict(job="dense", cfg=to_port_cfg(cfg), slots=SLOTS,
                max_len=MAX_LEN, trace=TRACE, logits=True)
    tasks = [dict(base, tag="1x4", shape=(1, 4)),
             dict(base, tag="2x2", shape=(2, 2), retire=True),
             dict(base, job="pruned", cfg=to_port_cfg(ncfg), tag="pruned",
                  shape=(1, 4))]
    failed = []

    def ranks_run():
        try:
            launch(serve_ranks, 4, backend="gloo", device="cpu",
                   init_method=f"file://{d}/rdzv4", args=(str(d), tasks))
        except BaseException as e:      # re-raised below
            failed.append(e)
    spawn = threading.Thread(target=ranks_run)
    spawn.start()
    try:
        refs = {"dense": reference(cfg, d, job="dense_ref", params=params),
                "pruned": reference(ncfg, d, job="pruned_ref", params=new)}
    finally:
        spawn.join()
    if failed:
        raise failed[0]
    return d, refs


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_streams_token_identical_to_jax_single_device(runs, mesh):
    """Exact-length prefills, batch-1 walk steps and refills on sharded
    Mamba states beside the attention layer's K/V rows."""
    d, refs = runs
    assert refs["dense"]["port"] == refs["dense"]["jax"]
    assert streams(d, mesh) == refs["dense"]["jax"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_first_step_logits_match_jax(runs, mesh):
    d, refs = runs
    want = refs["dense"]["logits"]
    got = first_logits(d, mesh)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rank_blocks_hold_jax_specs(runs, mesh):
    """Parameters at JAX's ``param_specs`` counts (the mixer's 2-D leaves
    on the inner channels, its vectors whole), cache leaves at
    ``slot_specs``' blocks: ``ssm`` and ``conv`` on the channels, the
    attention layer's ``k``/``v`` on kv heads."""
    d, refs = runs
    data, model = MESHES[mesh]
    files = ranks(d, mesh, data * model)
    check_blocks(refs["dense"], files, {"data": data, "model": model})
    di = 128 // model
    for f in files:
        shapes, cache = f["param_shapes"], f["cache_shapes"]
        assert shapes["seg0/p0/mixer/in_proj"] == [1, 64, 2 * di]
        assert shapes["seg0/p0/mixer/out_proj"] == [1, di, 64]
        assert shapes["seg0/p0/mixer/d_skip"] == [1, 128]
        assert cache["seg0/p0/ssm"] == [1, SLOTS // data, di, 4]
        assert cache["seg0/p0/conv"] == [1, SLOTS // data, 3, di]
        assert cache["seg0/p4/k"] == [1, SLOTS // data, MAX_LEN, 4 // model,
                                        16]


def test_retire_resets_the_sharded_states_of_its_slot(runs):
    """2x2: cancelling slot 0 zeroes every lane of it that a rank holds
    (its Mamba states, the attention rows and positions), and leaves slot
    1's lanes as they were."""
    d, _ = runs
    holders = 0
    for f in ranks(d, "2x2", 4):
        rt = f["retire"]
        assert rt["bad"] == []
        assert rt["was_set"] == rt["zeroed"]
        holders += rt["zeroed"] > 0
    assert holders == 2         # the model ranks of slot 0's data index


def test_pruned_model_served_1x4(runs):
    """The JAX-pruned hybrid (d_inner 64, 16 channels a rank) with its
    compensation bias ``out_b`` carried in process, whole on every rank
    and added after the reduction."""
    d, refs = runs
    ref = refs["pruned"]
    assert ref["cfg"].eff_d_inner == 64
    assert "out_b" in ref["port_engine"].params["seg0"]["p0"]["mixer"]
    assert ref["port"] == ref["jax"]
    assert streams(d, "pruned") == ref["jax"]
    want = ref["logits"]
    got = first_logits(d, "pruned")
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5
    files = ranks(d, "pruned", 4)
    check_blocks(ref, files, {"data": 1, "model": 4})
    for f in files:
        shapes = f["param_shapes"]
        assert shapes["seg0/p0/mixer/in_proj"] == [1, 64, 32]
        assert shapes["seg0/p0/mixer/out_b"] == [1, 64]
        assert f["cache_shapes"]["seg0/p0/ssm"] == [1, SLOTS, 16, 4]
