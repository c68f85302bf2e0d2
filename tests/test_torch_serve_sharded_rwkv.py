"""The port's mesh-sharded ServeEngine on rwkv6-3b-reduced (the recurrent
contract: 4 heads of 16, so 2 a rank on a 2-way model axis), fp32,
against the JAX package's single-device engine, on 1x2 (model only) and
2x2 meshes of CPU ``gloo`` ranks (tests/test_torch_serve_sharded.py has
the harness). Besides the streams and the blocks: a rank's ``wkv`` state
holds its heads and its shifts its block of D, and retiring a slot resets
exactly the lanes of that slot that each rank holds.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import launch  # noqa: E402
from test_torch_serve_sharded import (MAX_LEN, SLOTS, TRACE,  # noqa: E402
                                      check_blocks, ranks, reference,
                                      streams)
from torch_serve_dist import serve_ranks  # noqa: E402

MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_sharded_rwkv")
    ref = reference("rwkv6-3b", d)
    task = dict(job="w", cfg=ref["cfg"], slots=SLOTS, max_len=MAX_LEN,
                trace=TRACE)
    launch(serve_ranks, 2, backend="gloo", device="cpu",
           init_method=f"file://{d}/rdzv2", args=(str(d), [
               dict(task, tag="1x2", shape=(1, 2), retire=True),
               dict(task, tag="1x2_fe", shape=(1, 2), prefill_chunk=3,
                    transport="host")]))
    launch(serve_ranks, 4, backend="gloo", device="cpu",
           init_method=f"file://{d}/rdzv4", args=(str(d), [
               dict(task, tag="2x2", shape=(2, 2), retire=True),
               dict(task, tag="2x2_fe", shape=(2, 2), prefill_chunk=3)]))
    return d, ref


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_streams_token_identical_to_jax_single_device(runs, mesh):
    """Exact-length prefills, batch-1 walk steps and refills on sharded
    recurrent state, through ``run`` and the front-end (on 1x2 with the
    model axis' collectives through shared memory)."""
    d, ref = runs
    assert ref["port"] == ref["jax"]
    assert streams(d, mesh) == ref["jax"]
    assert streams(d, mesh + "_fe") == ref["jax"]
    data, model = MESHES[mesh]
    assert {f["transport"] for f in ranks(d, mesh + "_fe", data * model)} \
        == {"host" if mesh == "1x2" else "group"}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rank_blocks_hold_jax_specs(runs, mesh):
    d, ref = runs
    data, model = MESHES[mesh]
    files = ranks(d, mesh, data * model)
    check_blocks(ref, files, {"data": data, "model": model})
    H, D = ref["cfg"].n_heads, ref["cfg"].d_model
    for f in files:      # wkv (reps, B, H, N, N) on heads, shifts on D
        shapes = f["cache_shapes"]
        assert shapes["seg0/p0/time/wkv"][2] == H // model
        assert shapes["seg0/p0/time/shift"][-1] == D // model
        assert shapes["seg0/p0/channel/shift"][-1] == D // model
        assert shapes["seg0/p0/time/wkv"][1] == SLOTS // data


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_retire_resets_the_shard_local_state(runs, mesh):
    """After two admits and a step, cancelling slot 0 leaves every lane of
    slot 0 that a rank holds at the empty state (each was set before) and
    every lane of slot 1 as it was; the survivor decodes on."""
    d, _ = runs
    data, model = MESHES[mesh]
    held0 = 0
    for f in ranks(d, mesh, data * model):
        rt = f["retire"]
        assert rt["bad"] == []
        assert rt["was_set"] == rt["zeroed"]
        held0 += rt["zeroed"] > 0
        assert rt["kept"] > 0 or data == 2
    # slot 0's lanes live on the ranks of data index 0 only (every rank
    # when the slots are not split over data)
    assert held0 == model
