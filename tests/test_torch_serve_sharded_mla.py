"""The port's mesh-sharded ServeEngine on MLA: deepseek-v3-671b-reduced (3
layers: one dense, two MoE with a shared expert; 4 heads, a latent of
rank 16 and a rope key of 8, 4 experts), fp32, against the JAX package's
single-device engine on the carried weights, at 2x2 and 1x4, and at 2x2
through the front-end with a prefill chunk (the walk steps decode a
batch-1 latent cache of the rank's blocks) with every collective through
shared memory. One spawn of four CPU ``gloo`` ranks serves every case
(tests/test_torch_serve_sharded.py has the harness).

A rank runs its heads; its cache holds its block of ``ckv`` on the
latent rank and of ``k_rope`` on its dim (JAX's ``slot_specs``), and the
down-projections hold its rows of D (JAX's ``param_specs``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import tiny_cfg  # noqa: E402
from repro_torch.launch.mesh import launch  # noqa: E402
from test_torch_serve_sharded import (MAX_LEN, SLOTS, TRACE,  # noqa: E402
                                      check_blocks, first_logits, ranks,
                                      reference, streams)
from torch_serve_dist import serve_ranks  # noqa: E402

ARCH = "deepseek-v3-671b"
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_sharded_mla")
    ref = reference(tiny_cfg(ARCH), d)
    base = dict(job="w", cfg=ref["cfg"], slots=SLOTS, max_len=MAX_LEN,
                trace=TRACE)
    tasks = [dict(base, tag=mesh, shape=shape, logits=True)
             for mesh, shape in MESHES.items()]
    tasks.append(dict(base, tag="2x2_fe", shape=(2, 2), prefill_chunk=3,
                      transport="host"))
    launch(serve_ranks, 4, backend="gloo", device="cpu",
           init_method=f"file://{d}/rdzv4", args=(str(d), tasks))
    return d, ref


@pytest.mark.parametrize("tag", ["2x2", "1x4", "2x2_fe"])
def test_streams_token_identical_to_jax_single_device(runs, tag):
    """Ragged prompts and refills mid-flight through ``run``; chunked
    prefills (a chunk of 3, then walk steps) through the front-end over
    shared memory."""
    d, ref = runs
    assert ref["port"] == ref["jax"]
    assert streams(d, tag) == ref["jax"]
    want = "host" if tag == "2x2_fe" else "group"
    assert {f["transport"] for f in ranks(d, tag, 4)} == {want}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_first_step_logits_match_jax(runs, mesh):
    d, ref = runs
    want = ref["logits"]
    got = first_logits(d, mesh)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rank_blocks_hold_jax_specs(runs, mesh):
    """Parameters at JAX's ``param_specs`` counts (the up-projections and
    ``wo`` on heads, the down-projections on D's rows, the norm scales
    whole), cache leaves at ``slot_specs``' blocks: ``ckv`` and
    ``k_rope`` on their last dim, the slots over the data axis."""
    d, ref = runs
    data, model = MESHES[mesh]
    files = ranks(d, mesh, data * model)
    check_blocks(ref, files, {"data": data, "model": model})
    for f in files:
        shapes, cache = f["param_shapes"], f["cache_shapes"]
        assert shapes["seg0/l0/mixer/w_uq_nope"] == [32, 4 // model, 16]
        assert shapes["seg0/l0/mixer/wo"] == [4 // model, 16, 64]
        assert shapes["seg0/l0/mixer/w_dq"] == [64 // model, 32]
        assert shapes["seg1/p0/mixer/w_dkv"] == [2, 64 // model, 16]
        assert shapes["seg0/l0/mixer/kv_norm_scale"] == [16]
        assert cache["seg0/l0/ckv"] == [SLOTS // data, MAX_LEN, 16 // model]
        assert cache["seg1/p0/k_rope"] == [2, SLOTS // data, MAX_LEN,
                                           8 // model]
