"""The port's mesh-sharded ServeEngine on the enc-dec
(seamless-m4t-large-v2-reduced: 4 heads, so 2 a rank at 2x2 and 1 at 1x4,
each request with 8 frames of its own), fp32, against the JAX package's
single-device ``ServeEngine(mem_len=)`` on the carried weights; and the
owed dense cases, 2-kv-head variants of internvl2-26b-reduced and
granite-8b-reduced (their reduced configs have one kv head, which no
model axis splits), at 2x2. One spawn of four CPU ``gloo`` ranks serves
them all (tests/test_torch_serve_sharded.py has the harness).

Besides the streams, the first-step logits and the blocks: a rank's
``k_mem``/``v_mem`` hold its cross heads, and every prefill's frames reach
every model rank of the data index that holds its slot, and no other.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import tiny_cfg  # noqa: E402
from repro_torch.launch.mesh import launch  # noqa: E402
from test_torch_serve_sharded import (TRACE, check_blocks,  # noqa: E402
                                      first_logits, ranks, reference,
                                      streams)
from torch_serve_dist import serve_ranks  # noqa: E402

ARCH = "seamless-m4t-large-v2"
MEM_LEN, SLOTS = 8, 2
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# the owed dense configs, as variants with 2 kv heads
OWED = ("internvl2-26b", "granite-8b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_sharded_encdec")
    refs = {"seamless": reference(ARCH, d, mem_len=MEM_LEN, job="seamless")}
    for arch in OWED:
        refs[arch] = reference(tiny_cfg(arch, n_kv_heads=2), d, job=arch)
    base = dict(job="seamless", cfg=refs["seamless"]["cfg"], slots=SLOTS,
                max_len=32, trace=TRACE, mem_len=MEM_LEN)
    tasks = [dict(base, tag=mesh, shape=shape, logits=True, frames=True)
             for mesh, shape in MESHES.items()]
    tasks.append(dict(base, tag="2x2_fe", shape=(2, 2), prefill_chunk=3,
                      frames=True))
    tasks += [dict(job=arch, cfg=refs[arch]["cfg"], slots=SLOTS, max_len=32,
                   trace=TRACE, tag=arch, shape=(2, 2)) for arch in OWED]
    launch(serve_ranks, 4, backend="gloo", device="cpu",
           init_method=f"file://{d}/rdzv4", args=(str(d), tasks))
    return d, refs


@pytest.mark.parametrize("tag", ["2x2", "1x4", "2x2_fe"])
def test_streams_token_identical_to_jax_single_device(runs, tag):
    """Ragged prompts, refills mid-flight and, through the front-end, a
    prefill chunk of 3 (the frames go with the first chunk), each request
    with frames of its own."""
    d, refs = runs
    ref = refs["seamless"]
    assert ref["port"] == ref["jax"]
    assert len({r.frames.tobytes() for r in ref["requests"]}) \
        == len(ref["requests"])
    assert streams(d, tag) == ref["jax"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_first_step_logits_match_jax(runs, mesh):
    """The first request's prefill (frames and tokens) through a rank's
    blocks, the vocab blocks gathered."""
    d, refs = runs
    want = refs["seamless"]["logits"]
    got = first_logits(d, mesh)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rank_blocks_hold_jax_specs(runs, mesh):
    """Parameters at JAX's ``param_specs`` counts, cache leaves at
    ``slot_specs``' blocks: the decoder's self K/V and the memory K/V on
    the rank's heads, the slots over the data axis."""
    d, refs = runs
    data, model = MESHES[mesh]
    ref = refs["seamless"]
    files = ranks(d, mesh, data * model)
    check_blocks(ref, files, {"data": data, "model": model})
    cfg = ref["cfg"]
    L, H = cfg.n_layers, cfg.n_heads
    for f in files:
        shapes = f["cache_shapes"]
        for leaf in ("k_mem", "v_mem"):
            assert shapes[f"dec/cross/{leaf}"] == [
                L, SLOTS // data, MEM_LEN, H // model, cfg.d_head]
        assert shapes["dec/self/k"][1:4] == [SLOTS // data, 32, H // model]


@pytest.mark.parametrize("tag", ["2x2", "2x2_fe"])
def test_frames_reach_every_rank_of_the_owning_data_index(runs, tag):
    """Each rank records the frames of every prefill it runs: the model
    ranks of one data index ran the same prefills, with the frames of
    requests of the trace; the data indices split the trace's requests
    between them."""
    d, refs = runs
    rid_of = {float(r.frames.astype(np.float64).sum()): r.rid
              for r in refs["seamless"]["requests"]}
    by_data = {}
    for f in ranks(d, tag, 4):
        by_data.setdefault(f["coords"]["data"], []).append(
            [rid_of.get(s) for s in f["prefill_frames"]])
    seen = []
    for data, (mine, mate) in by_data.items():
        assert mine == mate and mine and None not in mine, data
        seen += mine
    assert sorted(seen) == sorted(rid_of.values())


@pytest.mark.parametrize("arch", OWED)
def test_owed_variants_token_identical_at_2x2(runs, arch):
    """internvl2-26b (the VLM's language backbone on token prompts) and
    granite-8b with 2 kv heads: one a rank."""
    d, refs = runs
    ref = refs[arch]
    assert ref["port"] == ref["jax"]
    assert streams(d, arch) == ref["jax"]
    files = ranks(d, arch, 4)
    check_blocks(ref, files, {"data": 2, "model": 2})
