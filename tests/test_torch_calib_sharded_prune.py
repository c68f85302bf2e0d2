"""The port's CORP on a mesh against the JAX package's single-device
pipeline (its own sharded tests fail on this jax), after
tests/test_sharded_calibration.py and
tests/test_sharding.py::test_distributed_corp_matches_single_device.

Four ``gloo`` ranks on the CPU (one spawn, ``tests/torch_dist_parity.py``,
no jax) run ``corp_prune(mesh=)`` on a 2 x 2 mesh, twice on one checkpoint
directory, ``corp_prune_streamed(mesh=)`` and one traversal at a hit margin
and a missing one; the prune CLI spawns its own four for ``--mesh 2x2
--calib-sharded``. Pruned models are compared through their outputs on a
held-out batch (the SVD fold is unique only up to paired signs), within
2e-3, JAX's own tolerance for its sharded pipeline.
"""
from __future__ import annotations

import dataclasses
import json
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import calib_factory, tiny_cfg  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.checkpoint import restore_checkpoint  # noqa: E402
from repro.core import PruneConfig as JaxPC  # noqa: E402
from repro.core import corp_prune as jax_corp_prune  # noqa: E402
from repro.core import corp_prune_streamed as jax_streamed  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.launch import prune as pt_prune  # noqa: E402
from repro_torch.launch.mesh import launch  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from torch_dist_parity import (load_params, prune_ranks,  # noqa: E402
                               write_job)
from torch_parity import images, jax_params, to_port_cfg  # noqa: E402

TOL = 2e-3
# tag -> (streamed, keyword arguments of the call)
CASES = {"two_pass": (False, {}),
         "streamed": (True, {}),
         "one_hit": (False, {"one_traversal": True, "spec_margin": 1.0}),
         "one_miss": (False, {"one_traversal": True, "spec_margin": 0.25})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("calib_sharded_prune")
    cfg = tiny_cfg("deit-base")
    params = jax_params(cfg, seed=2)
    batches = [{k: np.asarray(v) for k, v in b.items()}
               for b in calib_factory(cfg, n=4)()]
    write_job(d / "deit.npz", params, batches)
    model = jax_build(cfg)
    jp = jax.tree.map(jnp.asarray, params)

    def calib():
        return ({k: jnp.asarray(v) for k, v in b.items()} for b in batches)

    held = images(cfg, B=3, seed=77)
    jax_out = {}
    for tag, (streamed, kw) in CASES.items():
        fn = jax_streamed if streamed else jax_corp_prune
        new, ncfg, rep = fn(model, jp, calib, JaxPC(0.5, 0.5), **kw)
        jax_out[tag] = (np.asarray(jax_build(ncfg).apply(
            new, {"images": jnp.asarray(held)})), ncfg,
            rep.get("speculative", {}).get("misses"))
    pcfg = to_port_cfg(cfg)
    tasks = [dict(job="deit", cfg=pcfg, tag=tag, shape=(2, 2),
                  streamed=streamed, kw=kw,
                  **({"ckpt": str(d / "ckpt")} if tag == "two_pass" else {}))
             for tag, (streamed, kw) in CASES.items()]
    launch(prune_ranks, 4, backend="gloo", device="cpu",
           init_method=f"file://{d}/rdzv", args=(str(d), tasks))

    def port_out(tag, suffix=""):
        new = load_params(d / f"{tag}{suffix}.npz")
        ncfg = to_port_cfg(jax_out[tag][1])
        return pt_build(ncfg).apply(
            jax.tree.map(torch.from_numpy, new),
            {"images": torch.from_numpy(held)}).numpy()

    def report(tag):
        return json.loads((d / f"{tag}.json").read_text())
    return types.SimpleNamespace(d=d, jax=jax_out, port=port_out,
                                 report=report)


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_prune_matches_single_device_jax(runs, tag):
    """corp_prune(mesh=), corp_prune_streamed(mesh=) and one traversal (a
    hit at margin 1.0 in one traversal, and margin 0.25 with JAX's misses
    re-passed): outputs within 2e-3 of JAX's single-device pipeline, and
    the four ranks' parameters bitwise equal (their checksums)."""
    want, _, misses = runs.jax[tag]
    np.testing.assert_allclose(runs.port(tag), want, rtol=TOL, atol=TOL)
    rep = runs.report(tag)
    assert len(rep["checksums"]) == 4 and len(set(rep["checksums"])) == 1
    if tag.startswith("one"):
        assert rep["misses"] == misses
        assert rep["traversals"] == (1 if not misses else 2)
    if tag == "one_hit":
        assert rep["misses"] == [] and rep["traversals"] == 1


def test_sharded_checkpoint_resumes_to_bitwise_equal_weights(runs):
    """The second corp_prune(mesh=) on the first's checkpoint directory
    restores every pass from the gathered checkpoints (the mesh's first
    rank wrote them) and folds bitwise the same weights."""
    first = load_params(runs.d / "two_pass.npz")
    again = load_params(runs.d / "two_pass_again.npz")
    flat = jax.tree_util.tree_leaves_with_path(first)
    assert flat
    for path, leaf in flat:
        other = again
        for k in path:
            other = other[k.key]
        np.testing.assert_array_equal(leaf, other)
    assert sorted(p.name for p in (runs.d / "ckpt").iterdir()) \
        == ["pass1", "pass2"]


def test_cli_mesh_calib_sharded_checkpoint_restores_into_jax(tmp_path):
    """``--mesh 2x2 --calib-sharded --dist-backend gloo --device cpu``
    spawns four ranks; the checkpoint the first writes loads with the JAX
    package's ``restore_checkpoint`` into the pruned JAX config, and its
    outputs are within 2e-3 of the port's single-device CLI prune."""
    base = ["--arch", "deit-base-reduced", "--sparsity", "0.5", "--calib",
            "16", "--calib-batch", "8", "--device", "cpu"]
    out = str(tmp_path / "sharded")
    assert pt_prune.main(base + ["--mesh", "2x2", "--calib-sharded",
                                 "--dist-backend", "gloo", "--out",
                                 out]) is None
    single = pt_prune.main(base)
    jcfg = jax_configs.reduced(jax_configs.get_config("deit-base")) \
        .pruned(0.5, 0.5)
    assert dataclasses.asdict(single["pruned_cfg"]) \
        == dataclasses.asdict(jcfg)
    jmodel = jax_build(jcfg)
    restored, extra = restore_checkpoint(out, 0,
                                         jmodel.init(jax.random.PRNGKey(0)))
    assert extra["config"] == jcfg.name
    x = images(jcfg, B=4, seed=5)
    got = np.asarray(jmodel.apply(restored, {"images": jnp.asarray(x)}))
    want = pt_build(single["pruned_cfg"]).apply(
        single["pruned_params"], {"images": torch.from_numpy(x)}).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
