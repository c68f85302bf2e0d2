"""The port's mesh-sharded ServeEngine against the JAX package's
single-device engine (the JAX package's own sharded serve tests fail on
this jax, ROADMAP "State of the reference"), after
tests/test_serve_sharded.py, on deepseek-7b-reduced (the kv contract, 4
heads, so 2 a rank on a 2-way model axis), fp32.

Four CPU ``gloo`` ranks on a 2x2 (data x model) mesh serve the carried JAX
weights through ``admit``/``step``/``retire`` (``run``) and through the
front-end with a prefill chunk; one rank on a 1x1 mesh runs the whole
sharded path on one rank. The ranks are spawned processes running
``tests/torch_serve_dist.py``, which imports no jax.
"""
from __future__ import annotations

import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from helpers import tiny_cfg  # noqa: E402
from repro.distrib.sharding import param_specs as jax_param_specs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import synthetic_trace as jax_trace  # noqa: E402
from repro.serve.sharding import slot_specs as jax_slot_specs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch.mesh import launch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from torch_dist_parity import write_job  # noqa: E402
from torch_parity import jax_params, to_port_cfg  # noqa: E402
from torch_serve_dist import serve_ranks  # noqa: E402

SLOTS, MAX_LEN = 2, 32
TRACE = (6, 3, (4, 10), (2, 6))    # n, seed, prompt range, gen range


class DuckMesh:
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): leaf
            for kp, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda s: isinstance(s, P))[0]}


def reference(arch, d, trace=TRACE, seed=3, *, slots=SLOTS, mem_len=None,
              job="w", params=None):
    """The carried weights (written for the ranks as ``<job>.npz``), JAX's
    single-device engine's streams on them and its first request's
    prefill logits, the port's unsharded engine's streams, and JAX's engine
    for its templates. ``arch``: a reduced config's name or a JAX config;
    ``mem_len``: an enc-dec's frames a request; ``params``: numpy weights
    (default: drawn from ``seed``)."""
    jcfg = tiny_cfg(arch) if isinstance(arch, str) else arch
    if params is None:
        params = jax_params(jcfg, seed=seed)
    write_job(d / f"{job}.npz", params, [])
    n, s, pr, gr = trace
    kw = {} if mem_len is None else {"mem_len": mem_len,
                                     "d_model": jcfg.d_model}
    reqs = jax_trace(n, jcfg.vocab_size, seed=s, prompt_range=pr,
                     gen_range=gr, **kw)
    jmodel = jax_build(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    jeng = JaxEngine(jmodel, jp, n_slots=slots, max_len=MAX_LEN,
                     mem_len=mem_len)
    jax_streams = {c.rid: [int(t) for t in c.tokens] for c in jeng.run(reqs)}
    assert jeng.stats["refills"] > 0
    batch = {"tokens": jnp.asarray(reqs[0].tokens[None])}
    if mem_len is not None:
        batch["frames"] = jnp.asarray(reqs[0].frames[None])
    logits = np.asarray(jmodel.prefill(jp, batch, MAX_LEN)[0][0, -1])
    cfg = to_port_cfg(jcfg)
    pt = ServeEngine(build_model(cfg), interop.from_numpy(params, "cpu"),
                     n_slots=slots, max_len=MAX_LEN, mem_len=mem_len)
    port_streams = {c.rid: [int(t) for t in c.tokens] for c in pt.run(reqs)}
    return {"jcfg": jcfg, "cfg": cfg, "params": params, "jax": jax_streams,
            "port": port_streams, "port_engine": pt, "jax_engine": jeng,
            "logits": logits, "requests": reqs}


def streams(d, tag):
    with open(d / f"{tag}.json") as f:
        return {int(k): v for k, v in json.load(f)["streams"].items()}


def first_logits(d, tag):
    """The lead's gathered first-request prefill logits (a ``logits``
    task)."""
    with open(d / f"{tag}.json") as f:
        return np.asarray(json.load(f)["logits"], np.float32)


def ranks(d, tag, n):
    out = []
    for r in range(n):
        with open(d / f"{tag}_rank{r}.json") as f:
            out.append(json.load(f))
    return out


def check_blocks(ref, rank_files, sizes):
    """Each rank's cache leaves have the shapes of JAX's ``slot_specs``
    blocks, its parameters hold JAX's ``param_specs`` element counts, the
    cache bytes of every rank are JAX's per-device estimate, and the
    ranks' blocks differ where their coordinates do."""
    jeng = ref["jax_engine"]
    tmpl, axes = jeng.slotcache._template, jeng.slotcache.batch_axes
    cspec = _flat(jax_slot_specs(tmpl, axes, sizes, name=ref["jcfg"].name))
    ctmpl = _flat(tmpl)
    pspec = _flat(jax_param_specs(ref["params"], DuckMesh(sizes)))
    pshape = {k: v.shape for k, v in _flat(ref["params"]).items()}

    def block(shape, spec):
        spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        return [s // (sizes[a] if a else 1) for s, a in zip(shape, spec)]
    est = sum(math.prod(block(ctmpl[k].shape, cspec[k]))
              * ctmpl[k].dtype.itemsize for k in ctmpl)
    pbytes = sum(math.prod(block(v.shape, pspec[k])) * v.dtype.itemsize
                 for k, v in _flat(ref["params"]).items())
    for rf in rank_files:
        assert rf["sizes"] == sizes
        assert rf["cache_shapes"] == {k: block(ctmpl[k].shape, cspec[k])
                                      for k in ctmpl}
        assert rf["forward_rule"]
        for k, shape in pshape.items():
            assert math.prod(rf["param_shapes"][k]) \
                == math.prod(block(shape, pspec[k])), k
        assert rf["rank_bytes"] == [est] * len(rank_files)
        assert rf["rank_param_bytes"] == [pbytes] * len(rank_files)
        assert rf["device_bytes"] == est
        assert rf["cache_bytes"] == jeng.cache_bytes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_sharded")
    ref = reference("deepseek-7b", d)
    task = dict(job="w", cfg=ref["cfg"], slots=SLOTS, max_len=MAX_LEN,
                trace=TRACE)
    launch(serve_ranks, 4, backend="gloo", device="cpu",
           init_method=f"file://{d}/rdzv4", args=(str(d), [
               dict(task, tag="run", shape=(2, 2)),
               dict(task, tag="fe", shape=(2, 2), prefill_chunk=3),
               dict(task, tag="host", shape=(2, 2), transport="host")]))
    launch(serve_ranks, 1, backend="gloo", device="cpu",
           init_method=f"file://{d}/rdzv1", args=(str(d), [
               dict(task, tag="one", shape=(1, 1), save_cache=True)]))
    return d, ref


@pytest.mark.parametrize("tag", ["run", "fe", "host"])
def test_streams_token_identical_to_jax_single_device(runs, tag):
    """2x2: slots refill mid-flight on sharded state, through ``run``, the
    front-end with chunked prefills, and ``run`` with the model axis'
    collectives through shared memory (as where ranks share a card); every
    stream equals JAX's single-device engine's and the port's unsharded
    engine's."""
    d, ref = runs
    assert ref["port"] == ref["jax"]
    assert streams(d, tag) == ref["jax"]
    assert {f["transport"] for f in ranks(d, tag, 4)} \
        == {"host" if tag == "host" else "group"}


def test_rank_blocks_hold_jax_specs(runs):
    d, ref = runs
    files = ranks(d, "run", 4)
    check_blocks(ref, files, {"data": 2, "model": 2})
    assert sorted((f["coords"]["data"], f["coords"]["model"])
                  for f in files) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_degenerate_mesh_equals_the_unsharded_engine_bitwise(runs):
    """1x1: the whole sharded path (posted operations, the slot cache by
    its specs, the params by theirs) on one rank; the streams and the
    final cache equal the unsharded engine's, bit for bit."""
    d, ref = runs
    assert streams(d, "one") == ref["port"]
    check_blocks(ref, ranks(d, "one", 1), {"data": 1, "model": 1})
    want = interop.flatten(ref["port_engine"].slotcache.cache)
    with np.load(d / "one_cache_rank0.npz") as z:
        assert set(z.files) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(z[k], v.numpy(), err_msg=k)
