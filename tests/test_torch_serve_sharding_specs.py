"""The port's placement rules of sharded serving against the JAX package's,
with no devices: ``param_specs`` (``repro.distrib.sharding``) on every
config's reduced parameter tree, ``slot_specs`` and
``device_bytes_estimate`` (``repro.serve.sharding``) on every config's
engine template, their refusals, and the head-parallel forward's own
splits (``forward_specs``), whose blocks hold as many elements as JAX's.

JAX's rules read only ``axis_names`` and ``devices.shape`` of a mesh, so a
duck-typed mesh stands in for one; the port's take ``{axis: size}``.
"""
from __future__ import annotations

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS, DEIT_IDS, get_config, reduced  # noqa: E402
from repro.distrib.sharding import param_specs as jax_param_specs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import errors as jax_errors  # noqa: E402
from repro.serve.cache import _infer_batch_axes as jax_batch_axes  # noqa: E402
from repro.serve.sharding import (  # noqa: E402
    device_bytes_estimate as jax_estimate, slot_specs as jax_slot_specs)
from repro_torch.distrib.sharding import (  # noqa: E402
    forward_specs, param_specs, shard_params)
from repro_torch.interop import flatten  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.cache import _infer_batch_axes  # noqa: E402
from repro_torch.serve.sharding import (  # noqa: E402
    device_bytes_estimate, slot_specs)
from torch_parity import to_port_cfg  # noqa: E402

MESHES = [{"data": 2, "model": 2}, {"model": 4}, {"model": 3}]
FSDP_MESHES = [{"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2}]
MAX_LEN, SLOTS, MEM_LEN = 32, 2, 8
# JAX's own list of the reduced configs whose slot cache cannot split over
# a 2-way model axis (tests/test_serve_zoo.py::SHARD_GAPS)
SHARD_GAPS = frozenset({"granite-8b", "gemma3-1b", "qwen2-1.5b",
                        "internvl2-26b", "qwen3-moe-235b-a22b",
                        "jamba-1.5-large-398b"})


class DuckMesh:
    """What JAX's rules read of a mesh."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


def _jax_flat(tree):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda s: isinstance(s, P))[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)
        out[path] = leaf
    return out


def _spec_tuple(spec, ndim):
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _jax_shapes(arch):
    cfg = reduced(get_config(arch))
    return cfg, jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))


def _numel_block(shape, spec, sizes):
    den = 1
    for e in spec:
        if e is not None:
            den *= math.prod(sizes[a] for a in ((e,) if isinstance(e, str)
                                                else e))
    return math.prod(shape) // den


@pytest.mark.parametrize("arch", ARCH_IDS + DEIT_IDS)
def test_param_specs_equal_jax_leaf_by_leaf(arch):
    """Every leaf of the reduced tree gets JAX's spec on every mesh, with
    FSDP too; the port's own init tree has the same paths and shapes."""
    cfg, tree = _jax_shapes(arch)
    flat_shapes = {p: tuple(s.shape) for p, s in _jax_flat(tree).items()}
    port_tree = build_model(to_port_cfg(cfg)).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten(port_tree).items()} \
        == flat_shapes
    cases = [(m, False) for m in MESHES] + [(m, True) for m in FSDP_MESHES]
    for sizes, fsdp in cases:
        want = _jax_flat(jax_param_specs(tree, DuckMesh(sizes), fsdp=fsdp))
        got = flatten(param_specs(port_tree, sizes, fsdp=fsdp))
        assert set(got) == set(want)
        for path, spec in want.items():
            assert got[path] == _spec_tuple(spec, len(flat_shapes[path])), \
                (arch, sizes, fsdp, path)


def _templates(arch):
    """JAX's engine template (its prefill cache's shapes) at batch 1, 2 and
    the port's (``init_cache`` on the meta device)."""
    cfg = reduced(get_config(arch))
    model = jax_build(cfg)
    psds = jax.eval_shape(model.init, jax.random.PRNGKey(0))

    def jax_t(batch):
        req = {"tokens": jax.ShapeDtypeStruct((batch, 8), jnp.int32)}
        if cfg.family == "encdec":
            req["frames"] = jax.ShapeDtypeStruct(
                (batch, MEM_LEN, cfg.d_model), jnp.dtype(cfg.dtype))
        return jax.eval_shape(
            lambda p, b: model.prefill(p, b, MAX_LEN)[1], psds, req)

    pmodel = build_model(to_port_cfg(cfg))
    kw = {"mem_len": MEM_LEN} if cfg.family == "encdec" else {}

    def port_t(batch):
        return pmodel.init_cache(batch, MAX_LEN, torch.device("meta"), **kw)
    j1, j2 = jax_t(1), jax_t(SLOTS)
    p1, p2 = port_t(1), port_t(SLOTS)
    return cfg, (j1, j2, jax_batch_axes(j1, j2)), \
        (p1, p2, flatten(_infer_batch_axes(p1, p2)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_slot_specs_and_estimate_equal_jax(arch):
    """On each mesh: the global and the batch-1 template's specs, leaf by
    leaf, and the per-device bytes, or the same refusal (JAX's
    ``SHARD_GAPS`` refuse at a 2-way model axis)."""
    cfg, (j1, j2, jaxes), (p1, p2, paxes) = _templates(arch)
    for sizes in MESHES:
        for jt, pt in ((j2, p2), (j1, p1)):
            try:
                want = jax_slot_specs(jt, jaxes, sizes, name=cfg.name)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    slot_specs(pt, paxes, sizes, name=cfg.name)
                assert str(got.value) == str(e)
                assert sizes.get("model") != 2 or arch in SHARD_GAPS
                continue
            assert sizes.get("model") != 2 or arch not in SHARD_GAPS
            got = slot_specs(pt, paxes, sizes, name=cfg.name)
            flat_t = {p: t.shape for p, t in _jax_flat(jt).items()}
            flat_w = _jax_flat(want)
            assert set(flatten(got)) == set(flat_w)
            for path, spec in flat_w.items():
                assert flatten(got)[path] == _spec_tuple(
                    spec, len(flat_t[path])), (arch, sizes, path)
            assert device_bytes_estimate(pt, got, sizes) \
                == jax_estimate(jt, want, sizes)


def test_shard_ineligible_message_is_jax_s():
    """The refusal names the config, the leaf and the axis size in JAX's
    words (both packages format ``shard_ineligible`` from one table)."""
    cfg, _, (_, p2, paxes) = _templates("granite-8b")
    with pytest.raises(ValueError) as got:
        slot_specs(p2, paxes, {"data": 2, "model": 2}, name=cfg.name)
    assert str(got.value) == jax_errors.msg("shard_ineligible",
                                            name=cfg.name, leaf="k", m=2)


def _full_shapes(arch):
    """JAX's shape tree of a full config (``jax.eval_shape``: no memory).
    ``<arch>+pruned``: the config pruned at 0.5 of the hidden channels, the
    qk dims and the experts (``+pruned75``: at 0.75 of the hidden and the
    Mamba inner channels), with the compensation leaves JAX's pruner
    writes into a MoE layer (``bd_moe``, ``moe_resid``, ``moe_out_b``) and
    a Mamba mixer (``out_b``), which its pruned template lacks (reference
    fault 2)."""
    name, _, variant = arch.partition("+")
    cfg = get_config(name)
    if variant:
        cfg = cfg.pruned(0.75 if variant == "pruned75" else 0.5, 0.5,
                         expert_sparsity=0.5)
    tree = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))
    if variant:
        f32 = jnp.float32
        for layer in tree["seg0"].values():
            moe, mixer = layer["mlp"], layer["mixer"]
            if "router" in moe:
                L, E, D = moe["wg"].shape[:3]
                moe.update(bd_moe=jax.ShapeDtypeStruct((L, E, D), f32),
                           moe_resid=jax.ShapeDtypeStruct((L, D, D), f32),
                           moe_out_b=jax.ShapeDtypeStruct((L, D), f32))
            if "in_proj" in mixer:
                L, D = mixer["in_proj"].shape[:2]
                mixer["out_b"] = jax.ShapeDtypeStruct((L, D), f32)
    return tree


FULL_SPEC_MESHES = {
    "seamless-m4t-large-v2": [{"model": 2}, {"data": 2, "model": 2}],
    "qwen3-moe-235b-a22b": [{"model": 2}, {"data": 2, "model": 2},
                            {"model": 4}],
}


@pytest.mark.parametrize("arch", sorted(FULL_SPEC_MESHES))
def test_param_specs_equal_jax_on_the_full_config(arch):
    """The enc-dec's and the routed MoE's full trees (JAX's shapes, no
    memory): every leaf's spec is JAX's, the expert stacks on their expert
    dim, the router whole, the vocab split: 256,206 and 151,936 padded to
    multiples of 128, which 2 and 4 divide."""
    tree = _full_shapes(arch)
    cfg = get_config(arch)
    assert cfg.padded_vocab % 4 == 0
    shapes = {p: tuple(s.shape) for p, s in _jax_flat(tree).items()}
    nested = jax.tree.map(lambda s: tuple(s.shape), tree)
    for sizes in FULL_SPEC_MESHES[arch]:
        want = _jax_flat(jax_param_specs(tree, DuckMesh(sizes)))
        got = flatten(param_specs(nested, sizes))
        assert set(got) == set(want)
        for path, spec in want.items():
            assert got[path] == _spec_tuple(spec, len(shapes[path])), \
                (arch, sizes, path)
    if cfg.moe is not None:
        assert got["seg0/p0/mlp/wg"] == (None, "model", None, None)
        assert got["seg0/p0/mlp/router"] == (None, None, None)


def test_slot_specs_place_the_memory_on_cross_heads_as_jax():
    """The full enc-dec's slot cache (8 slots, 1024 decoder rows, 512
    memory rows): ``k_mem``/``v_mem`` (L, B, M, H, d) on the cross heads
    and the slots, ``pos`` on the slots alone, by both packages' rules on
    the same shapes."""
    cfg = to_port_cfg(get_config("seamless-m4t-large-v2"))
    pmodel = build_model(cfg)

    def tmpl(batch):
        return pmodel.init_cache(batch, 1024, torch.device("meta"),
                                 mem_len=512)
    t8 = tmpl(8)
    axes = _infer_batch_axes(tmpl(1), tmpl(2))
    for sizes in ({"model": 2}, {"data": 2, "model": 2}, {"model": 4},
                  {"data": 2, "model": 4}):
        got = flatten(slot_specs(t8, axes, sizes, name=cfg.name))
        want = _jax_flat(jax_slot_specs(t8, axes, sizes, name=cfg.name))
        assert set(got) == set(want)
        for path, spec in want.items():
            assert got[path] == _spec_tuple(spec, flatten(t8)[path].ndim)
        d = "data" if "data" in sizes else None
        assert got["dec/cross/k_mem"] == (None, d, None, "model", None)
        assert got["dec/cross/v_mem"] == (None, d, None, "model", None)
        assert got["pos"] == (d,)


# the leaves whose split the head-parallel forward takes on another dim
# than JAX's rule: (config, mesh) -> the differing paths' last two keys
DIFFERENCES = {
    ("qwen2-1.5b", "model=2"): {"mixer/bq", "mixer/bk", "mixer/bv",
                                "mixer/rope_inv_q", "mixer/rope_inv_k"},
    ("deepseek-7b", "model=2"): {"mixer/rope_inv_q", "mixer/rope_inv_k"},
    ("deepseek-7b", "model=4"): {"mixer/rope_inv_q", "mixer/rope_inv_k"},
    ("rwkv6-3b", "model=2"): {"mixer/u", "mixer/wr", "mixer/wk",
                              "mixer/wv", "mixer/wg"},
    ("rwkv6-3b", "model=4"): {"mixer/u", "mixer/wr", "mixer/wk",
                              "mixer/wv", "mixer/wg"},
    ("seamless-m4t-large-v2", "model=2"): set(),
    ("seamless-m4t-large-v2", "model=4"): set(),
    ("qwen3-moe-235b-a22b", "model=2"): {"mixer/rope_inv_k"},
    ("qwen3-moe-235b-a22b", "model=4"): {"mixer/rope_inv_k"},
    # the pruned MoE: bd_moe (E, D) on its experts, where JAX splits D
    ("qwen3-moe-235b-a22b+pruned", "model=2"): {
        "mixer/rope_inv_k", "mlp/bd_moe"},
    ("qwen3-moe-235b-a22b+pruned", "model=4"): {
        "mixer/rope_inv_k", "mlp/bd_moe"},
    # MLA follows JAX's rule (heads, and D's rows of the down-projections);
    # the shared expert's F = 2048 < D on its columns and rows
    ("deepseek-v3-671b", "model=2"): {"shared/wg", "shared/wu",
                                      "shared/wd"},
    ("deepseek-v3-671b", "model=4"): {"shared/wg", "shared/wu",
                                      "shared/wd"},
    # the Mamba mixer at d_inner 16384 >= D follows JAX's rule
    ("jamba-1.5-large-398b", "model=2"): {"mixer/rope_inv_k"},
    ("jamba-1.5-large-398b", "model=4"): {"mixer/rope_inv_k"},
    # kept d_inner 4096 < D = 8192: in_proj (D, 8192) on its (paired)
    # columns and out_proj (4096, D) on its rows, where JAX splits D; the
    # dense MLP's F = 6144 < D likewise, and the MoE layers' bd_moe
    ("jamba-1.5-large-398b+pruned75", "model=2"): {
        "mixer/rope_inv_k", "mixer/in_proj", "mixer/out_proj", "mlp/wg",
        "mlp/wu", "mlp/wd", "mlp/bd_moe"},
    ("jamba-1.5-large-398b+pruned75", "model=4"): {
        "mixer/rope_inv_k", "mixer/in_proj", "mixer/out_proj", "mlp/wg",
        "mlp/wu", "mlp/wd", "mlp/bd_moe"},
}


@pytest.mark.parametrize("arch,mesh", sorted(DIFFERENCES))
def test_forward_specs_keep_jax_element_counts(arch, mesh):
    """At full width: the forward's split equals JAX's rule but for the
    listed leaves (ROADMAP Queue 3's deliberate differences; the pruned
    MoE's ``bd_moe`` and the pruned Mamba mixer's ``in_proj`` and
    ``out_proj`` among them), and every leaf's block holds JAX's
    element count; a rank's blocks cut by ``shard_params`` have those
    shapes."""
    m = int(mesh.split("=")[1])
    sizes = {"data": 2, "model": m}
    tree = _full_shapes(arch)
    shapes = {p: tuple(s.shape) for p, s in _jax_flat(tree).items()}
    want = {p: _spec_tuple(s, len(shapes[p])) for p, s in _jax_flat(
        jax_param_specs(tree, DuckMesh(sizes))).items()}
    nested = jax.tree.map(lambda s: tuple(s.shape), tree)
    got = flatten(forward_specs(nested, sizes))
    differ = {"/".join(p.split("/")[-2:]) for p in want if got[p] != want[p]}
    assert differ == DIFFERENCES[(arch, mesh)]
    for path, spec in want.items():
        assert _numel_block(shapes[path], got[path], sizes) \
            == _numel_block(shapes[path], spec, sizes), path
    # a rank's blocks (meta tensors: shapes only) hold those counts
    meta = jax.tree.map(lambda s: torch.empty(tuple(s.shape), device="meta"),
                        tree)
    blocks = flatten(shard_params(meta, forward_specs(meta, sizes), sizes,
                                  rank=3))
    for path, spec in want.items():
        assert blocks[path].numel() == _numel_block(shapes[path], spec,
                                                    sizes), path


def test_paired_in_proj_block_is_x_then_z_channels():
    """A rank's block of Mamba's ``in_proj`` (D, 2 d_inner) = (x | z) is
    its block of x's columns followed by the same block of z's, with
    JAX's element count, cut alike from numpy (``interop.rank_blocks``)
    and from tensors; ``out_proj`` takes the same channels' rows."""
    from repro_torch.interop import rank_blocks
    D, di, sizes = 8, 16, {"data": 1, "model": 4}
    tree = {"mixer": {
        "in_proj": np.arange(3 * D * 2 * di, dtype=np.float32)
        .reshape(3, D, 2 * di),
        "out_proj": np.arange(3 * di * D, dtype=np.float32)
        .reshape(3, di, D),
        "conv_w": np.zeros((3, 4, di), np.float32)}}
    seg = {"seg0": {"p0": tree}}
    specs = forward_specs(seg, sizes)
    assert specs["seg0"]["p0"]["mixer"]["in_proj"] == (None, None, "model")
    jax_spec = _jax_flat(jax_param_specs(seg, DuckMesh(sizes)))
    x, z = tree["mixer"]["in_proj"][..., :di], tree["mixer"]["in_proj"][
        ..., di:]
    for rank in range(4):
        lo, hi = rank * di // 4, (rank + 1) * di // 4
        got = shard_params(seg, specs, sizes, rank)["seg0"]["p0"]["mixer"]
        np.testing.assert_array_equal(
            got["in_proj"], np.concatenate([x[..., lo:hi], z[..., lo:hi]],
                                           -1))
        np.testing.assert_array_equal(got["out_proj"],
                                      tree["mixer"]["out_proj"][:, lo:hi])
        assert got["in_proj"].size == _numel_block(
            (3, D, 2 * di), jax_spec["seg0/p0/mixer/in_proj"], sizes)
        cut = rank_blocks(seg, specs, sizes, rank, "cpu")["seg0"]["p0"]
        assert torch.equal(cut["mixer"]["in_proj"],
                           torch.from_numpy(got["in_proj"]))


class _ThreadHost:
    """What ``TensorParallel`` reads of a host transport, for ranks that
    are threads of one process: each posts its tensor, waits for the
    others, reads them all, and waits again before the next exchange."""

    def __init__(self, board, barrier, index):
        self.board, self.barrier, self.index = board, barrier, index

    def _swap(self, x):
        self.board[self.index] = x.clone()
        self.barrier.wait()
        parts = list(self.board)
        self.barrier.wait()
        return parts

    def all_reduce(self, x):
        parts = self._swap(x)
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.float()
        return acc.to(x.dtype)

    def all_gather(self, x, dim):
        return torch.cat(self._swap(x), dim)


@pytest.mark.parametrize("model", [2, 4])
def test_mla_latent_blocks_and_gathered_cache_equal_one_device(model):
    """MLA under ``tp`` on ``model`` thread ranks: a prefill's cache is each
    rank's ``slot_specs`` block of one device's ``ckv``/``k_rope`` (on
    their last dim), a decode step writes the rank's blocks of the new row
    and the gathered latent then equals one device's cache, the outputs
    equal one device's, and a decode step makes three collectives (the
    fused input reduction, the gather, the output reduction)."""
    import threading
    from repro_torch.distrib.sharding import block_of
    from repro_torch.models import attention as attn
    from repro_torch.models.common import TensorParallel
    from repro_torch.models.lm import _pad_cache
    cfg = to_port_cfg(reduced(get_config("deepseek-v3-671b")))
    layer = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")["seg0"]["l0"]["mixer"]
    g = torch.Generator().manual_seed(1)
    B, T, S = 2, 5, 8
    x = torch.randn(B, T, cfg.d_model, generator=g)
    x1 = torch.randn(B, 1, cfg.d_model, generator=g)
    pos = torch.arange(T)[None].expand(B, T)
    y_ref, c_ref = attn._apply_mla(layer, x, cfg, positions=pos,
                                   return_cache=True)
    c_ref = _pad_cache(c_ref, S)
    prefill_ref = {k: c_ref[k].clone() for k in ("ckv", "k_rope")}
    y1_ref, _ = attn._decode_mla(layer, x1, c_ref, cfg)
    sizes = {"model": model}
    specs = forward_specs({"mixer": layer}, sizes)["mixer"]
    tmpl = {k: c_ref[k] for k in ("ckv", "k_rope", "pos")}
    cspec = slot_specs(tmpl, {"ckv": 0, "k_rope": 0, "pos": 0}, sizes)
    board, barrier, out = [None] * model, threading.Barrier(model), {}

    def rank(r):
        tp = TensorParallel(None, r, model,
                            host=_ThreadHost(board, barrier, r))
        p = shard_params(layer, specs, sizes, r)
        y, c = attn._apply_mla(p, x, cfg, positions=pos, return_cache=True,
                               tp=tp)
        c = _pad_cache(c, S)
        blocks = {k: c[k].clone() for k in ("ckv", "k_rope")}
        y1, c = attn._decode_mla(p, x1, c, cfg, tp)
        calls = tp.calls
        whole = attn._gather_latent(tp, c["ckv"], c["k_rope"])
        out[r] = (y, y1, blocks, c, whole, calls)
    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(model)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(out) == list(range(model))
    for r, (y, y1, blocks, c, whole, calls) in out.items():
        assert calls == 2 + 3       # prefill 2, one decode step 3
        torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(y1, y1_ref, rtol=1e-5, atol=1e-5)
        for i, k in enumerate(("ckv", "k_rope")):
            assert cspec[k] == (None, None, "model")
            want = block_of(prefill_ref[k], cspec[k], sizes, {"model": r})
            assert blocks[k].shape == want.shape
            torch.testing.assert_close(blocks[k], want, rtol=1e-5,
                                       atol=1e-5)
            torch.testing.assert_close(whole[i], c_ref[k], rtol=1e-5,
                                       atol=1e-5)
        assert torch.equal(c["pos"], c_ref["pos"])


def test_rank_blocks_of_a_jax_tree_equal_the_tensor_tree_s():
    """``interop.rank_blocks`` cuts a carried JAX tree (numpy) on the host
    into the blocks ``shard_params`` cuts from the tensors, on every rank
    of a 2 x 2 mesh."""
    from repro_torch.interop import from_numpy, rank_blocks
    from torch_parity import jax_params
    cfg = reduced(get_config("rwkv6-3b"))
    tree = jax_params(cfg, seed=1)
    sizes = {"data": 2, "model": 2}
    specs = forward_specs(tree, sizes)
    whole = from_numpy(tree, "cpu")
    for rank in range(4):
        got = flatten(rank_blocks(tree, specs, sizes, rank, "cpu"))
        want = flatten(shard_params(whole, specs, sizes, rank))
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (rank, k)


@pytest.mark.parametrize("sizes", MESHES + FSDP_MESHES)
def test_batch_specs_equal_jax(sizes):
    """The leading dim over ("pod", "data") where it divides, else
    replicated, as JAX's ``batch_specs`` places a batch. On a mesh with
    neither axis JAX's raises (reference fault 7, ROADMAP Queue 3: it
    indexes an empty axis tuple); the port's keeps the batch
    replicated."""
    from repro.distrib.sharding import batch_specs as jax_batch_specs
    from repro_torch.distrib.sharding import batch_specs
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "frames": np.zeros((8, 16, 4), np.float32),
             "odd": np.zeros((3, 5), np.float32),
             "nested": {"x": np.zeros((4,), np.float32)}}
    got = flatten(batch_specs(batch, sizes))
    if not {"pod", "data"} & set(sizes):
        with pytest.raises(IndexError):
            jax_batch_specs(batch, DuckMesh(sizes))
        assert all(spec == (None,) * np.ndim(flatten(batch)[path])
                   for path, spec in got.items())
        return
    want = _jax_flat(jax_batch_specs(batch, DuckMesh(sizes)))
    assert set(got) == set(want)
    for path, spec in want.items():
        assert got[path] == _spec_tuple(
            spec, np.ndim(flatten(batch)[path])), (sizes, path)


@pytest.mark.parametrize("device_type,world,cards,machine,want", [
    ("cuda", 4, 1, "x86_64", True),        # four ranks on one card
    ("cuda", 4, 4, "x86_64", False),       # a card a rank: the group
    ("cuda", 1, 1, "x86_64", False),
    ("cpu", 4, 0, "x86_64", False),        # CPU ranks: the group
    ("cuda", 4, 1, "aarch64", False),      # no x86-64 store order
])
def test_shares_card_takes_shared_memory_only_for_ranks_on_one_card(
        monkeypatch, device_type, world, cards, machine, want):
    from repro_torch.serve import sharding as serve_sharding

    class Mesh:
        pass
    mesh = Mesh()
    mesh.device_type = device_type
    monkeypatch.setattr(serve_sharding.dist, "get_world_size", lambda: world)
    monkeypatch.setattr(serve_sharding.torch.cuda, "device_count",
                        lambda: cards)
    monkeypatch.setattr(serve_sharding.platform, "machine", lambda: machine)
    assert serve_sharding.shares_card(mesh) is want


def _rank_sharding(sizes, coords):
    """A ``ServeSharding`` of one rank at ``coords`` with no groups (its
    gathers hold this rank's value alone)."""
    from repro_torch.serve.sharding import ServeSharding

    class RankSharding(ServeSharding):
        def __init__(self):
            self.axis_names, self.shape = tuple(sizes), tuple(sizes.values())
            self.data_axis, self.model_axis = "data", "model"
            self.coords, self.data_index = coords, coords["data"]

        def gather_all(self, value):
            return [value]
    return RankSharding()


@pytest.mark.parametrize("arch,model", [("deepseek-7b", 2), ("rwkv6-3b", 2),
                                        ("gemma3-1b", 1)])
def test_sharded_slot_cache_blocks_equal_the_cut_of_the_whole_cache(
        arch, model):
    """A rank's cache blocks, allocated at their own shapes from its block
    of one empty slot, equal its cut of the whole empty cache on every
    rank of a ``2 x model`` mesh (gemma3's rings start at -1), and so
    does a recurrent cache's empty slot."""
    from repro_torch.serve.cache import RecurrentSlotCache, cache_contract
    from repro_torch.serve.cache import SlotCache
    cfg = to_port_cfg(reduced(get_config(arch)))
    pmodel = build_model(cfg)

    def template(batch, device):
        return pmodel.init_cache(batch, MAX_LEN, device)
    cls = RecurrentSlotCache if cache_contract(cfg) == "recurrent" \
        else SlotCache
    sizes = {"data": 2, "model": model}
    cpu = torch.device("cpu")
    for d, m, n in np.ndindex(2, model, 2):
        n_slots = 2 * (n + 1)       # one slot a data index, then two
        sh = _rank_sharding(sizes, {"data": d, "model": m})
        sc = cls(template, n_slots, device=cpu, sharding=sh, name=cfg.name)
        want = flatten(sh.block(template(n_slots, cpu), sc.specs))
        got = flatten(sc.cache)
        assert set(got) == set(want)
        blank = flatten(sh.block(template(1, cpu), sc.local_specs))
        for path, t in want.items():
            assert torch.equal(got[path], t), (arch, d, m, path)
            assert got[path].is_contiguous()
            # the cache holds its own memory, not the empty slot's
            assert got[path].untyped_storage().data_ptr() != flatten(
                sc._blank)[path].untyped_storage().data_ptr()
        assert sc.rank_bytes == [device_bytes_estimate(
            sc._meta, sc.specs, sizes)]
        for path, t in flatten(sc._blank).items():
            assert torch.equal(t, blank[path]), (arch, path)


def test_host_collective_raises_when_a_rank_never_arrives(tmp_path,
                                                         monkeypatch):
    """A shared-memory collective whose other rank is gone raises, naming
    it, once its wait passes ``TIMEOUT_S``, where it would spin forever."""
    from repro_torch.distrib import hostcoll
    path = tmp_path / "tp"
    with open(path, "wb") as f:
        f.truncate(8 * 2 + 2 * 2 * hostcoll.SLOT_BYTES)
    monkeypatch.setattr(hostcoll, "TIMEOUT_S", 0.05)
    hc = hostcoll.HostCollectives(str(path), 2, 0)
    with pytest.raises(TimeoutError, match=r"ranks \[1\] of the group"):
        hc.all_reduce(torch.ones(3))
