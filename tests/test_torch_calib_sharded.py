"""The port's mesh-sharded calibration statistics against the JAX package's
single-device engine (the JAX package's own sharded tests fail on this jax,
ROADMAP "State of the reference"), after tests/test_sharded_calibration.py.

The port's ranks are spawned processes on the CPU (``gloo``), one spawn a
world size: 2 ranks (meshes 1x2 and 2x1, and a checkpoint written under
2x1), 4 ranks (2x2 on DeiT-Base, granite-8b and qwen3-moe, the latter also
at its real capacity factor, where experts drop tokens, with data shares
that keep or cut its routing groups; every phase, bf16 taps, a 3-axis
mesh, resume and the foreign 2x1 checkpoint; pass 1 of rwkv6-3b,
deepseek-v3, jamba, seamless, gemma3 and internvl) and 1 rank (1x1). Every
rank holds only its ``forward_specs`` blocks of the parameters and runs
the forward tensor-parallel. The reduced configs with one kv head, which a
2-way model axis could split only by replicating it
(``distrib.sharding.check_forward_split``), run as 2-kv-head variants in
both packages. The ranks rendezvous through a
``file://`` store in the test's temporary directory and run
``tests/torch_dist_parity.py``, which imports no jax.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import batch_for, calib_factory, tiny_cfg  # noqa: E402
from repro.core import CalibrationEngine as JaxEngine  # noqa: E402
from repro.core import discover_units as jax_units  # noqa: E402
from repro.core import ranking as jax_ranking  # noqa: E402
from repro.core import stats as jax_stats  # noqa: E402
from repro.configs import ARCH_IDS, get_config, reduced  # noqa: E402
from repro.distrib.sharding import param_specs as jax_param_specs  # noqa: E402
from repro.distrib.sharding import stats_specs as jax_stats_specs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.core import stats as stats_mod  # noqa: E402
from repro_torch.distrib import stats_specs  # noqa: E402
from repro_torch.distrib.sharding import (  # noqa: E402
    check_forward_split, forward_specs, shard_params, splits)
from repro_torch.interop import flatten  # noqa: E402
from repro_torch.launch.mesh import launch  # noqa: E402
from torch_dist_parity import (load_stats, stats_ranks,  # noqa: E402
                               write_job)
from torch_parity import jax_params, to_port_cfg  # noqa: E402

ARCHS = {"deit": "deit-base", "granite": "granite-8b",
         "moe": "qwen3-moe-235b-a22b"}
# pass 1 of each other family on a 2x2 mesh, inside the same spawn; the
# deeper ones cut to 2 layers that keep every kind of layer (deepseek's
# dense and MoE layers, jamba's Mamba + dense MLP and attention + MoE,
# gemma's window and global attention), for the JAX references' compiles
FAMILIES = {"rwkv": ("rwkv6-3b", {}),
            "mla": ("deepseek-v3-671b", dict(n_layers=2)),
            "jamba": ("jamba-1.5-large-398b",
                      dict(n_layers=2, pattern=("mamba", "attn"))),
            "seamless": ("seamless-m4t-large-v2", {}),
            "gemma": ("gemma3-1b", dict(n_layers=2, pattern=("swa", "attn"))),
            "internvl": ("internvl2-26b", {})}
TOL = 2e-4      # JAX's own sharded-vs-single tolerance


def _cfg(arch, **kw):
    """``tiny_cfg(arch, **kw)``; a reduced config with one kv head, which a
    2-way model axis splits only by kv-head replication, as a 2-kv-head
    variant."""
    cfg = tiny_cfg(arch, **kw)
    return cfg if cfg.mla is not None or cfg.n_kv_heads % 2 == 0 \
        else tiny_cfg(arch, n_kv_heads=2, **kw)


def _np_batches(cfg, n=3, **kw):
    return [{k: np.asarray(v) for k, v in b.items()}
            for b in calib_factory(cfg, n=n, **kw)()]


def _dropping_moe():
    """qwen3-moe (2 kv heads) at its real capacity factor 1.25
    (``tiny_cfg`` sets 8.0, where no expert can overflow), for batches of
    3 x 685 tokens: routing groups of 685 tokens (the largest divisor of
    2055 up to 2048), one a row, in which experts drop pairs. A 2-way data
    axis gives one rank two rows, 1370 tokens, which routed as their own
    batch would be one group of 1370 with other drops."""
    cfg = _cfg(ARCHS["moe"])
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))


def _jax_job(d, name, cfg=None, batches=None, pass1_only=False):
    """Weights, batches and the JAX package's single-device statistics of
    one config; writes the ranks' ``.npz``."""
    cfg = _cfg(ARCHS[name]) if cfg is None else cfg
    params = jax_params(cfg, seed=3)
    batches = _np_batches(cfg) if batches is None else batches
    model, units = jax_build(cfg), jax_units(cfg)
    jp = jax.tree.map(jnp.asarray, params)

    def calib():
        return ({k: jnp.asarray(v) for k, v in b.items()} for b in batches)

    ref = {"cfg": to_port_cfg(cfg), "params": params,
           "p1": JaxEngine(model, units, phase=1).run(jp, calib())}
    if pass1_only:
        write_job(d / f"{name}.npz", params, batches)
        return ref
    plan, spec = {}, {}
    for u in units:
        if u.kind in ("attn", "mla", "cross"):
            st = ref["p1"][u.name]
            full = st["rank"].shape[-1]
            plan[u.name] = jax_ranking.rank_attn(st, max(1, full // 2))
            spec[u.name] = jax_ranking.candidate_attn(st, max(1, full // 2),
                                                      0.5)
    ref["p2"] = JaxEngine(model, units, phase=2, plan=plan).run(jp, calib())
    if name == "deit":
        ref["p12"] = JaxEngine(model, units, phase="1+2",
                               spec_plan=spec).run(jp, calib())
        ref["bf16"] = JaxEngine(model, units, phase=1,
                                stats_dtype="bfloat16").run(jp, calib())
    write_job(d / f"{name}.npz", params, batches,
              {"plan": plan, "spec": spec})
    return ref


# the 4-rank spawn's statistics tasks: tag -> (job, mesh, engine keywords)
FOUR = {
    "deit_p1": ("deit", (2, 2), {}),
    "deit_placed": ("deit", (2, 2), dict(placed=True)),
    "deit_p2": ("deit", (2, 2), dict(phase=2, plan="plan")),
    "deit_p12": ("deit", (2, 2), dict(phase="1+2", spec_plan="spec")),
    "deit_bf16": ("deit", (2, 2), dict(stats_dtype="bfloat16")),
    "deit_3axis": ("deit", (2, 1, 2), {}),
    "deit_resumed": ("deit", (2, 2), dict(ckpt="resume")),
    "deit_foreign": ("deit", (2, 2), dict(ckpt="foreign")),
    "granite_p1": ("granite", (2, 2), {}),
    "granite_p2": ("granite", (2, 2), dict(phase=2, plan="plan")),
    "moe_p1": ("moe", (2, 2), dict(expert_moments=True)),
    "moe_drop_p1": ("moe_drop", (2, 2), dict(expert_moments=True)),
    "moe_drop_p2": ("moe_drop", (2, 2), dict(phase=2, plan="plan")),
    "moe_cut_p1": ("moe_cut", (2, 2), dict(expert_moments=True)),
    **{f"{f}_p1": (f, (2, 2), dict(expert_moments=True)) for f in FAMILIES},
    "gemma_p2": ("gemma", (4, 1), dict(phase=2, plan="plan")),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("calib_sharded")
    refs = {name: _jax_job(d, name) for name in ARCHS}
    drop = _dropping_moe()
    refs["moe_drop"] = _jax_job(d, "moe_drop", drop,
                                _np_batches(drop, n=1, B=3, T=685))
    # one routing group of 1200 tokens, which the data ranks' 2 and 1 rows
    # cut
    refs["moe_cut"] = _jax_job(d, "moe_cut", drop,
                               _np_batches(drop, n=1, B=3, T=400),
                               pass1_only=True)
    for fam, (arch, kw) in FAMILIES.items():
        cfg = _cfg(arch, **kw)
        refs[fam] = _jax_job(d, fam, cfg, _np_batches(cfg, n=1, B=4, T=16),
                             pass1_only=fam != "gemma")
    cfg = {name: r["cfg"] for name, r in refs.items()}

    def task(name, tag, shape, phase=1, **kw):
        return dict(job=name, cfg=cfg[name], tag=tag, shape=shape,
                    phase=phase, **kw)

    foreign = str(d / "ckpt_foreign")
    ckpts = {"resume": (str(d / "ckpt"), 2), "foreign": (foreign, 0)}
    launch(stats_ranks, 2, backend="gloo", device="cpu",
           init_method=f"file://{d}/rdzv2", args=(str(d), [
               task("deit", "deit_1x2", (1, 2)),
               task("deit", "deit_2x1", (2, 1), ckpt=(foreign, 3))]))
    four = []
    for tag, (job, shape, kw) in FOUR.items():
        kw = dict(kw)
        if "ckpt" in kw:
            kw["ckpt"] = ckpts[kw["ckpt"]]
        four.append(task(job, tag, shape, **kw))
    launch(stats_ranks, 4, backend="gloo", device="cpu",
           init_method=f"file://{d}/rdzv4", args=(str(d), four + [
               {"remesh": [None, (1, 2), (8, 1)], "tag": "remesh"}]))
    launch(stats_ranks, 1, backend="gloo", device="cpu",
           init_method=f"file://{d}/rdzv1", args=(str(d), [
               task("deit", "deit_1x1", (1, 1), plain=True)]))

    def got(tag):
        return load_stats(d / f"{tag}.npz")

    def meta(tag):
        return json.loads((d / f"{tag}.json").read_text())

    def ranks(tag, n=4):
        return [json.loads((d / f"{tag}_rank{r}.json").read_text())
                for r in range(n)]
    return types.SimpleNamespace(refs=refs, got=got, ranks=ranks, meta=meta)


def _close(got, want, rtol=TOL, na_within_one=False):
    """Every leaf of ``want`` (the JAX package's) against ``got``;
    ``na_within_one``: an activity count may differ by one, a tap within
    rounding of the |x| > 1e-2 threshold falling the other way."""
    assert sorted(got) == sorted(want)
    for unit, stats in want.items():
        assert sorted(got[unit]) == sorted(stats), unit
        for k, w in stats.items():
            g, w = np.asarray(got[unit][k]), np.asarray(w)
            assert g.shape == w.shape, (unit, k, g.shape, w.shape)
            if na_within_one and k == "na":
                assert np.abs(g - w).max() <= 1.0, unit
                continue
            np.testing.assert_allclose(
                g, w, rtol=rtol, atol=rtol * max(1.0, float(np.abs(w).max())),
                err_msg=f"{unit}/{k}")


@pytest.mark.parametrize("name", ["deit", "granite"])
def test_2x2_statistics_match_single_device_jax(runs, name):
    """Pass 1 and pass 2 (class 1 on DeiT, class 2 rope on granite) of a
    2 data x 2 model mesh, gathered, within 2e-4 of the JAX package's
    single-device engine (JAX's own tolerance, its floor scaled by the
    leaf's largest entry where that exceeds 1)."""
    _close(runs.got(f"{name}_p1"), runs.refs[name]["p1"])
    _close(runs.got(f"{name}_p2"), runs.refs[name]["p2"])


@pytest.mark.parametrize("name", ["deit", "granite"])
def test_2x2_ranks_hold_column_blocks(runs, name):
    """Every dense unit's s2 is (..., F, F/2) on each rank, and each rank's
    accumulator is at most half the unsharded one plus its replicated
    leaves."""
    full = runs.got(f"{name}_p1")
    sizes = {u: {k: np.asarray(v) for k, v in st.items()}
             for u, st in full.items()}
    specs = stats_specs(sizes, {"data": 2, "model": 2})
    total = sum(v.nbytes for st in sizes.values() for v in st.values())
    replicated = sum(v.nbytes for u, st in sizes.items()
                     for k, v in st.items() if specs[u][k] is None)
    dense = [u for u, st in sizes.items() if "s2" in st]
    assert dense
    for info in runs.ranks(f"{name}_p1"):
        for u in dense:
            F = sizes[u]["s2"].shape[-1]
            assert tuple(info["local_shapes"][f"{u}/s2"]) \
                == sizes[u]["s2"].shape[:-1] + (F // 2,)
        assert info["local_bytes"] <= total / 2 + replicated


def test_2x2_pass2_ranks_hold_g_column_blocks(runs):
    """Pass 2's class-1 G (DeiT-Base: (L, G, ds^2, ds^2)) is accumulated
    as each rank's (L, G, ds^2, ds^2/2) block, and the one-traversal pass's
    Gc and Hfull as blocks of their last dim."""
    full = runs.got("deit_p2")
    for info in runs.ranks("deit_p2"):
        for u, st in full.items():
            G = np.asarray(st["G"])
            assert tuple(info["local_shapes"][f"{u}/G"]) \
                == G.shape[:-1] + (G.shape[-1] // 2,)
    spec = runs.got("deit_p12")["p2spec"]
    for info in runs.ranks("deit_p12"):
        for u, st in spec.items():
            for k in ("Gc", "Hfull"):
                w = np.asarray(st[k]).shape
                assert tuple(info["local_shapes"][f"p2spec/{u}/{k}"]) \
                    == w[:-1] + (w[-1] // 2,), (u, k)


@pytest.mark.parametrize("ds,m", [(4, 2), (6, 4), (3, 3)])
def test_add_kron_into_a_column_block_equals_those_columns(ds, m,
                                                           monkeypatch):
    """``_add_kron(cols=)`` adds into a rank's block of G's (j k) columns
    what the whole G gets there, whether the block holds whole j rows
    (ds % m == 0) or cuts one (ds 6 on 4 ranks: blocks of 9), in any
    chunking of the groups."""
    rng = np.random.default_rng(ds * m)
    A, C = (torch.from_numpy(rng.standard_normal((5, 3, ds, ds))
                             .astype(np.float32)) for _ in range(2))
    want = torch.einsum("gbij,gblk->giljk", A, C).reshape(5, ds * ds, ds * ds)
    w = ds * ds // m
    for chunk in (ds ** 3, 1 << 28):
        monkeypatch.setattr(stats_mod, "_KRON_CHUNK", chunk)
        for r in range(m):
            out = torch.ones(5, ds * ds, w)
            stats_mod._add_kron(out, A, C, (r * w, (r + 1) * w))
            torch.testing.assert_close(out, want[..., r * w:(r + 1) * w] + 1,
                                       rtol=1e-6, atol=1e-5)


def test_one_traversal_and_bf16_statistics_match_jax(runs):
    """Phase "1+2" (pass 1 and the speculative sums) and bf16 taps under
    the 2x2 mesh against JAX's single-device engine; bf16 within the
    tolerance of tests/test_torch_calibration.py's bf16 parity (a tap near
    a rounding boundary may round one ulp the other way)."""
    got, want = runs.got("deit_p12"), runs.refs["deit"]["p12"]
    assert sorted(got) == ["p1", "p2spec"]
    for part in got:
        _close(got[part], want[part])
    _close(runs.got("deit_bf16"), runs.refs["deit"]["bf16"], rtol=1e-3,
           na_within_one=True)


def test_moe_expert_moments_under_a_mesh(runs):
    """A routed-MoE unit (per-expert moments and the expert-removal
    moments) on 2x2: its rows routed on each rank, with no capacity drop
    (``tiny_cfg``), sum to the single-device statistics."""
    _close(runs.got("moe_p1"), runs.refs["moe"]["p1"])


def test_moe_with_capacity_drops_routes_the_whole_batch_groups(runs):
    """qwen3-moe at capacity factor 1.25, where experts drop (token, k)
    pairs: on 2x2 the data ranks take 2 and 1 of a batch's 3 rows and
    route the batch's own groups of 685 tokens (two and one), so pass 1
    (expert moments and the expert-removal moments) and pass 2 match the
    JAX package's single-device engine, which routes the whole batch. A
    rank's forward of part of the rows rounds otherwise than the whole
    batch's, so an activity count may differ by one (a tap at the 1e-2
    threshold); a routing difference moves whole expert queues."""
    ref = runs.refs["moe_drop"]
    cfg = _dropping_moe()
    kept = sum(float(np.asarray(st["n"]).sum()) for st in ref["p1"].values()
               if "ys2" in st)
    pairs = 3 * 685 * cfg.moe.top_k * cfg.n_layers
    assert 0 < kept < pairs      # some pairs were dropped
    _close(runs.got("moe_drop_p1"), ref["p1"], na_within_one=True)
    _close(runs.got("moe_drop_p2"), ref["p2"])


def test_moe_row_share_routes_whole_groups_or_raises(runs):
    """A data rank's share that cuts a routing group no longer raises:
    qwen3-moe at capacity factor 1.25 on batches of 3 x 400 tokens, one
    group of 1200 in which experts drop pairs, of which the 2x2 mesh's data
    ranks take 2 and 1 rows. Each rank gathers the batch's rows over the
    data axis, routes the group as one device does and keeps its own rows
    (``models.mlp._apply_moe_tp``), so pass 1 (expert moments and the
    expert-removal moments) equals the JAX package's single-device engine
    (an activity count within one, as in the whole-group case)."""
    ref = runs.refs["moe_cut"]
    cfg = _dropping_moe()
    kept = sum(float(np.asarray(st["n"]).sum()) for st in ref["p1"].values()
               if "ys2" in st)
    assert 0 < kept < 3 * 400 * cfg.moe.top_k * cfg.n_layers
    _close(runs.got("moe_cut_p1"), ref["p1"], na_within_one=True)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_family_pass1_on_placed_blocks_matches_single_device_jax(runs, fam):
    """Pass 1 of every other family on a 2x2 mesh, each rank forwarding
    over its blocks: RWKV-6 over its heads (``wkv6``), deepseek-v3's MLA
    over its heads with the fused down-projection reduction, jamba's Mamba
    over its inner channels beside attention and routed MoE, seamless's
    encoder, decoder and cross attention, gemma3's window and qk-norm,
    internvl's patch embeddings; within 2e-4 of the JAX package's
    single-device engine."""
    _close(runs.got(f"{fam}_p1"), runs.refs[fam]["p1"], na_within_one=True)


def test_class3_pass2_under_a_data_axis_matches_single_device_jax(runs):
    """gemma3's class-3 (rope + qk-norm) pass 2 on a 4 x 1 mesh (data axis
    only, where no column block copies the leaves): its G and h are the
    real parts of complex sums, which the batch axes' sum once read through
    their strided view, so the ranks summed other words and folded
    different weights; within 2e-4 of JAX's single-device engine."""
    _close(runs.got("gemma_p2"), runs.refs["gemma"]["p2"])


def _numel_block(shape, spec, sizes):
    den = 1
    for e in spec:
        if e is not None:
            den *= math.prod(sizes[a] for a in ((e,) if isinstance(e, str)
                                                else e))
    return math.prod(shape) // den


class _DuckMesh:
    """What JAX's ``param_specs`` reads of a mesh."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


@pytest.mark.parametrize("tag", list(FOUR))
def test_ranks_hold_forward_specs_blocks_at_jax_counts(runs, tag):
    """Each rank of every 4-rank task placed, for its pass, the blocks that
    ``forward_specs`` gives its coordinates (their shapes and bytes), and
    each block holds the element count of JAX's ``param_specs`` block:
    about a model axis' share of the tree, never the whole of it."""
    job, shape, _ = FOUR[tag]
    params = runs.refs[job]["params"]
    sizes = dict(zip(("pod", "data", "model")[-len(shape):], shape))
    flat = flatten(params)
    jspecs = {"/".join(str(k.key) for k in kp): tuple(sp) for kp, sp in
              jax.tree_util.tree_flatten_with_path(
                  jax_param_specs(params, _DuckMesh(sizes)),
                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
              [0]}
    meta = {k: torch.empty(v.shape, device="meta") for k, v in flat.items()}
    whole = sum(v.nbytes for v in flat.values())
    for r, info in enumerate(runs.ranks(tag)):
        blocks = flatten(shard_params(
            jax.tree.map(lambda a: torch.empty(a.shape, device="meta"),
                         params),
            forward_specs(params, sizes), sizes, r))
        assert {k: tuple(v) for k, v in info["param_shapes"].items()} \
            == {k: tuple(b.shape) for k, b in blocks.items()}, r
        assert info["param_bytes"] == sum(4 * b.numel()
                                          for b in blocks.values())
        assert info["param_bytes"] < whole if sizes["model"] > 1 \
            else info["param_bytes"] == whole
        for k, b in blocks.items():
            spec = jspecs[k] + (None,) * (len(meta[k].shape) - len(jspecs[k]))
            assert b.numel() == _numel_block(meta[k].shape, spec, sizes), k


def test_one_kv_head_refuses_a_two_way_model_axis():
    """The reduced granite's one kv head cannot split over a 2-way model
    axis: the engine refuses it before any forward, naming the missing
    kv-head replication, where it would otherwise run on other blocks than
    its forward splits. Heads that do not divide the axis at all are a
    ``ValueError`` naming them."""
    cfg = to_port_cfg(tiny_cfg(ARCHS["granite"]))
    with pytest.raises(NotImplementedError, match="kv-head replication"):
        check_forward_split(cfg, 2)
    check_forward_split(cfg, 1)
    check_forward_split(to_port_cfg(_cfg(ARCHS["granite"])), 2)
    with pytest.raises(ValueError, match="n_kv_heads 2"):
        check_forward_split(to_port_cfg(_cfg(ARCHS["granite"])), 3)


def test_blocks_placed_by_the_caller_give_the_same_statistics(runs):
    """A caller that places its rank's blocks itself
    (``CalibSharding.place``, one rank at a time where the host cannot
    hold every rank's tree) and passes them gets bitwise the statistics of
    the engine's own placement."""
    ref, got = runs.got("deit_p1"), runs.got("deit_placed")
    for u in ref:
        for k in ref[u]:
            np.testing.assert_array_equal(got[u][k], ref[u][k])


@pytest.mark.parametrize("tag", ["deit_1x2", "deit_2x1", "deit_3axis"])
def test_other_meshes_match_single_device_jax(runs, tag):
    """Model axis alone, data axis alone, and a pod x data x model mesh
    (rows split over pod and data together)."""
    _close(runs.got(tag), runs.refs["deit"]["p1"])


def test_1x1_mesh_equals_the_unsharded_port_bitwise(runs):
    got, plain = runs.got("deit_1x1"), runs.got("deit_1x1_plain")
    for u in plain:
        for k in plain[u]:
            np.testing.assert_array_equal(got[u][k], plain[u][k])


def test_checkpoint_resume_and_foreign_mesh(runs):
    """A 2x2 pass cut after 2 of 3 batches resumes from its gathered
    checkpoint onto the uninterrupted sums; a checkpoint written under 2x1
    has another fingerprint and is ignored under 2x2 (a fresh pass, still
    right)."""
    ref = runs.got("deit_p1")
    for tag in ("deit_resumed", "deit_foreign"):
        got = runs.got(tag)
        for u in ref:
            for k in ref[u]:
                np.testing.assert_allclose(got[u][k], ref[u][k], rtol=1e-6,
                                           atol=1e-6, err_msg=f"{tag} {u}")
    assert runs.ranks("deit_2x1", 2)[0]["fingerprint"] \
        != runs.ranks("deit_p1")[0]["fingerprint"]


def test_fingerprint_equals_jax_for_the_same_mesh(runs):
    """JAX hashes the mesh as ``axis_names`` x ``devices.shape``; its
    engine takes a stand-in with those two fields (it builds no step until
    ``init_stats``), so a 4-device mesh is not needed in this process."""
    cfg = tiny_cfg("deit-base")
    for tag, shape, axes in (("deit_p1", (2, 2), ("data", "model")),
                             ("deit_3axis", (2, 1, 2),
                              ("pod", "data", "model"))):
        mesh = types.SimpleNamespace(axis_names=axes,
                                     devices=np.empty(shape))
        want = JaxEngine(jax_build(cfg), jax_units(cfg), phase=1,
                         mesh=mesh).fingerprint
        got = {r["fingerprint"] for r in runs.ranks(tag)}
        assert got == {want}, tag


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stats_specs_match_jax_on_every_pass1_tree(arch):
    """The placement rule against JAX's ``stats_specs`` on each config's
    pass-1 tree (shapes by ``jax.eval_shape``), for a 2- and a 4-way model
    axis."""
    cfg = reduced(get_config(arch))
    model = jax_build(cfg)
    units = jax_units(cfg)
    batch = batch_for(cfg)
    batch.pop("labels")
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))

    def step(p, b):
        taps = {}
        model.apply(p, b, taps=taps)
        return jax_stats.pass1_reduce(taps, units, cfg)
    tree = jax.eval_shape(step, params, batch)
    for m in (2, 4):
        mesh = {"data": 2, "model": m}
        want = jax_stats_specs(tree, mesh)
        got = stats_specs(tree, mesh)
        for u, st in tree.items():
            for k, leaf in st.items():
                w = tuple(want[u][k])
                expect = None if not w else ("model", leaf.ndim - 1)
                assert w in ((), (None,) * (leaf.ndim - 1) + ("model",))
                assert got[u][k] == expect, (arch, u, k, m)


def test_nondividing_width_stays_replicated_and_warns(caplog):
    """F = 8 on a 3-way model axis: ``_sharded_moments`` returns None with
    JAX's warning (the unit keeps its full F x F), and the rule keeps its
    leaves replicated."""
    shard = types.SimpleNamespace(model_size=3, model_axis="model",
                                  splits=lambda w: splits(w, 3))
    with caplog.at_level(logging.WARNING, logger="repro_torch.stats"):
        assert stats_mod._sharded_moments(torch.ones(1, 5, 8), shard) is None
    assert "stays REPLICATED" in caplog.text
    specs = stats_specs({"u": {"s2": (1, 8, 8), "s1": (1, 8), "n": (1,)}},
                        {"data": 1, "model": 3})
    assert specs == {"u": {"s2": None, "s1": None, "n": None}}


def test_remesh_takes_the_largest_mesh_the_ranks_allow(runs):
    """``remesh()`` on 4 ranks: the squarest two-axis factorisation (2, 2);
    a hint that fits is taken as it is (1 x 2 over ranks 0 and 1), one
    that needs more ranks than live falls back to (2, 2)."""
    assert runs.meta("remesh") == [[[2, 2], ["data", "model"]],
                                   [[1, 2], ["data", "model"]],
                                   [[2, 2], ["data", "model"]]]
