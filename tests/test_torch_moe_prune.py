"""The port's CORP on a routed MoE (qwen3-moe-235b-a22b) against the JAX
package: per-expert hidden-channel pruning (one ridge solve per (layer,
expert), compensated through ``wd`` and ``bd_moe``), whole-expert removal
(``expert_sparsity``: ``moe_resid`` and ``moe_out_b``), class-3 attention,
one traversal, streamed CORP, checkpoints in both directions and serving
the pruned model.

qwen3-moe-235b-a22b-reduced in fp32 on the CPU, the same numpy-made
weights and the reference's Markov calibration tokens in both packages
(``torch_parity.lm_prune_setup``). Keep sets must be equal; pruned models
are compared through their logits on held-out tokens (relative error):
<= 1e-3 against JAX (the ridge solves of two libraries), <= 1e-4 between
the port's own modes. The expert-removal cases also run on
``tests/test_corp_moe_experts.py``'s setup (``helpers.tiny_cfg``: capacity
factor 8, no drops; JAX's seed-0 weights and ``calib_factory`` batches).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.core import CalibrationEngine as JaxEngine  # noqa: E402
from repro.core import PruneConfig as JaxPC  # noqa: E402
from repro.core import corp_prune as jax_corp_prune  # noqa: E402
from repro.core import corp_prune_streamed as jax_streamed  # noqa: E402
from repro.core import discover_units as jax_units  # noqa: E402
from repro.core import ranking as jax_ranking  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro.serve import synthetic_trace as jax_trace  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import CalibrationEngine, PruneConfig  # noqa: E402
from repro_torch.core import corp_prune, corp_prune_streamed  # noqa: E402
from repro_torch.core import discover_units, ranking  # noqa: E402
from repro_torch.core import calibrate as calib_mod  # noqa: E402
from repro_torch.launch import prune as pt_prune  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from helpers import batch_for, calib_factory, tiny_cfg  # noqa: E402
from torch_parity import (lm_logits, lm_prune_setup, mlp_rank_args,  # noqa: E402
                          rel, to_port_cfg)

ARCH = "qwen3-moe-235b-a22b"
ATTN, MOE = "seg0/p0/attn", "seg0/p0/moe"
SERVE = ["--trace", "4", "--slots", "2", "--max-len", "40",
         "--prompt-range", "6,16", "--gen-range", "3,8", "--device", "cpu"]
_JAX = {}


@pytest.fixture(scope="module")
def s():
    return lm_prune_setup(ARCH, seed=8)


def _jax_prune(s, group=None, **kw):
    """JAX's ``corp_prune`` (``corp_prune_streamed`` with ``group``) of the
    setup at 0.5/0.5, once per keyword set: (params, config, report,
    held-out logits)."""
    key = (group,) + tuple(sorted(kw.items()))
    if key not in _JAX:
        kw = dict(kw)
        pc = JaxPC(kw.pop("mlp", 0.5), kw.pop("attn", 0.5),
                   expert_sparsity=kw.pop("experts", 0.0),
                   compensate=kw.pop("compensate", True))
        if group is None:
            out = jax_corp_prune(s["jax_model"], s["jax_params"],
                                 s["jax_calib"], pc, **kw)
        else:
            out = jax_streamed(s["jax_model"], s["jax_params"],
                               s["jax_calib"], pc, unit_group_size=group,
                               **kw)
        _JAX[key] = out + (lm_logits(jax_build(out[1]), out[0],
                                     s["jax_held"]),)
    return _JAX[key]


def _port_logits(s, params, cfg):
    with torch.no_grad():
        return lm_logits(pt_build(cfg), params, s["pt_held"])


def _check_j(report):
    for unit, d in report["units"].items():
        js, ju = np.asarray(d["j_star"]), np.asarray(d["j_uncomp"])
        assert (js <= ju * (1 + 1e-5) + 1e-6).all(), unit


# ---------------------------------------------------------------------------
# ranking
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pass1(s):
    want = JaxEngine(s["jax_model"], jax_units(s["jcfg"]), phase=1) \
        .run(s["jax_params"], s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], discover_units(s["cfg"]),
                            phase=1).run(s["pt_params"], s["pt_calib"]())
    return jax.tree.map(np.asarray, want), interop.to_numpy(got)


def test_units_are_the_jax_units(s):
    want = [u.name for u in jax_units(s["jcfg"])]
    assert [u.name for u in discover_units(s["cfg"])] == want == [ATTN, MOE]
    assert [u.attn_class for u in discover_units(s["cfg"])][0] == 3


def test_keep_sets_identical_to_jax(s, pass1):
    """Each expert's channels ranked on its own moments and its ``wd``
    column norms (keep (L, E, 64)); attention pairs per kv group."""
    want, got = pass1
    wd = s["np"]["seg0"]["p0"]["mlp"]["wd"]
    jk, jpr = jax_ranking.rank_mlp(want[MOE], wd, 64)
    pk, ppr = ranking.rank_mlp(*mlp_rank_args(got[MOE], wd), 64)
    assert pk.shape == (2, 4, 64)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(ppr, jpr)
    np.testing.assert_array_equal(
        ranking.rank_attn(got[ATTN], 4)[0],
        jax_ranking.rank_attn(want[ATTN], 4)[0])


# ---------------------------------------------------------------------------
# corp_prune: hidden channels of every expert, class-3 attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compensate,one_traversal",
                         [(True, False), (False, False), (True, True),
                          (False, True)])
def test_pruned_logits_match_jax(s, compensate, one_traversal):
    kw = dict(compensate=compensate, one_traversal=one_traversal,
              spec_margin=1.0)
    jp, jcfg, jrep, want = _jax_prune(s, **kw)
    pp, pcfg, rep = corp_prune(
        s["pt_model"], s["pt_params"], s["pt_calib"],
        PruneConfig(0.5, 0.5, compensate=compensate),
        one_traversal=one_traversal, spec_margin=1.0)
    assert pcfg == to_port_cfg(jcfg) and pcfg.eff_d_expert == 64
    assert rep["traversals"] == jrep["traversals"] \
        == (1 if one_traversal else 2)
    assert rep["plan_sizes"] == {k: tuple(v)
                                 for k, v in jrep["plan_sizes"].items()}
    mlp = pp["seg0"]["p0"]["mlp"]
    assert tuple(mlp["wd"].shape) == (2, 4, 64, 64)
    assert ("bd_moe" in mlp) == compensate
    if compensate:
        _check_j(rep)
    assert rel(_port_logits(s, pp, pcfg), want) <= 1e-3
    for k in ("wg", "wu"):
        np.testing.assert_array_equal(
            mlp[k].numpy(), np.asarray(jp["seg0"]["p0"]["mlp"][k]))


def test_compensation_brings_the_mlp_closer_to_dense(s):
    """MLP only (attention kept): the per-expert ridge fold is closer to
    the dense model on held-out tokens than plain channel removal."""
    dense = _port_logits(s, s["pt_params"], s["cfg"])
    errs = {}
    for comp in (True, False):
        pp, pcfg, _ = corp_prune(s["pt_model"], s["pt_params"],
                                 s["pt_calib"],
                                 PruneConfig(0.5, 0.0, compensate=comp))
        errs[comp] = rel(_port_logits(s, pp, pcfg), dense)
    assert errs[True] < errs[False], errs


def test_expert_moments_are_reduced_only_for_expert_pruning(s,
                                                            monkeypatch):
    """At expert_sparsity 0 the port's pass 1 holds no ys2 (the reference
    reduces it anyway); forcing it on changes no pruned weight."""
    seen = []
    real = calib_mod.CalibrationEngine.run

    def spy(self, *a, **kw):
        out = real(self, *a, **kw)
        if self.phase == 1:
            seen.append(sorted(out[MOE]))
        return out
    monkeypatch.setattr(calib_mod.CalibrationEngine, "run", spy)
    pc = PruneConfig(0.5, 0.5)
    off = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"], pc)[0]
    assert seen[-1] == ["n", "na", "s1", "s2"]
    init = calib_mod.CalibrationEngine.__init__

    def forced(self, *a, **kw):
        init(self, *a, **dict(kw, expert_moments=True))
    monkeypatch.setattr(calib_mod.CalibrationEngine, "__init__", forced)
    on = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"], pc)[0]
    assert "ys2" in seen[-1]
    a, b = interop.flatten(off), interop.flatten(on)
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# whole-expert removal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compensate", [True, False])
def test_expert_sparsity_matches_jax(s, compensate):
    jp, jcfg, jrep, want = _jax_prune(s, mlp=0.5, attn=0.5, experts=0.5,
                                      compensate=compensate)
    pp, pcfg, rep = corp_prune(
        s["pt_model"], s["pt_params"], s["pt_calib"],
        PruneConfig(0.5, 0.5, expert_sparsity=0.5, compensate=compensate))
    assert pcfg == to_port_cfg(jcfg) and pcfg.eff_num_experts == 2
    assert rep["plan_sizes"][MOE + "/experts"] == (2, 2)
    mlp, jmlp = pp["seg0"]["p0"]["mlp"], jp["seg0"]["p0"]["mlp"]
    np.testing.assert_array_equal(mlp["router"].numpy(),
                                  np.asarray(jmlp["router"]))   # same kept
    assert sorted(mlp) == sorted(jmlp)
    if compensate:
        assert tuple(mlp["moe_resid"].shape) == (2, 64, 64)
        _check_j(rep)
    assert rel(_port_logits(s, pp, pcfg), want) <= 1e-3


def _experts_setup():
    """``tests/test_corp_moe_experts.py``'s model: tiny_cfg (capacity 8),
    JAX's seed-0 weights, its calibration batches and held-out batch."""
    cfg = tiny_cfg(ARCH)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    jb = list(calib_factory(cfg)())
    held = batch_for(cfg, B=2, T=24, seed=77)
    pcfg = to_port_cfg(cfg)
    return {"cfg": cfg, "model": model, "params": params,
            "calib": calib_factory(cfg),
            "pt_model": pt_build(pcfg),
            "pt_params": interop.from_numpy(jax.tree.map(np.asarray, params),
                                            device="cpu"),
            "pt_calib": lambda: iter(
                [{"tokens": torch.from_numpy(np.asarray(b["tokens"]))}
                 for b in jb]),
            "held": {"tokens": held["tokens"]},
            "pt_held": {"tokens": torch.from_numpy(
                np.asarray(held["tokens"]))}}


@pytest.mark.parametrize("mlp,compensate", [(0.0, True), (0.0, False),
                                            (0.5, True)])
def test_expert_removal_on_the_reference_tests_setup(mlp, compensate):
    """``test_expert_prune_end_to_end`` and
    ``test_combined_channel_and_expert_prune_runs``: the port keeps the
    experts JAX keeps and its pruned model's outputs equal JAX's."""
    e = _experts_setup()
    pc = dict(expert_sparsity=0.5, compensate=compensate)
    jp, jcfg, _ = jax_corp_prune(e["model"], e["params"], e["calib"],
                                 JaxPC(mlp, mlp, **pc))
    pp, pcfg, rep = corp_prune(e["pt_model"], e["pt_params"], e["pt_calib"],
                               PruneConfig(mlp, mlp, **pc))
    assert pcfg == to_port_cfg(jcfg)
    np.testing.assert_array_equal(
        pp["seg0"]["p0"]["mlp"]["router"].numpy(),
        np.asarray(jp["seg0"]["p0"]["mlp"]["router"]))
    want = lm_logits(jax_build(jcfg), jp, e["held"])
    with torch.no_grad():
        got = lm_logits(pt_build(pcfg), pp, e["pt_held"])
    assert np.isfinite(got).all()
    assert rel(got, want) <= 1e-3
    for d in rep["units"].values():
        assert (np.asarray(d["j_star"]) <= np.asarray(d["j_uncomp"])
                * (1 + 1e-3) + 1e-6).all()


def test_streamed_matches_jax_and_the_one_shot_prune(s):
    """One unit a group, channels and experts: JAX's streamed prune, and
    the port's own corp_prune (statistics are linear in the units)."""
    _, _, jrep, want = _jax_prune(s, group=1, experts=0.5)
    pc = PruneConfig(0.5, 0.5, expert_sparsity=0.5)
    pp, pcfg, rep = corp_prune_streamed(s["pt_model"], s["pt_params"],
                                        s["pt_calib"], pc, unit_group_size=1)
    assert rep["groups"] == jrep["groups"] == 2
    assert rep["traversals"] == jrep["traversals"] == 3
    got = _port_logits(s, pp, pcfg)
    assert rel(got, want) <= 1e-3
    one = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"], pc)
    assert rel(got, _port_logits(s, one[0], one[1])) <= 1e-4


# ---------------------------------------------------------------------------
# checkpoints and the CLIs
# ---------------------------------------------------------------------------

_CLI = ["--arch", ARCH + "-reduced", "--calib", "16", "--calib-batch", "8",
        "--calib-seq", "16", "--device", "cpu"]


def test_cli_checkpoint_drops_the_moe_leaves_in_jax_not_in_the_port(
        s, tmp_path):
    """A reference fault: ``--sparsity 0.5 --expert-sparsity 0.5`` writes
    ``bd_moe``, ``moe_resid`` and ``moe_out_b``; JAX's pruned template
    (``repro.models.mlp.init_moe``) has none of them, so its restore drops
    them and its model computes other logits. Given a template that holds
    them, JAX's model computes the port's; the port's serve CLI restores
    them. (Both JAX templates take the per-head qk-norm scales of the
    class-3 fold, which JAX's own template cannot restore: ROADMAP Queue 3
    item 3.)"""
    out = str(tmp_path)
    res = pt_prune.main(_CLI + ["--sparsity", "0.5", "--expert-sparsity",
                                "0.5", "--out", out])
    pcfg = res["pruned_cfg"]
    assert (pcfg.eff_d_expert, pcfg.eff_num_experts) == (64, 2)
    want = _port_logits(s, res["pruned_params"], pcfg)
    jcfg = s["jcfg"].pruned(0.5, 0.5, expert_sparsity=0.5)
    jtmpl = jax_build(jcfg).init(jax.random.PRNGKey(0))
    mixer = jtmpl["seg0"]["p0"]["mixer"]
    H, Hkv, n = jcfg.n_heads, jcfg.n_kv_heads, jcfg.eff_qk
    mixer["q_scale"] = jnp.ones((2, H, n), jnp.float32)
    mixer["k_scale"] = jnp.ones((2, Hkv, n), jnp.float32)
    dropped, _ = jax_restore(out, 0, jtmpl)
    leaves = ("bd_moe", "moe_resid", "moe_out_b")
    assert not set(leaves) & set(dropped["seg0"]["p0"]["mlp"])
    assert rel(lm_logits(jax_build(jcfg), dropped, s["jax_held"]),
               want) > 1e-3
    pm = res["pruned_params"]["seg0"]["p0"]["mlp"]
    for k in leaves:
        jtmpl["seg0"]["p0"]["mlp"][k] = jnp.zeros(tuple(pm[k].shape))
    full, _ = jax_restore(out, 0, jtmpl)
    got = lm_logits(jax_build(jcfg), full, s["jax_held"])
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    served = pt_serve.main(["--arch", ARCH + "-reduced", "--sparsity", "0.5",
                            "--expert-sparsity", "0.5", "--ckpt-in", out]
                           + SERVE)
    for k in leaves:
        assert torch.equal(served["params"]["seg0"]["p0"]["mlp"][k], pm[k])


@pytest.mark.parametrize("case", ["dense", "pruned", "experts"])
def test_serve_cli_streams_equal_the_jax_engine(s, tmp_path, case):
    """``launch.serve --ckpt-in`` of a JAX-written checkpoint: the dense
    weights, JAX's ``corp_prune`` at 0.5/0.5 (``--sparsity 0.5``, with
    ``bd_moe``) and with experts removed (``--expert-sparsity 0.5``, with
    ``moe_resid`` and ``moe_out_b``). The streams equal the JAX engine's on
    the same params (which JAX's own serve CLI would restore without the
    MoE compensation leaves)."""
    flags, kw = [], {}
    if case == "dense":
        jp, jcfg = s["jax_params"], s["jcfg"]
    else:
        kw = {"experts": 0.5} if case == "experts" else {}
        jp, jcfg = _jax_prune(s, **kw)[:2]
        flags = ["--sparsity", "0.5"] + (
            ["--expert-sparsity", "0.5"] if kw else [])
    jax_save(str(tmp_path), 0, jax.tree.map(np.asarray, jp),
             extra={"config": jcfg.name})
    served = pt_serve.main(["--arch", ARCH + "-reduced", "--ckpt-in",
                            str(tmp_path)] + flags + SERVE)
    mlp = served["params"]["seg0"]["p0"]["mlp"]
    assert ("bd_moe" in mlp) == (case != "dense")
    assert ("moe_resid" in mlp) == (case == "experts")
    jeng = JaxServe(jax_build(jcfg), jax.tree.map(jnp.asarray, jp),
                    n_slots=2, max_len=40)
    want = jeng.run(jax_trace(4, jcfg.vocab_size, seed=0,
                              prompt_range=(6, 16), gen_range=(3, 8)))
    assert [c.tokens.tolist() for c in served["completions"]] == \
        [c.tokens.tolist() for c in want]
