"""The port's LM pruning against the JAX package: qwen2-1.5b-reduced (fp32),
GLU MLP units and rope attention of class 2 (a diagonal complex
compensator per kept rotary pair, qkv bias folded).

Same numpy-made weights and the reference's own Markov calibration tokens
(``torch_parity.lm_prune_setup``) in both packages, on the CPU; the JAX
package takes its plain paths there, as its own tests do. Statistics are
held to rtol 1e-4 (fp32 sums in another order), keep sets must be equal,
and pruned models are compared through their logits on held-out tokens
(relative error): <= 1e-3 against JAX's ``corp_prune`` (the ridge solves
of two libraries), <= 1e-4 between the port's own modes, which reduce the
same taps.
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.configs import ARCH_IDS, get_config, reduced  # noqa: E402
from repro.core import CalibrationEngine as JaxEngine  # noqa: E402
from repro.core import PruneConfig as JaxPC  # noqa: E402
from repro.core import corp_prune as jax_corp_prune  # noqa: E402
from repro.core import corp_prune_streamed as jax_streamed  # noqa: E402
from repro.core import discover_units as jax_units  # noqa: E402
from repro.core import ranking as jax_ranking  # noqa: E402
from repro.core import solve as jax_solve  # noqa: E402
from repro.data import lm_batch as jax_lm_batch  # noqa: E402
from repro.data import calib_stream as jax_calib_stream  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as pt_get_config  # noqa: E402
from repro_torch.configs import resolve_config  # noqa: E402
from repro_torch.core import CalibrationEngine, PruneConfig  # noqa: E402
from repro_torch.core import corp_prune, corp_prune_streamed  # noqa: E402
from repro_torch.core import discover_units, ranking, solve  # noqa: E402
from repro_torch.core import pruner as pruner_mod  # noqa: E402
from repro_torch.core import stats as stats_mod  # noqa: E402
from repro_torch.data import calib_stream, lm_batch  # noqa: E402
from repro_torch.launch import prune as pt_prune  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from torch_parity import (jax_params, lm_logits, lm_prune_setup,  # noqa: E402
                          rel, to_port_cfg)

ATTN, MLP = "seg0/p0/attn", "seg0/p0/mlp"
KEEP_PAIRS = 4            # of 8 rotary pairs per head at sparsity 0.5

_JAX = {}


@pytest.fixture(scope="module")
def s():
    return lm_prune_setup("qwen2-1.5b", seed=21)


def _jax_prune(s, **kw):
    """JAX's ``corp_prune`` (or ``corp_prune_streamed`` with ``group``) of
    the setup, once per keyword set, as (params, config, report, logits)."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX:
        kw = dict(kw)
        pc = JaxPC(0.5, 0.5, compensate=kw.pop("compensate", True))
        group = kw.pop("group", None)
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


def _close(got, want, rtol=1e-4, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, err_msg
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=err_msg)


def _close_tree(got, want, rtol=1e-4):
    g = interop.flatten(interop.to_numpy(got))
    w = interop.flatten(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    for k in w:
        _close(g[k], w[k], rtol, k)


def _check_j(report):
    for unit, d in report["units"].items():
        js, ju = np.asarray(d["j_star"]), np.asarray(d["j_uncomp"])
        assert (js <= ju * (1 + 1e-5) + 1e-6).all(), unit


# ---------------------------------------------------------------------------
# units, data, taps
# ---------------------------------------------------------------------------

_ALL = list(ARCH_IDS) + ["deit-base"]


@pytest.mark.parametrize("cut", ["full", "reduced"])
@pytest.mark.parametrize("arch", _ALL)
def test_discover_units_equals_jax_field_by_field(arch, cut):
    """Every family, layout and unit kind (moe, shared, mamba, mla, cross,
    unrolled and scanned segments, classes 1-3), as JAX discovers them;
    the port's reductions refuse the kinds it cannot reduce yet."""
    jcfg = get_config(arch)
    if cut == "reduced":
        jcfg = reduced(jcfg)
    pcfg = to_port_cfg(jcfg)
    assert pcfg.layout() == jcfg.layout()
    want = [dataclasses.asdict(u) for u in jax_units(jcfg)]
    got = [dataclasses.asdict(u) for u in discover_units(pcfg)]
    assert got == want


def test_the_ported_lms_lay_out_as_one_scanned_segment():
    for arch, n, kinds in (("qwen2-1.5b", 28, ["attn", "mlp"]),
                           ("rwkv6-3b", 32, ["rwkv_mlp"])):
        cfg = pt_get_config(arch)
        assert cfg.layout() == [("scan", n, [0])]
        assert [(u.name, u.reps, u.stacked) for u in discover_units(cfg)] \
            == [(f"seg0/p0/{k}", n, True) for k in kinds]
    units = discover_units(pt_get_config("qwen2-1.5b"))
    assert (units[0].attn_class, units[0].n_groups, units[0].q_per_group) \
        == (2, 2, 6)


@pytest.mark.parametrize("seq,nshards", [(16, 1), (33, 2)])
def test_lm_batch_and_calib_stream_are_token_identical(s, seq, nshards):
    V = s["cfg"].vocab_size
    want = jax_lm_batch(7, batch=4, seq=seq, vocab=V, seed=3, shard=1,
                        nshards=nshards)
    got = lm_batch(7, batch=4, seq=seq, vocab=V, seed=3, shard=1,
                   nshards=nshards, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    jb = list(jax_calib_stream(s["jcfg"], n_samples=12, batch=4, seq=seq)())
    pb = list(calib_stream(s["cfg"], n_samples=12, batch=4, seq=seq,
                           device="cpu")())
    assert len(pb) == len(jb) == 3 and all(list(b) == ["tokens"] for b in pb)
    for a, b in zip(jb, pb):
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      np.asarray(a["tokens"]))


@pytest.mark.parametrize("frontend,family", [("patch_stub", "lm"),
                                             (None, "encdec")])
def test_calib_stream_carries_the_frontend_inputs(s, frontend, family):
    """The VLM stub's stream carries patch embeddings beside the tokens
    (tests/test_torch_internvl.py holds them to JAX's), the enc-dec's the
    encoder frames, one a token (tests/test_torch_seamless_prune.py holds
    them to JAX's)."""
    cfg = s["cfg"].replace(frontend=frontend, family=family)
    b = next(iter(calib_stream(cfg, n_samples=4, batch=2, device="cpu")()))
    extra = "patch_embeds" if family == "lm" else "frames"
    assert sorted(b) == sorted(["tokens", extra])
    assert b[extra].shape == ((2, 8, cfg.d_model) if family == "lm"
                              else (2, 64, cfg.d_model))
    assert b[extra].dtype == torch.float32
    assert b["tokens"].shape == (2, 64)


def test_taps_match_jax_keys_stacking_and_values(s):
    batch = next(iter(s["pt_calib"]()))
    jt, pt = {}, {}
    s["jax_model"].apply(s["jax_params"],
                         {"tokens": jnp.asarray(batch["tokens"].numpy())},
                         taps=jt)
    s["pt_model"].apply(s["pt_params"], batch, taps=pt)
    assert sorted(pt) == sorted(jt) == ["seg0/p0/h", "seg0/p0/k",
                                        "seg0/p0/q"]
    L = s["cfg"].n_layers
    assert pt["seg0/p0/q"].shape == (L, 8, 32, 4, 16)
    assert pt["seg0/p0/k"].shape == (L, 8, 32, 1, 16)
    for k in jt:
        _close(pt[k].numpy(), np.asarray(jt[k]), err_msg=k)


def test_taps_honour_the_streaming_dtype(s):
    from repro_torch.models.common import tap_dtype
    taps = {}
    with tap_dtype("bfloat16"):
        s["pt_model"].apply(s["pt_params"], s["pt_held"], taps=taps)
    assert {t.dtype for t in taps.values()} == {torch.bfloat16}


# ---------------------------------------------------------------------------
# pass 1, ranking, pass 2 (class 2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pass1(s):
    want = JaxEngine(s["jax_model"], jax_units(s["jcfg"]), phase=1) \
        .run(s["jax_params"], s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], discover_units(s["cfg"]),
                            phase=1).run(s["pt_params"], s["pt_calib"]())
    return want, got


def test_pass1_sums_match_jax(pass1):
    want, got = pass1
    assert got[ATTN]["rank"].shape == (2, 1, 8)    # (L, G, pairs)
    _close_tree(got, want)


def test_keep_sets_identical_to_jax(s, pass1):
    want, got = pass1
    pc = PruneConfig(0.5, 0.5)
    plan = pruner_mod._rank(discover_units(s["cfg"]), got, s["pt_params"],
                            pc)
    w2 = np.asarray(s["np"]["seg0"]["p0"]["mlp"]["wd"])
    ref = {MLP: jax_ranking.rank_mlp(want[MLP], w2, 128),
           ATTN: jax_ranking.rank_attn(want[ATTN], KEEP_PAIRS)}
    assert sorted(plan) == sorted(ref)
    for name, (k, p) in ref.items():
        np.testing.assert_array_equal(plan[name][0], k, err_msg=name)
        np.testing.assert_array_equal(plan[name][1], p, err_msg=name)
    assert plan[ATTN][0].shape == (2, 1, KEEP_PAIRS)


def test_class2_pass2_statistics_match_jax(s, pass1):
    keep, prune = jax_ranking.rank_attn(pass1[0][ATTN], KEEP_PAIRS)
    plan = {ATTN: (keep, prune)}
    want = JaxEngine(s["jax_model"], jax_units(s["jcfg"]), phase=2,
                     plan=plan).run(s["jax_params"], s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], discover_units(s["cfg"]),
                            phase=2, plan=plan) \
        .run(s["pt_params"], s["pt_calib"]())
    assert got[ATTN]["G"].shape == (2, 1, KEEP_PAIRS, KEEP_PAIRS)
    assert got[ATTN]["G"].dtype == torch.complex64
    assert got[ATTN]["h"].shape == (2, 1, KEEP_PAIRS)
    _close_tree(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_complex_solve_fold_and_pair_dims_match_jax(seed):
    """Seeded Hermitian PSD systems batched over (layer, group) rows, as
    the fold solves them; the 2x2 blocks are checked against JAX's and
    against their meaning: a conj(b) = 1 + m, so per pair Fq Fk^T is the
    real 2x2 of 1 + m acting on (even, odd) row vectors."""
    rng = np.random.default_rng(seed)
    R, dp = 6, 5
    z = (rng.standard_normal((R, 40, dp))
         + 1j * rng.standard_normal((R, 40, dp))).astype(np.complex64)
    Gd = np.einsum("rts,rtu->rsu", z.conj(), z).astype(np.complex64)
    hd = (rng.standard_normal((R, dp))
          + 1j * rng.standard_normal((R, dp))).astype(np.complex64)
    t2 = (np.abs(hd) ** 2).sum(-1).astype(np.float32) * 3.0
    lam = (1e-4 * np.real(np.einsum("rii->ri", Gd)).mean(-1)) \
        .astype(np.float32)
    want = jax.vmap(jax_solve.solve_diag_complex)(
        jnp.asarray(Gd), jnp.asarray(hd), jnp.asarray(t2), jnp.asarray(lam))
    got = solve.solve_diag_complex(*(torch.from_numpy(a)
                                     for a in (Gd, hd, t2, lam)))
    for k in ("m", "j_star", "j_uncomp", "rho2"):
        _close(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    m = got["m"]
    fq, fk = solve.fold_diag_complex(m)
    jq, jk = jax.vmap(jax_solve.fold_diag_complex)(jnp.asarray(m.numpy()))
    _close(fq.numpy(), np.asarray(jq))
    _close(fk.numpy(), np.asarray(jk))
    w = (1 + m).numpy()
    block = np.stack([np.stack([w.real, w.imag], -1),
                      np.stack([-w.imag, w.real], -1)], -2)
    np.testing.assert_allclose((fq @ fk.mT).numpy(), block, rtol=1e-5,
                               atol=1e-5)
    pairs = rng.integers(0, 64, (3, 2, 7))
    np.testing.assert_array_equal(
        solve.pairs_to_dims(torch.from_numpy(pairs)).numpy(),
        np.asarray(jax_solve.pairs_to_dims(jnp.asarray(pairs))))


def test_class3_and_unported_units_raise_by_name(s):
    """Class 3 (qk-norm) units reduce (tests/test_torch_gemma_prune.py
    holds them to JAX), and so do class-1 MLA units
    (tests/test_torch_deepseek_prune.py), Mamba units, on their
    ``mamba_y`` tap (tests/test_torch_jamba_prune.py), and cross units,
    on their ``cross_q``/``cross_k`` taps as a class-1 attention unit on
    ``q``/``k`` (tests/test_torch_seamless_prune.py): no unit kind is left
    to refuse."""
    cfg = s["cfg"].replace(qk_norm=True)
    units = discover_units(cfg)
    assert units[0].attn_class == 3
    taps = {}
    s["pt_model"].apply(s["pt_params"], s["pt_held"], taps=taps)
    p1 = stats_mod.pass1_reduce(taps, units)
    assert p1[ATTN]["rank"].shape == (2, 1, 8)      # (L, G, pairs)
    cross = dataclasses.replace(units[0], kind="cross", name="x/cross",
                                attn_class=1)
    attn1 = dataclasses.replace(units[0], name="x/attn", attn_class=1)
    taps["seg0/p0/cross_q"] = taps["seg0/p0/q"]
    taps["seg0/p0/cross_k"] = taps["seg0/p0/k"]
    got = stats_mod.pass1_reduce(taps, [cross])["x/cross"]
    want = stats_mod.pass1_reduce(taps, [attn1])["x/attn"]
    assert got["rank"].shape == (2, 1, 16)          # (L, G, dims)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    mamba = dataclasses.replace(units[0], kind="mamba", name="x/mamba")
    taps["seg0/p0/mamba_y"] = taps["seg0/p0/h"]
    got = stats_mod.pass1_reduce(taps, [mamba])["x/mamba"]
    want = stats_mod.pass1_reduce(taps, [units[1]])[units[1].name]
    assert sorted(got) == ["n", "na", "s1", "s2"]
    for k in got:
        assert torch.equal(got[k], want[k]), k
    mla = dataclasses.replace(units[0], kind="mla", name="x/mla",
                              attn_class=1)
    spec = stats_mod.spec_pass2_reduce(taps, [mla], {
        "x/mla": torch.zeros((2, 1, 4), dtype=torch.int64)})
    assert spec["x/mla"]["Gc"].shape == (2, 1, 4, 4, 4, 4)


# ---------------------------------------------------------------------------
# corp_prune, two-pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compensate", [True, False])
def test_pruned_logits_match_jax(s, compensate):
    jp, jcfg, jrep, want = _jax_prune(s, compensate=compensate)
    pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                               PruneConfig(0.5, 0.5, compensate=compensate))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert (pcfg.eff_d_ff, pcfg.eff_qk) == (128, 8)
    assert rep["traversals"] == jrep["traversals"] == 2
    got = _port_logits(s, pp, pcfg)
    assert np.isfinite(got).all()
    assert rel(got, want) <= 1e-3
    _check_j(rep)
    for unit in rep["units"]:
        for k in ("j_star", "j_uncomp"):
            _close(np.asarray(rep["units"][unit][k], np.float32),
                   np.asarray(jrep["units"][unit][k], np.float32),
                   rtol=1e-3, err_msg=f"{unit}/{k}")
    mixer = pp["seg0"]["p0"]["mixer"]
    assert tuple(mixer["wq"].shape) == (2, 64, 4, 8)
    assert tuple(mixer["bk"].shape) == (2, 1, 8)
    assert tuple(mixer["rope_inv_q"].shape) == (2, 4, 4)
    assert tuple(mixer["rope_inv_k"].shape) == (2, 1, 4)
    # the kept pairs' frequencies, gathered by the same pair indices
    np.testing.assert_array_equal(mixer["rope_inv_k"].numpy(),
                                  np.asarray(jp["seg0"]["p0"]["mixer"]
                                             ["rope_inv_k"]))
    assert ("bd" in pp["seg0"]["p0"]["mlp"]) == compensate


def test_compensation_beats_plain_pruning(s):
    dense = _port_logits(s, s["pt_params"], s["cfg"])
    errs = {}
    for comp in (True, False):
        pp, pcfg, _ = corp_prune(s["pt_model"], s["pt_params"],
                                 s["pt_calib"],
                                 PruneConfig(0.5, 0.5, compensate=comp))
        errs[comp] = rel(_port_logits(s, pp, pcfg), dense)
    assert errs[True] < errs[False], errs


def test_bf16_stream_matches_jax(s):
    """bf16 taps in both packages: the same rounding of fp32 taps that
    differ in their last bits; held to 2e-3 as DeiT's bf16 stream
    (tests/test_torch_calibration.py)."""
    _, _, _, want = _jax_prune(s, stats_dtype="bfloat16")
    pp, pcfg, _ = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                             PruneConfig(0.5, 0.5), stats_dtype="bfloat16")
    assert rel(_port_logits(s, pp, pcfg), want) <= 2e-3


# ---------------------------------------------------------------------------
# one traversal (class 2: candidates and sums over rotary pairs)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_pass(s, pass1):
    pp, pcfg, _ = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                             PruneConfig(0.5, 0.5))
    p1 = {u: {k: v.numpy() for k, v in d.items()}
          for u, d in pass1[1].items()}
    return {"logits": _port_logits(s, pp, pcfg), "p1": p1}


def _spec_plan(two_pass, margin):
    return {ATTN: ranking.candidate_attn(two_pass["p1"][ATTN], KEEP_PAIRS,
                                         margin)}


def test_speculative_sums_match_jax(s, two_pass):
    spec_plan = _spec_plan(two_pass, 0.25)
    assert spec_plan[ATTN].shape == (2, 1, 5)      # ceil(4 * 1.25) pairs
    want = JaxEngine(s["jax_model"], jax_units(s["jcfg"]), phase="1+2",
                     spec_plan=spec_plan).run(s["jax_params"],
                                              s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], discover_units(s["cfg"]),
                            phase="1+2", spec_plan=spec_plan) \
        .run(s["pt_params"], s["pt_calib"]())
    sp = got["p2spec"][ATTN]
    assert sorted(sp) == ["Gc", "hfull", "t2_tot"]
    assert sp["Gc"].shape == (2, 1, 5, 5) and sp["Gc"].dtype == \
        torch.complex64
    _close_tree(got, want)


def test_spec_reconstruct_equals_the_ports_pass2(s, two_pass):
    spec_plan = _spec_plan(two_pass, 0.25)
    keep, prune = ranking.rank_attn(two_pass["p1"][ATTN], KEEP_PAIRS)
    assert ranking.covers(spec_plan[ATTN], keep)
    units = discover_units(s["cfg"])
    unit = units[0]
    spec = CalibrationEngine(s["pt_model"], units, phase="1+2",
                             spec_plan=spec_plan) \
        .run(s["pt_params"], s["pt_calib"]())["p2spec"][ATTN]
    rec = stats_mod.spec_reconstruct(
        {k: v.numpy() for k, v in spec.items()}, spec_plan[ATTN], keep,
        unit)
    want = CalibrationEngine(s["pt_model"], units, phase=2,
                             plan={ATTN: (keep, prune)}) \
        .run(s["pt_params"], s["pt_calib"]())[ATTN]
    for k, w in want.items():
        _close(rec[k], w.numpy(), err_msg=k)


@pytest.mark.parametrize("compensate", [True, False])
def test_one_traversal_hit_matches_jax_and_two_pass(s, two_pass,
                                                    compensate):
    calls = [0]

    def counted():
        calls[0] += 1
        return s["pt_calib"]()
    pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"], counted,
                               PruneConfig(0.5, 0.5, compensate=compensate),
                               one_traversal=True, spec_margin=1.0)
    assert rep["traversals"] == calls[0] == 1
    sp = rep["speculative"]
    assert (sp["hits"], sp["misses"], sp["candidates"]) == \
        ([ATTN], [], {ATTN: 8})
    _, _, jrep, want = _jax_prune(s, compensate=compensate,
                                  one_traversal=True, spec_margin=1.0)
    assert jrep["traversals"] == 1
    got = _port_logits(s, pp, pcfg)
    assert rel(got, want) <= 1e-3
    if compensate:
        assert rel(got, two_pass["logits"]) <= 1e-4
    _check_j(rep)


def test_one_traversal_miss_falls_back_to_a_targeted_pass2(
        s, two_pass, monkeypatch):
    """Bottom-k candidate pairs with no margin: the unit escapes, one
    targeted pass 2 runs, and the result is the two-pass one."""
    orig = ranking.candidate_attn

    def adversarial(stats, keep_n, margin):
        return orig({"rank": -np.asarray(stats["rank"], np.float64)},
                    keep_n, 0.0)
    monkeypatch.setattr(ranking, "candidate_attn", adversarial)
    pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                               PruneConfig(0.5, 0.5), one_traversal=True)
    assert rep["traversals"] == 2 and rep["speculative"]["misses"] == [ATTN]
    assert rel(_port_logits(s, pp, pcfg), two_pass["logits"]) <= 1e-6


# ---------------------------------------------------------------------------
# streamed CORP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compensate,one_traversal,traversals",
                         [(True, False, 3), (False, False, 3),
                          (True, True, 2)])
def test_streamed_matches_jax(s, compensate, one_traversal, traversals):
    """One unit a group: attention (two traversals, one on a hit) then
    the MLP (one)."""
    kw = dict(compensate=compensate, one_traversal=one_traversal,
              spec_margin=1.0)
    _, _, jrep, want = _jax_prune(s, group=1, **kw)
    pp, pcfg, rep = corp_prune_streamed(
        s["pt_model"], s["pt_params"], s["pt_calib"],
        PruneConfig(0.5, 0.5, compensate=compensate), unit_group_size=1,
        one_traversal=one_traversal, spec_margin=1.0)
    assert rep["groups"] == jrep["groups"] == 2
    assert rep["traversals"] == jrep["traversals"] == traversals
    assert rel(_port_logits(s, pp, pcfg), want) <= 1e-4


# ---------------------------------------------------------------------------
# the prune CLI, its checkpoint in JAX, and the port's serve CLI
# ---------------------------------------------------------------------------

def test_cli_checkpoint_loads_in_jax_and_serves_in_the_port(s, tmp_path):
    """``--calib-seq 16 --out``: the checkpoint restores with JAX's
    ``restore_checkpoint`` into JAX's pruned config. JAX's own pruned
    template has no ``mlp/bd`` and drops the compensation bias; given the
    port's template (which has it), JAX's logits equal the port's. The
    port's serve CLI serves the checkpoint with the bias."""
    out = str(tmp_path / "pruned")
    res = pt_prune.main(["--arch", "qwen2-1.5b-reduced", "--calib", "16",
                         "--calib-batch", "8", "--calib-seq", "16",
                         "--device", "cpu", "--out", out])
    pcfg = res["pruned_cfg"]
    assert (pcfg.eff_d_ff, pcfg.eff_qk) == (128, 8)
    want = _port_logits(s, res["pruned_params"], pcfg)
    jcfg = s["jcfg"].pruned(0.5, 0.5)
    jtmpl = jax_build(jcfg).init(jax.random.PRNGKey(0))
    dropped, _ = jax_restore(out, 0, jtmpl)
    assert "bd" not in dropped["seg0"]["p0"]["mlp"]
    jtmpl["seg0"]["p0"]["mlp"]["bd"] = jnp.zeros((2, 64), jnp.float32)
    jparams, extra = jax_restore(out, 0, jtmpl)
    assert extra["config"] == pcfg.name
    got = lm_logits(jax_build(jcfg), jparams, s["jax_held"])
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    assert rel(lm_logits(jax_build(jcfg), dropped, s["jax_held"]),
               want) > 1e-3
    served = pt_serve.main(["--arch", "qwen2-1.5b-reduced", "--sparsity",
                            "0.5", "--ckpt-in", out, "--device", "cpu",
                            "--trace", "3", "--slots", "2", "--max-len",
                            "40", "--prompt-range", "6,16", "--gen-range",
                            "2,6"])
    assert len(served["completions"]) == 3
    assert torch.equal(served["params"]["seg0"]["p0"]["mlp"]["bd"],
                       res["pruned_params"]["seg0"]["p0"]["mlp"]["bd"])
    np.testing.assert_array_equal(
        _port_logits(s, served["params"], served["model"].cfg), want)


def test_cli_on_an_lm_asks_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the CLI would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        pt_prune.main(["--arch", "qwen2-1.5b-reduced", "--calib-seq", "8"])


def test_two_kv_groups_fold_matches_jax():
    """Qwen2-1.5B solves per (layer, kv group) over 2 groups of 6 query
    heads; the reduced config has one group, so this runs it with 2 groups
    of 2 heads: the grouped pair statistics, the per-group blocks and the
    per-group gathers of the qkv bias and the rope tables."""
    jcfg = reduced(get_config("qwen2-1.5b")).replace(n_kv_heads=2)
    pcfg = resolve_config("qwen2-1.5b-reduced").replace(n_kv_heads=2)
    params = jax_params(jcfg, seed=4)
    kw = dict(n_samples=16, batch=8, seq=32)
    jp, jc, _ = jax_corp_prune(jax_build(jcfg),
                               jax.tree.map(jnp.asarray, params),
                               jax_calib_stream(jcfg, **kw), JaxPC(0.5, 0.5))
    pp, pc, rep = corp_prune(pt_build(pcfg),
                             interop.from_numpy(params, device="cpu"),
                             calib_stream(pcfg, device="cpu", **kw),
                             PruneConfig(0.5, 0.5))
    assert rep["units"][ATTN]["j_star"].shape == (2, 2)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 20)) \
        .astype(np.int32)
    want = lm_logits(jax_build(jc), jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = lm_logits(pt_build(pc), pp, {"tokens": torch.from_numpy(toks)})
    assert rel(got, want) <= 1e-3
    np.testing.assert_array_equal(
        pp["seg0"]["p0"]["mixer"]["rope_inv_q"].numpy(),
        np.asarray(jp["seg0"]["p0"]["mixer"]["rope_inv_q"]))


def test_bf16_checkpoint_round_trips_in_both_packages(tmp_path):
    """A full-width LM's params are bf16: the port writes them as raw bits
    with the dtype in the manifest, as the JAX package does, so JAX's
    restore and the port's give the same values back."""
    from repro.checkpoint import save_checkpoint as jax_save
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    cfg = resolve_config("qwen2-1.5b-reduced").replace(dtype="bfloat16")
    params = pt_build(cfg).init(torch.Generator().manual_seed(1), "cpu")
    assert params["embed"].dtype == torch.bfloat16
    save_checkpoint(str(tmp_path / "pt"), 0, params)
    jcfg = reduced(get_config("qwen2-1.5b")).replace(dtype="bfloat16")
    jtmpl = jax_build(jcfg).init(jax.random.PRNGKey(0))
    got, _ = jax_restore(str(tmp_path / "pt"), 0, jtmpl)
    flat = interop.flatten(params)
    for k, v in interop.flatten(jax.tree.map(np.asarray, got)).items():
        np.testing.assert_array_equal(v.astype(np.float32),
                                      flat[k].float().numpy(), err_msg=k)
    back, _ = restore_checkpoint(str(tmp_path / "pt"), 0, params)
    assert all(torch.equal(a, interop.flatten(back)[k])
               for k, a in flat.items())
    jax_save(str(tmp_path / "jax"), 0, got)
    again, _ = restore_checkpoint(str(tmp_path / "jax"), 0, params)
    assert all(torch.equal(a, interop.flatten(again)[k])
               for k, a in flat.items())
