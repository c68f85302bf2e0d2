"""The port's other prune modes against the JAX reference, on a reduced
DeiT-Base: bf16 tap streaming, one-traversal calibration, resumable
statistics checkpoints, streamed CORP and the prune CLI's flags.

Same weights and images as tests/test_torch_corp.py (numpy-made, carried
across by interop). Pruned models are compared through their logits on a
held-out batch: the class-1 SVD fold is unique only up to paired signs.
"""
from __future__ import annotations

import itertools
import logging
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.core import CalibrationEngine as JaxEngine  # noqa: E402
from repro.core import PruneConfig as JaxPC  # noqa: E402
from repro.core import corp_prune as jax_corp_prune  # noqa: E402
from repro.core import corp_prune_streamed as jax_streamed  # noqa: E402
from repro.core import discover_units as jax_units  # noqa: E402
from repro.core import ranking as jax_ranking  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import AsyncCheckpointer  # noqa: E402
from repro_torch.checkpoint import ckpt as ckpt_mod  # noqa: E402
from repro_torch.checkpoint import load_arrays  # noqa: E402
from repro_torch.configs import resolve_config  # noqa: E402
from repro_torch.core import CalibrationEngine, PruneConfig  # noqa: E402
from repro_torch.core import corp_prune, corp_prune_streamed  # noqa: E402
from repro_torch.core import discover_units, ranking  # noqa: E402
from repro_torch.core import stats as stats_mod  # noqa: E402
from repro_torch.data import calib_stream  # noqa: E402
from repro_torch.distrib import CalibrationCheckpointer  # noqa: E402
from repro_torch.launch import prune as pt_prune  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from torch_parity import (images, jax_params, mlp_rank_args,  # noqa: E402
                          port_cfg)

N_BATCHES, B = 3, 4
KEEP_ATTN = 8           # of 16 qk dims per head at sparsity 0.5


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("deit-base"))
    params = jax_params(cfg, seed=7)
    batches = [images(cfg, B=B, seed=100 + i) for i in range(N_BATCHES)]
    return {
        "cfg": cfg, "params": params,
        "jax_model": jax_build(cfg),
        "jax_params": jax.tree.map(jnp.asarray, params),
        "jax_calib": lambda: ({"images": jnp.asarray(x)} for x in batches),
        "pt_model": pt_build(port_cfg(cfg)),
        "pt_params": interop.from_numpy(params, device="cpu"),
        "pt_calib": lambda: ({"images": torch.from_numpy(x)}
                             for x in batches),
        "units": discover_units(port_cfg(cfg)),
        "held_out": images(cfg, B=5, seed=999),
    }


def _port_logits(s, pp, pcfg):
    return pt_build(pcfg).apply(
        pp, {"images": torch.from_numpy(s["held_out"])}).numpy()


def _jax_logits(s, jp, jcfg):
    return np.asarray(jax_build(jcfg).apply(
        jp, {"images": jnp.asarray(s["held_out"])}))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close_tree(got, want, rtol, atol_frac=None):
    """Every leaf of ``want`` (numpy-like) against ``got`` (tensors), with
    an absolute floor of ``atol_frac`` (default rtol) x the leaf's max."""
    for unit, stats in want.items():
        for k, w in stats.items():
            g = got[unit][k].numpy()
            w = np.asarray(w)
            assert g.shape == w.shape, (unit, k)
            np.testing.assert_allclose(
                g, w, rtol=rtol,
                atol=(atol_frac or rtol) * float(np.abs(w).max()),
                err_msg=f"{unit}/{k}")


def _flat_equal(a, b):
    fa, fb = interop.flatten(a), interop.flatten(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                          for k in fa)


# ---------------------------------------------------------------------------
# bf16 tap streaming
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_pass1(setup):
    s = setup
    want = JaxEngine(s["jax_model"], jax_units(s["cfg"]), phase=1,
                     stats_dtype="bfloat16") \
        .run(s["jax_params"], s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], s["units"], phase=1,
                            stats_dtype="bfloat16") \
        .run(s["pt_params"], s["pt_calib"]())
    return want, got


def test_bf16_pass1_statistics_match_jax(bf16_pass1):
    """Both packages round the same fp32 taps to bf16, but their fp32 taps
    differ in the last bits (another order of sums), so a tap that lies
    near a rounding boundary rounds one bf16 ulp (2^-8, 3.9e-3 relative)
    the other way in one package. A flipped tap moves its terms of a sum
    by that much; over the 204 tokens a batch stack holds, the sums stay
    within 1e-3 relative, with a floor of 1e-3 of the leaf's largest entry
    for entries that cancel towards 0 (fp32 streams: 1e-4,
    tests/test_torch_corp.py). The activity counts ``na`` may move by a
    token where a tap straddles the threshold."""
    want, got = bf16_pass1
    assert sorted(got) == sorted(want)
    for unit, stats in want.items():
        for k, w in stats.items():
            g, w = got[unit][k].numpy(), np.asarray(w)
            assert g.shape == w.shape, (unit, k)
            if k == "na":
                assert np.abs(g - w).max() <= 1.0, unit
            else:
                np.testing.assert_allclose(
                    g, w, rtol=1e-3, atol=1e-3 * float(np.abs(w).max()),
                    err_msg=f"{unit}/{k}")


def test_bf16_keep_sets_identical(setup, bf16_pass1):
    want, got = bf16_pass1
    w2 = setup["params"]["seg0"]["p0"]["mlp"]["wd"]
    for u in jax_units(setup["cfg"]):
        g = {k: v.numpy() for k, v in got[u.name].items()}
        if u.kind == "mlp":
            a = jax_ranking.rank_mlp(want[u.name], w2, 128)
            b = ranking.rank_mlp(*mlp_rank_args(g, w2), 128)
        else:
            a = jax_ranking.rank_attn(want[u.name], KEEP_ATTN)
            b = ranking.rank_attn(g, KEEP_ATTN)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=u.name)


def test_bf16_pruned_model_matches_jax(setup):
    s = setup
    jp, jcfg, _ = jax_corp_prune(s["jax_model"], s["jax_params"],
                                 s["jax_calib"], JaxPC(0.5, 0.5),
                                 stats_dtype="bfloat16")
    pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                               PruneConfig(0.5, 0.5), stats_dtype="bfloat16")
    assert (pcfg.eff_d_ff, pcfg.eff_qk) == (jcfg.eff_d_ff, jcfg.eff_qk)
    assert rep["traversals"] == 2
    rel = _rel(_port_logits(s, pp, pcfg), _jax_logits(s, jp, jcfg))
    assert rel <= 2e-3, rel


def test_fingerprint_includes_stats_dtype_and_matches_jax(setup):
    s = setup
    ju = jax_units(s["cfg"])
    dims = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 4, 16))
    plan = {"seg0/p0/attn": (dims[..., ::2], dims[..., 1::2])}
    for kw in (dict(phase=1), dict(phase=1, stats_dtype="bfloat16"),
               dict(phase=2, plan=plan)):
        got = CalibrationEngine(s["pt_model"], s["units"], **kw).fingerprint
        want = JaxEngine(s["jax_model"], ju, **kw).fingerprint
        assert got == want, kw
    f32 = CalibrationEngine(s["pt_model"], s["units"], phase=1).fingerprint
    f16 = CalibrationEngine(s["pt_model"], s["units"], phase=1,
                            stats_dtype="bfloat16").fingerprint
    assert f32 != f16


def test_engine_refuses_an_unknown_streaming_dtype(setup):
    with pytest.raises(ValueError, match="stats_dtype"):
        CalibrationEngine(setup["pt_model"], setup["units"],
                          stats_dtype="float16")


# ---------------------------------------------------------------------------
# one-traversal calibration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_pass(setup):
    """The port's two-pass prune (fp32) and its pass-1 statistics."""
    s = setup
    pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                               PruneConfig(0.5, 0.5))
    p1 = CalibrationEngine(s["pt_model"], s["units"], phase=1) \
        .run(s["pt_params"], s["pt_calib"]())
    return {"logits": _port_logits(s, pp, pcfg), "report": rep,
            "p1": {u: {k: v.numpy() for k, v in d.items()}
                   for u, d in p1.items()}}


def _spec_plan(two_pass, margin):
    st = two_pass["p1"]["seg0/p0/attn"]
    return {"seg0/p0/attn": ranking.candidate_attn(st, KEEP_ATTN, margin)}


@pytest.mark.parametrize("stats_dtype,rtol", [("float32", 1e-4),
                                              ("bfloat16", 1e-3)])
def test_spec_pass2_sums_match_jax(setup, two_pass, stats_dtype, rtol):
    """fp32 streams: rtol 1e-4 (fp32 sums in another order). bf16 streams:
    rtol 1e-3, the bound of the bf16 pass-1 test and for the same reason
    (a tap one bf16 ulp apart in the two packages); the per-sample grams
    that build these sums are the same products of the same bf16 taps."""
    s = setup
    spec_plan = _spec_plan(two_pass, 0.25)
    want = JaxEngine(s["jax_model"], jax_units(s["cfg"]), phase="1+2",
                     spec_plan=spec_plan, stats_dtype=stats_dtype) \
        .run(s["jax_params"], s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], s["units"], phase="1+2",
                            spec_plan=spec_plan, stats_dtype=stats_dtype) \
        .run(s["pt_params"], s["pt_calib"]())
    assert sorted(got) == ["p1", "p2spec"]
    assert got["p2spec"]["seg0/p0/attn"]["Gc"].shape == (2, 4, 10, 10, 10, 10)
    _close_tree(got["p2spec"], want["p2spec"], rtol=rtol)
    if stats_dtype == "float32":
        _close_tree(got["p1"], want["p1"], rtol=rtol)


def test_spec_reconstruct_equals_the_ports_pass2(setup, two_pass):
    """A keep-set inside the candidates: (G, h, t2) rebuilt from the
    speculative sums equal a pass-2 traversal's, rtol 1e-4."""
    s = setup
    spec_plan = _spec_plan(two_pass, 0.25)
    keep, prune = ranking.rank_attn(two_pass["p1"]["seg0/p0/attn"],
                                    KEEP_ATTN)
    assert ranking.covers(spec_plan["seg0/p0/attn"], keep)
    spec = CalibrationEngine(s["pt_model"], s["units"], phase="1+2",
                             spec_plan=spec_plan) \
        .run(s["pt_params"], s["pt_calib"]())["p2spec"]["seg0/p0/attn"]
    unit = next(u for u in s["units"] if u.kind == "attn")
    rec = stats_mod.spec_reconstruct(
        {k: v.numpy() for k, v in spec.items()}, spec_plan[unit.name], keep,
        unit)
    want = CalibrationEngine(s["pt_model"], s["units"], phase=2,
                             plan={unit.name: (keep, prune)}) \
        .run(s["pt_params"], s["pt_calib"]())[unit.name]
    for k, w in want.items():
        w = w.numpy()
        assert rec[k].shape == w.shape and rec[k].dtype == np.float32, k
        np.testing.assert_allclose(rec[k], w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=k)


def test_one_traversal_hit_matches_jax_and_two_pass(setup, two_pass):
    s = setup
    calls = [0]

    def counted():
        calls[0] += 1
        return s["pt_calib"]()
    pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"], counted,
                               PruneConfig(0.5, 0.5), one_traversal=True,
                               spec_margin=1.0)
    assert rep["traversals"] == 1 and calls[0] == 1
    sp = rep["speculative"]
    assert sp["misses"] == [] and sp["hits"] == ["seg0/p0/attn"]
    assert sp["candidates"] == {"seg0/p0/attn": 16} and sp["margin"] == 1.0
    jp, jcfg, jrep = jax_corp_prune(s["jax_model"], s["jax_params"],
                                    s["jax_calib"], JaxPC(0.5, 0.5),
                                    one_traversal=True, spec_margin=1.0)
    assert jrep["traversals"] == 1
    got = _port_logits(s, pp, pcfg)
    assert _rel(got, _jax_logits(s, jp, jcfg)) <= 1e-3
    assert _rel(got, two_pass["logits"]) <= 1e-3


def test_one_traversal_miss_falls_back_to_a_targeted_pass2(
        setup, two_pass, monkeypatch):
    """Bottom-k candidates with no margin: the attention unit escapes, one
    targeted pass 2 runs, and the result is the two-pass one."""
    s = setup
    orig = ranking.candidate_attn

    def adversarial(stats, keep_n, margin):
        return orig({"rank": -np.asarray(stats["rank"], np.float64)},
                    keep_n, 0.0)
    monkeypatch.setattr(ranking, "candidate_attn", adversarial)
    pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                               PruneConfig(0.5, 0.5), one_traversal=True)
    assert rep["traversals"] == 2
    assert rep["speculative"]["misses"] == ["seg0/p0/attn"]
    assert _rel(_port_logits(s, pp, pcfg), two_pass["logits"]) <= 1e-6


def test_one_traversal_at_zero_sparsity_leaves_params_bitwise(setup):
    s = setup
    pp, _, rep = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                            PruneConfig(0.0, 0.0), one_traversal=True)
    assert _flat_equal(pp, s["pt_params"])
    assert rep["traversals"] == 1 and "speculative" not in rep


# ---------------------------------------------------------------------------
# statistics checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", [1, 2, "1+2"])
def test_resumed_pass_equals_uninterrupted(setup, two_pass, phase, tmp_path):
    s = setup
    kw = {1: {}, 2: {"plan": {"seg0/p0/attn": ranking.rank_attn(
        two_pass["p1"]["seg0/p0/attn"], KEEP_ATTN)}},
        "1+2": {"spec_plan": _spec_plan(two_pass, 0.25)}}[phase]

    def engine():
        return CalibrationEngine(s["pt_model"], s["units"], phase=phase,
                                 **kw)
    ck = str(tmp_path / "calib")
    engine().run(s["pt_params"], itertools.islice(s["pt_calib"](), 2),
                 checkpointer=CalibrationCheckpointer(ck, every=1))
    eng, reduced_ = engine(), []
    reduce = eng.reduce
    eng.reduce = lambda p, b: reduced_.append(b) or reduce(p, b)
    resumed = eng.run(s["pt_params"], s["pt_calib"](),
                      checkpointer=CalibrationCheckpointer(ck, every=1))
    # only the batch after the checkpoint's cursor was reduced
    last = list(s["pt_calib"]())[2]["images"]
    assert len(reduced_) == 1 and torch.equal(reduced_[0]["images"], last)
    assert _flat_equal(resumed, engine().run(s["pt_params"],
                                             s["pt_calib"]()))


@pytest.mark.parametrize("one_traversal,tags", [(False, {"pass1", "pass2"}),
                                                (True, {"pass12"})])
def test_corp_prune_resumes_to_equal_weights(setup, one_traversal, tags,
                                             tmp_path, monkeypatch):
    """The second run restores every pass whole and reduces no batch (the
    one-traversal selector still reads the first batch, as in JAX)."""
    s = setup
    counts = []
    reduce = CalibrationEngine.reduce

    def counted(self, params, batch):
        counts[-1] += 1
        return reduce(self, params, batch)
    monkeypatch.setattr(CalibrationEngine, "reduce", counted)
    runs = []
    for _ in range(2):
        counts.append(0)
        runs.append(corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                               PruneConfig(0.5, 0.5), ckpt_dir=str(tmp_path),
                               ckpt_every=1, one_traversal=one_traversal,
                               spec_margin=1.0))
    assert {p.name for p in tmp_path.iterdir()} == tags
    assert counts == ([1 + N_BATCHES, 1] if one_traversal
                      else [2 * N_BATCHES, 0])
    assert _flat_equal(runs[0][0], runs[1][0])


def test_a_foreign_checkpoint_is_ignored(setup, tmp_path, caplog):
    """A checkpoint of the fp32 stream is not resumed by a bf16 engine: it
    warns and starts fresh."""
    s = setup
    ck = str(tmp_path / "calib")
    CalibrationEngine(s["pt_model"], s["units"], phase=1).run(
        s["pt_params"], s["pt_calib"](),
        checkpointer=CalibrationCheckpointer(ck, every=1))
    eng = CalibrationEngine(s["pt_model"], s["units"], phase=1,
                            stats_dtype="bfloat16")
    with caplog.at_level(logging.WARNING, logger="repro_torch.fault"):
        got = eng.run(s["pt_params"], s["pt_calib"](),
                      checkpointer=CalibrationCheckpointer(ck, every=1))
    assert "different configuration" in caplog.text
    assert _flat_equal(got, eng.run(s["pt_params"], s["pt_calib"]()))


def test_async_snapshot_is_not_changed_by_the_next_add(tmp_path,
                                                       monkeypatch):
    """The write runs after the caller's next in-place add (forced by
    holding the writer until then): the checkpoint still holds the values
    of the moment ``save`` was called."""
    release = threading.Event()
    orig = ckpt_mod.save_checkpoint

    def held(*a, **k):
        assert release.wait(timeout=30)
        return orig(*a, **k)
    monkeypatch.setattr(ckpt_mod, "save_checkpoint", held)
    acc = {"u/x": {"s2": torch.ones(4, 4), "n": torch.full((2,), 3.0)}}
    saver = AsyncCheckpointer(str(tmp_path))
    saver.save(1, acc, {"n_batches": 1})
    acc["u/x"]["s2"].add_(5.0)
    acc["u/x"]["n"].add_(1.0)
    release.set()
    saver.wait()
    flat, extra = load_arrays(str(tmp_path), 1)
    assert extra == {"n_batches": 1}
    assert torch.equal(flat["u/x/s2"], torch.ones(4, 4))
    assert torch.equal(flat["u/x/n"], torch.full((2,), 3.0))


def test_async_checkpointer_keeps_the_newest_steps(tmp_path):
    saver = AsyncCheckpointer(str(tmp_path), keep=2)
    for step in range(1, 5):
        saver.save(step, {"a": torch.full((3,), float(step))})
    saver.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) \
        == ["step_00000003", "step_00000004"]


def test_dropped_batches_shrink_n_and_all_dropped_raises(setup):
    s = setup

    def drop_one(i):
        if i == 1:
            raise RuntimeError("lost host")
    eng = CalibrationEngine(s["pt_model"], s["units"], phase=1)
    got = eng.run(s["pt_params"], s["pt_calib"](), fail_hook=drop_one)
    assert float(got["seg0/p0/mlp"]["n"][0]) == (N_BATCHES - 1) * B * 17
    with pytest.raises(ValueError, match="every calibration batch failed"):
        eng.run(s["pt_params"], s["pt_calib"](),
                fail_hook=lambda i: (_ for _ in ()).throw(RuntimeError()))


# ---------------------------------------------------------------------------
# streamed CORP
# ---------------------------------------------------------------------------

STREAMED = pytest.mark.parametrize("group,one_traversal,groups,traversals", [
    (1, False, 2, 3), (2, False, 1, 2), (1, True, 2, 2), (2, True, 1, 1)])


@STREAMED
def test_streamed_equals_corp_prune(setup, two_pass, group, one_traversal,
                                    groups, traversals):
    """The reduced DeiT has 2 stacked units (attention, MLP), as in the JAX
    package; a group with attention traverses the set twice (once on a
    speculative hit), one without once."""
    s = setup
    pp, pcfg, rep = corp_prune_streamed(
        s["pt_model"], s["pt_params"], s["pt_calib"], PruneConfig(0.5, 0.5),
        unit_group_size=group, one_traversal=one_traversal, spec_margin=1.0)
    assert (rep["groups"], rep["traversals"]) == (groups, traversals)
    assert rep["plan_sizes"] == two_pass["report"]["plan_sizes"]
    assert sorted(rep["units"]) == sorted(two_pass["report"]["units"])
    assert rep["units"]["seg0/p0/mlp"]["j_star"].shape == (2,)
    assert _rel(_port_logits(s, pp, pcfg), two_pass["logits"]) <= 1e-5


@STREAMED
def test_streamed_matches_jax_streamed(setup, group, one_traversal, groups,
                                       traversals):
    """The same groups and traversals as the JAX package's
    ``corp_prune_streamed``, and its pruned logits within 1e-4: the two
    packages' fp32 sums and solves run in another order (8e-6 here), and
    tests/test_torch_corp.py holds ``corp_prune`` to 1e-3."""
    s = setup
    kw = dict(unit_group_size=group, one_traversal=one_traversal,
              spec_margin=1.0)
    jp, jcfg, jrep = jax_streamed(s["jax_model"], s["jax_params"],
                                  s["jax_calib"], JaxPC(0.5, 0.5), **kw)
    pp, pcfg, rep = corp_prune_streamed(
        s["pt_model"], s["pt_params"], s["pt_calib"], PruneConfig(0.5, 0.5),
        **kw)
    assert (jrep["groups"], jrep["traversals"]) == (groups, traversals)
    assert (rep["groups"], rep["traversals"]) == (groups, traversals)
    assert rep["plan_sizes"] == jrep["plan_sizes"]
    assert ("speculative" in rep) == ("speculative" in jrep)
    rel = _rel(_port_logits(s, pp, pcfg), _jax_logits(s, jp, jcfg))
    assert rel <= 1e-4, rel


# ---------------------------------------------------------------------------
# the prune CLI
# ---------------------------------------------------------------------------

def test_cli_parses_every_new_flag():
    a = pt_prune.parse_args([
        "--arch", "deit-base-reduced", "--calib-ckpt", "d",
        "--calib-ckpt-every", "3", "--one-traversal", "--spec-margin", "0.5",
        "--stats-dtype", "bfloat16", "--ckpt-in", "c"])
    assert (a.calib_ckpt, a.calib_ckpt_every, a.one_traversal,
            a.spec_margin, a.stats_dtype, a.ckpt_in) \
        == ("d", 3, True, 0.5, "bfloat16", "c")
    d = pt_prune.parse_args(["--arch", "deit-base-reduced"])
    assert (d.calib_ckpt, d.calib_ckpt_every, d.one_traversal,
            d.spec_margin, d.stats_dtype) == (None, 8, False, 0.25,
                                              "float32")


@pytest.mark.parametrize("flag", [["--calib-sharded", "--gram-tiles",
                                   "128,512"],
                                  ["--mesh", "2x2"], ["--calib-sharded"],
                                  ["--gram-tiles", "128,512"]])
def test_cli_refuses_unported_flags_by_name(flag):
    """Each unported flag is refused by name; of two, the first."""
    with pytest.raises(NotImplementedError, match=flag[0]):
        pt_prune.main(["--arch", "deit-base-reduced", "--device", "cpu",
                       *flag])


def test_cli_one_traversal_bf16_checkpointed_run(tmp_path, capsys):
    args = ["--arch", "deit-base-reduced", "--calib", "16",
            "--calib-batch", "8", "--device", "cpu", "--one-traversal",
            "--spec-margin", "1.0", "--stats-dtype", "bfloat16",
            "--calib-ckpt", str(tmp_path), "--calib-ckpt-every", "1"]
    first = pt_prune.main(args)
    second = pt_prune.main(args)
    assert "[prune] one-traversal: 1 traversal(s), margin 1.0, 1 hit / 0 " \
        "miss" in capsys.readouterr().out
    assert [p.name for p in tmp_path.iterdir()] == ["pass12"]
    assert _flat_equal(first["pruned_params"], second["pruned_params"])


def test_cli_ckpt_in_loads_the_params_of_a_train_checkpoint(setup,
                                                            tmp_path):
    """A (params, opt_state) tuple saved by the JAX package: --ckpt-in
    prunes its params, exactly as pruning them directly does."""
    s = setup
    opt_state = {"count": np.int32(3),
                 "mu": jax.tree.map(np.zeros_like, s["params"])}
    jax_save(str(tmp_path), 5, (s["params"], opt_state))
    res = pt_prune.main(["--arch", "deit-base-reduced", "--calib", "16",
                         "--calib-batch", "8", "--device", "cpu",
                         "--ckpt-in", str(tmp_path)])
    assert _flat_equal(res["params"], s["pt_params"])
    cfg = resolve_config("deit-base-reduced")
    direct, _, _ = corp_prune(
        pt_build(cfg), s["pt_params"],
        calib_stream(cfg, n_samples=16, batch=8, device="cpu"),
        PruneConfig(0.5, 0.5))
    assert _flat_equal(res["pruned_params"], direct)
