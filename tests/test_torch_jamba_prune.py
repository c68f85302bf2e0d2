"""The port's CORP on jamba-1.5-large-398b against the JAX package: Mamba
units (the inner channels on the ``mamba_y`` tap, ranked on ``out_proj``,
compensated through ``out_proj`` and ``out_b``, every channel-wise leaf
gathered), the dense GLU and per-expert MoE units beside them, class-2
attention on the hybrid's attention layer, ``include_mamba``, the large
per-expert moments reduced a chunk of experts at a time, checkpoints and
serving the pruned model.

jamba-1.5-large-398b-reduced in fp32 on the CPU, the same numpy-made
weights and the reference's Markov calibration tokens in both packages
(``torch_parity.lm_prune_setup``). Keep sets and the gathered weights
must be equal; statistics, folded leaves and pruned logits on held-out
tokens are held to rtol 1e-5 and atol 1e-5 of each array's scale (its
largest magnitude, at least 1).
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
from repro.core import discover_units as jax_units  # noqa: E402
from repro.core import pruner as jax_pruner  # noqa: E402
from repro.core import ranking as jax_ranking  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro.serve import synthetic_trace as jax_trace  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import CalibrationEngine, PruneConfig  # noqa: E402
from repro_torch.core import corp_prune, corp_prune_streamed  # noqa: E402
from repro_torch.core import discover_units, ranking  # noqa: E402
from repro_torch.core import pruner as pt_pruner  # noqa: E402
from repro_torch.core import stats as stats_mod  # noqa: E402
from repro_torch.launch import prune as pt_prune  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from torch_parity import (lm_logits, lm_prune_setup, mlp_rank_args,  # noqa: E402
                          to_port_cfg)

ARCH = "jamba-1.5-large-398b"
MAMBA0, MLP0, MAMBA1, MOE1 = ("seg0/p0/mamba", "seg0/p0/mlp",
                              "seg0/p1/mamba", "seg0/p1/moe")
ATTN4, MAMBA7 = "seg0/p4/attn", "seg0/p7/mamba"
MAMBAS = [f"seg0/p{j}/mamba" for j in (0, 1, 2, 3, 5, 6, 7)]
SERVE = ["--trace", "4", "--slots", "2", "--max-len", "40",
         "--prompt-range", "6,16", "--gen-range", "3,8", "--device", "cpu"]
RTOL, ATOL = 1e-5, 1e-5
_JAX, _PORT = {}, {}


@pytest.fixture(scope="module")
def s():
    return lm_prune_setup(ARCH, seed=9)


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=err_msg)


def _jax_prune(s, **kw):
    """JAX's ``corp_prune`` of the setup at 0.5/0.5, once per keyword set:
    (params, config, report, held-out logits)."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX:
        out = jax_corp_prune(s["jax_model"], s["jax_params"], s["jax_calib"],
                             JaxPC(0.5, 0.5, **kw))
        _JAX[key] = out + (lm_logits(jax_build(out[1]), out[0],
                                     s["jax_held"]),)
    return _JAX[key]


def _port_prune(s, **kw):
    """The port's two-pass ``corp_prune`` of the setup at 0.5/0.5, once per
    keyword set: (params, config, report)."""
    key = tuple(sorted(kw.items()))
    if key not in _PORT:
        _PORT[key] = corp_prune(s["pt_model"], s["pt_params"],
                                s["pt_calib"], PruneConfig(0.5, 0.5, **kw))
    return _PORT[key]


def _port_logits(s, params, cfg):
    with torch.no_grad():
        return lm_logits(pt_build(cfg), params, s["pt_held"])


def _check_j(report):
    for unit, d in report["units"].items():
        js, ju = np.asarray(d["j_star"]), np.asarray(d["j_uncomp"])
        assert (js <= ju * (1 + 1e-5) + 1e-6).all(), unit


def _gathered_equal(pp, jp):
    """Every Mamba layer's gathered leaves (the kept inner channels, in
    order) equal JAX's, bit for bit."""
    for j in (0, 1, 2, 3, 5, 6, 7):
        got, want = pp["seg0"][f"p{j}"]["mixer"], jp["seg0"][f"p{j}"]["mixer"]
        for k in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                  "dt_bias", "a_log", "d_skip"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          f"p{j} {k}")


# ---------------------------------------------------------------------------
# units, statistics, ranking
# ---------------------------------------------------------------------------

def test_units_are_the_jax_units(s):
    """Seven Mamba units of 128 inner channels, four dense MLPs of 128,
    four MoE units of 4 experts of 128, and the class-2 attention unit of
    layer 4."""
    want = [(u.name, u.kind, u.attn_class, u.n_groups, u.d_hidden,
             u.param_key) for u in jax_units(s["jcfg"])]
    got = [(u.name, u.kind, u.attn_class, u.n_groups, u.d_hidden,
            u.param_key) for u in discover_units(s["cfg"])]
    assert got == want
    assert got[:4] == [(MAMBA0, "mamba", 1, 1, 128, "mixer"),
                       (MLP0, "mlp", 1, 1, 128, "mlp"),
                       (MAMBA1, "mamba", 1, 1, 128, "mixer"),
                       (MOE1, "moe", 1, 1, 128, "mlp")]
    assert (ATTN4, "attn", 2, 1, 0, "mixer") in got


@pytest.fixture(scope="module")
def pass1(s):
    want = JaxEngine(s["jax_model"], jax_units(s["jcfg"]), phase=1) \
        .run(s["jax_params"], s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], discover_units(s["cfg"]),
                            phase=1).run(s["pt_params"], s["pt_calib"]())
    return jax.tree.map(np.asarray, want), interop.to_numpy(got)


@pytest.mark.parametrize("unit", [MAMBA0, MAMBA7, MLP0, MOE1])
def test_pass1_statistics_match_jax(pass1, unit):
    """The ``mamba_y`` moments of a Mamba unit ({n, s1, s2, na}, (1, 128,
    128) stacked), as the dense MLP's and the experts' beside them."""
    want, got = pass1
    keys = sorted(got[unit])
    assert keys == sorted(k for k in want[unit]
                          if k not in ("yn", "ys1", "ys2"))
    for k in keys:
        _close(got[unit][k], want[unit][k], k)
    shapes = {MAMBA0: (1, 128, 128), MAMBA7: (1, 128, 128),
              MLP0: (1, 128, 128), MOE1: (1, 4, 128, 128)}
    assert got[unit]["s2"].shape == shapes[unit]


def test_keep_sets_identical_to_jax(s, pass1):
    """Inner channels ranked on the ``mamba_y`` moments and ``out_proj``'s
    row norms (64 of 128 a layer); MLP and expert channels likewise."""
    want, got = pass1
    for unit, key, w2 in [(u, u.split("/")[1], "out_proj") for u in MAMBAS] \
            + [(MLP0, "p0", "wd"), (MOE1, "p1", "wd")]:
        kind = "mixer" if w2 == "out_proj" else "mlp"
        w = s["np"]["seg0"][key][kind][w2]
        jk, jpr = jax_ranking.rank_mlp(want[unit], w, 64)
        pk, ppr = ranking.rank_mlp(*mlp_rank_args(got[unit], w), 64)
        np.testing.assert_array_equal(pk, jk, unit)
        np.testing.assert_array_equal(ppr, jpr, unit)


@pytest.mark.parametrize("compensate", [True, False])
def test_fold_mamba_block_matches_jax(s, pass1, compensate):
    """``_fold_mamba_block`` of layer 0 on the same statistics and keep
    set: ``out_proj`` compensated (or gathered) and ``out_b`` (only when
    compensated) within the tolerance, every gathered leaf equal, J* <=
    J_uncomp."""
    want, got = pass1
    w = s["np"]["seg0"]["p0"]["mixer"]
    keep, prune = jax_ranking.rank_mlp(want[MAMBA0], w["out_proj"], 64)
    unit = next(u for u in discover_units(s["cfg"]) if u.name == MAMBA0)
    junit = next(u for u in jax_units(s["jcfg"]) if u.name == MAMBA0)
    jrep, prep = {}, {}
    jnew = jax_pruner._fold_mamba_block(
        jax.tree.map(jnp.asarray, w), jax.tree.map(jnp.asarray, want[MAMBA0]),
        junit, JaxPC(0.5, 0.5, compensate=compensate), keep, prune, jrep)
    pnew = pt_pruner._fold_mamba_block(
        interop.from_numpy(w, "cpu"),
        interop.from_numpy(got[MAMBA0], "cpu"), unit,
        PruneConfig(0.5, 0.5, compensate=compensate), keep, prune, prep)
    assert sorted(pnew) == sorted(jnew)
    assert ("out_b" in pnew) == compensate
    for k, v in jnew.items():
        assert tuple(pnew[k].shape) == v.shape, k
        if k in ("out_proj", "out_b"):
            _close(pnew[k].numpy(), v, k)
        else:
            np.testing.assert_array_equal(pnew[k].numpy(), np.asarray(v), k)
    assert tuple(pnew["in_proj"].shape) == (1, 64, 128)
    assert tuple(pnew["x_proj"].shape) == (1, 64, 12)
    assert tuple(pnew["a_log"].shape) == (1, 64, 4)
    for k in ("j_star", "j_uncomp"):
        _close(prep[MAMBA0][k], jrep[MAMBA0][k], k)
    assert (prep[MAMBA0]["j_star"] <= prep[MAMBA0]["j_uncomp"]).all()


def test_chunked_expert_moments_equal_one_launch(s, monkeypatch):
    """Per-expert moments past ``_MOE_WHOLE`` are reduced one expert a
    gram launch, added into the running sums in place: the statistics of
    one launch a batch."""
    units = [u for u in discover_units(s["cfg"]) if u.kind == "moe"]
    one = CalibrationEngine(s["pt_model"], units, phase=1) \
        .run(s["pt_params"], s["pt_calib"]())
    calls = []
    orig = stats_mod._masked_moments

    def counted(h, mask, *shard):
        calls.append(h.shape[0])
        return orig(h, mask, *shard)
    monkeypatch.setattr(stats_mod, "_masked_moments", counted)
    monkeypatch.setattr(stats_mod, "_MOE_WHOLE", 0)
    monkeypatch.setattr(stats_mod, "_MOE_CHUNK", 128 * 128 * 4)
    chunked = CalibrationEngine(s["pt_model"], units, phase=1) \
        .run(s["pt_params"], s["pt_calib"]())
    assert calls == [1] * (4 * 4 * 3)       # 4 experts, 4 units, 3 batches
    for u in units:
        for k in ("n", "s1", "s2", "na"):
            torch.testing.assert_close(chunked[u.name][k], one[u.name][k],
                                       rtol=1e-6, atol=1e-6)


def test_moe_fold_one_expert_at_a_time_equals_the_batched_fold(
        s, pass1, monkeypatch):
    """``stats._MOE_CHUNK`` cut so that the MoE fold of layer 1 solves one
    expert at a time (as at jamba's full width): the folded leaves and
    diagnostics of the batched fold (fp32 solves of 1 and 4 systems at
    once, so within the tolerance, not bit for bit)."""
    got = pass1[1][MOE1]
    w = s["np"]["seg0"]["p1"]["mlp"]
    keep, prune = ranking.rank_mlp(*mlp_rank_args(got, w["wd"]), 64)
    unit = next(u for u in discover_units(s["cfg"]) if u.name == MOE1)
    pc = PruneConfig(0.5, 0.0)

    def fold():
        report = {}
        new = pt_pruner._fold_moe_block(
            interop.from_numpy(w, "cpu"), interop.from_numpy(got, "cpu"),
            unit, pc, keep, prune, report)
        return new, report[MOE1]
    batched, bdiag = fold()
    monkeypatch.setattr(stats_mod, "_MOE_CHUNK", 1)
    single, sdiag = fold()
    assert sorted(single) == sorted(batched)
    for k in batched:
        _close(single[k].numpy(), batched[k].numpy(), k)
    for k in bdiag:
        _close(sdiag[k], bdiag[k], k)


# ---------------------------------------------------------------------------
# corp_prune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["two-pass", "one traversal", "streamed"])
@pytest.mark.parametrize("compensate", [True, False])
def test_pruned_logits_match_jax(s, compensate, mode):
    """0.5/0.5: inner channels 128 -> 64 in every Mamba layer, the dense
    MLPs and experts 128 -> 64, qk 16 -> 8 on the attention layer; the
    same config and plan sizes as JAX's two-pass prune, the gathered
    leaves equal, the held-out logits within the tolerance. One traversal
    (margin 1.0, a hit) and streamed (8 units a group: layers 0-3, then
    4-7 with the attention unit) are the same prune."""
    jp, jcfg, jrep, want = _jax_prune(s, compensate=compensate)
    pc = PruneConfig(0.5, 0.5, compensate=compensate)
    if mode == "streamed":
        pp, pcfg, rep = corp_prune_streamed(
            s["pt_model"], s["pt_params"], s["pt_calib"], pc,
            unit_group_size=8)
        assert rep["groups"] == 2 and rep["traversals"] == 3
    elif mode == "one traversal":
        pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"],
                                   s["pt_calib"], pc, one_traversal=True,
                                   spec_margin=1.0)
        assert rep["traversals"] == 1
    else:
        pp, pcfg, rep = _port_prune(s, compensate=compensate)
        assert rep["traversals"] == jrep["traversals"] == 2
    assert pcfg == to_port_cfg(jcfg)
    assert (pcfg.eff_d_inner, pcfg.eff_d_ff, pcfg.eff_qk) == (64, 64, 8)
    assert rep["plan_sizes"] == {k: tuple(v)
                                 for k, v in jrep["plan_sizes"].items()}
    for j in (0, 1, 2, 3, 5, 6, 7):
        mixer = pp["seg0"][f"p{j}"]["mixer"]
        assert ("out_b" in mixer) == compensate
        if compensate:
            _close(mixer["out_b"].numpy(),
                   np.asarray(jp["seg0"][f"p{j}"]["mixer"]["out_b"]))
    if compensate:
        _check_j(rep)
    _gathered_equal(pp, jp)
    _close(_port_logits(s, pp, pcfg), want)


def test_include_mamba_false_matches_jax(s):
    """``include_mamba=False``: the Mamba units keep every inner channel
    (``d_inner_kept`` None, the mixers the dense model's own tensors);
    the other units prune as JAX's."""
    jp, jcfg, jrep, want = _jax_prune(s, include_mamba=False)
    pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                               PruneConfig(0.5, 0.5, include_mamba=False))
    assert pcfg == to_port_cfg(jcfg) and pcfg.d_inner_kept is None
    assert not any(k.endswith("mamba") for k in rep["units"])
    assert sorted(rep["plan_sizes"]) == sorted(jrep["plan_sizes"])
    for j in (0, 1, 2, 3, 5, 6, 7):
        mixer = s["pt_params"]["seg0"][f"p{j}"]["mixer"]
        assert all(pp["seg0"][f"p{j}"]["mixer"][k] is v
                   for k, v in mixer.items())
    _close(_port_logits(s, pp, pcfg), want)


def _mamba_only(cfg, dense, pruned):
    """The dense model with only its Mamba mixers pruned (CORP takes every
    statistic from the dense model, so they are the Mamba-only prune's):
    its config and params."""
    out = dict(dense, seg0={
        lk: dict(blk, mixer=pruned["seg0"][lk]["mixer"])
        if "d_skip" in blk["mixer"] else blk
        for lk, blk in dense["seg0"].items()})
    return cfg.replace(d_inner_kept=64), out


@pytest.mark.parametrize("compensate", [True, False])
def test_mamba_only_prune_matches_jax(s, compensate):
    """Only the Mamba mixers pruned (the rest dense), compensated or not:
    the port's logits are JAX's. Pruned inner channels also leave
    ``x_proj``'s input, so dt, B and C of the kept channels change, which
    the ``out_proj`` ridge does not see (reported on the card, not
    gated)."""
    jp, jcfg = _jax_prune(s, compensate=compensate)[:2]
    pp, pcfg, _ = _port_prune(s, compensate=compensate)
    jc, jm = _mamba_only(s["jcfg"], s["jax_params"], jp)
    pc, pm = _mamba_only(s["cfg"], s["pt_params"], pp)
    assert pc == to_port_cfg(jc)
    _close(_port_logits(s, pm, pc),
           lm_logits(jax_build(jc), jm, s["jax_held"]))


# ---------------------------------------------------------------------------
# checkpoints and the CLIs
# ---------------------------------------------------------------------------

_CLI = ["--arch", ARCH + "-reduced", "--calib", "16", "--calib-batch", "8",
        "--calib-seq", "16", "--device", "cpu"]


def test_cli_checkpoint_drops_out_b_in_jax_not_in_the_port(s, tmp_path):
    """Reference fault 2 extended to Mamba: the prune CLI writes
    ``mixer/out_b`` (with ``mlp/bd`` and ``bd_moe``); JAX's pruned
    template has none of them (``init_mamba`` never makes ``out_b``), so
    its restore drops them and its model computes other logits. Given a
    template that holds them, JAX's model computes the port's; the port's
    serve CLI restores them."""
    out = str(tmp_path)
    res = pt_prune.main(_CLI + ["--sparsity", "0.5", "--out", out])
    pcfg, pm = res["pruned_cfg"], res["pruned_params"]
    want = _port_logits(s, pm, pcfg)
    jcfg = s["jcfg"].pruned(0.5, 0.5)
    jtmpl = jax_build(jcfg).init(jax.random.PRNGKey(0))
    dropped, _ = jax_restore(out, 0, jtmpl)
    assert "out_b" not in dropped["seg0"]["p0"]["mixer"]
    assert "out_b" in pm["seg0"]["p0"]["mixer"]
    diff = np.abs(lm_logits(jax_build(jcfg), dropped, s["jax_held"]) - want)
    assert diff.max() > 1e-3 * np.abs(want).max()
    for j in range(8):
        for part, k in (("mixer", "out_b"), ("mlp", "bd"), ("mlp", "bd_moe")):
            src = pm["seg0"][f"p{j}"][part]
            if k in src:
                jtmpl["seg0"][f"p{j}"][part][k] = jnp.zeros(
                    tuple(src[k].shape))
    full, _ = jax_restore(out, 0, jtmpl)
    _close(lm_logits(jax_build(jcfg), full, s["jax_held"]), want)
    served = pt_serve.main(["--arch", ARCH + "-reduced", "--sparsity", "0.5",
                            "--ckpt-in", out] + SERVE)
    got = served["params"]["seg0"]["p0"]["mixer"]["out_b"]
    assert torch.equal(got, pm["seg0"]["p0"]["mixer"]["out_b"])
    assert bool(got.any()) and len(served["completions"]) == 4


def test_no_compensate_checkpoint_serves_out_b_as_zeros(tmp_path):
    """A ``--no-compensate`` checkpoint has no ``mixer/out_b``; the serve
    CLI restores it as zeros (``COMPENSATION_LEAVES``)."""
    out = str(tmp_path)
    pt_prune.main(_CLI + ["--sparsity", "0.5", "--no-compensate", "--out",
                          out])
    assert "mixer/out_b" in pt_serve.COMPENSATION_LEAVES
    served = pt_serve.main(["--arch", ARCH + "-reduced", "--sparsity", "0.5",
                            "--ckpt-in", out] + SERVE)
    assert not served["params"]["seg0"]["p3"]["mixer"]["out_b"].any()
    assert len(served["completions"]) == 4


def test_serve_cli_streams_of_the_jax_prune_equal_the_jax_engine(
        s, tmp_path):
    """``launch.serve --ckpt-in`` of JAX's 0.5/0.5 prune (compensated,
    ``out_b`` written into the checkpoint): the streams equal the JAX
    engine's on JAX's pruned params, which hold ``out_b``."""
    jp, jcfg = _jax_prune(s, compensate=True)[:2]
    jax_save(str(tmp_path), 0, jax.tree.map(np.asarray, jp),
             extra={"config": jcfg.name})
    served = pt_serve.main(["--arch", ARCH + "-reduced", "--ckpt-in",
                            str(tmp_path), "--sparsity", "0.5"] + SERVE)
    jeng = JaxServe(jax_build(jcfg), jax.tree.map(jnp.asarray, jp),
                    n_slots=2, max_len=40)
    want = jeng.run(jax_trace(4, jcfg.vocab_size, seed=0,
                              prompt_range=(6, 16), gen_range=(3, 8)))
    assert [c.tokens.tolist() for c in served["completions"]] == \
        [c.tokens.tolist() for c in want]
