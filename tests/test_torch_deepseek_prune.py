"""The port's CORP on deepseek-v3-671b against the JAX package: class-1
MLA units (the nope blocks ``w_uq_nope``/``w_uk_nope``, one group a head;
the rope block untouched), the ``first_k_dense`` layer's MLP on
``dense_d_ff``, each routed expert's channels and the shared expert (an
MLP unit on ``mlp/shared``), pass 2's in-place G, one traversal,
whole-expert removal, streamed CORP, checkpoints in both directions and
serving the pruned model (the last four in
``test_torch_deepseek_prune_cli.py``, split from this file so that two
workers share them).

deepseek-v3-671b-reduced in fp32 on the CPU, the same numpy-made weights
and the reference's Markov calibration tokens in both packages
(``torch_parity.lm_prune_setup``). Keep sets must be equal, and so must
the gathered (uncompensated) weights; pruned models are compared through
their logits on held-out tokens: <= 1e-4 relative against JAX's.
Statistics are held to rtol 1e-4 and atol 1e-5 of each array's scale.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import CalibrationEngine as JaxEngine  # noqa: E402
from repro.core import PruneConfig as JaxPC  # noqa: E402
from repro.core import corp_prune as jax_corp_prune  # noqa: E402
from repro.core import corp_prune_streamed as jax_streamed  # noqa: E402
from repro.core import discover_units as jax_units  # noqa: E402
from repro.core import ranking as jax_ranking  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import CalibrationEngine, PruneConfig  # noqa: E402
from repro_torch.core import corp_prune  # noqa: E402
from repro_torch.core import discover_units, ranking  # noqa: E402
from repro_torch.core import stats as stats_mod  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from torch_parity import (lm_logits, lm_prune_setup, mlp_rank_args,  # noqa: E402
                          rel, to_port_cfg)

ARCH = "deepseek-v3-671b"
MLA0, MLP0 = "seg0/l0/mla", "seg0/l0/mlp"
MLA1, MOE, SHARED = "seg1/p0/mla", "seg1/p0/moe", "seg1/p0/shared"
SERVE = ["--trace", "4", "--slots", "2", "--max-len", "40",
         "--prompt-range", "6,16", "--gen-range", "3,8", "--device", "cpu"]
RTOL, ATOL = 1e-4, 1e-5
_JAX = {}


@pytest.fixture(scope="module")
def s():
    return lm_prune_setup(ARCH, seed=9)


def _close(got, want, err_msg=""):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=err_msg)


def _jax_prune(s, group=None, **kw):
    """JAX's ``corp_prune`` (``corp_prune_streamed`` with ``group``) of the
    setup, 0.5/0.5 by default, once per keyword set: (params, config,
    report, held-out logits)."""
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


def _gathered_equal(pp, jp):
    """The gathered (not compensated) MLP weights of every unit equal
    JAX's: the same channels were kept, in the same order."""
    for path in ("seg0/l0/mlp", "seg1/p0/mlp", "seg1/p0/mlp/shared"):
        seg, lk, *rest = path.split("/")
        got, want = pp[seg][lk], jp[seg][lk]
        for k in rest:
            got, want = got[k], want[k]
        for k in ("wg", "wu"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), path + k)


# ---------------------------------------------------------------------------
# units and statistics
# ---------------------------------------------------------------------------

def test_units_are_the_jax_units(s):
    """Names, kinds and sizes: a class-1 ``mla`` unit a layer (one group a
    head), the dense layer's MLP on ``dense_d_ff``, the routed experts and
    the shared expert (``mlp``, ``shared_expert``)."""
    want = [(u.name, u.kind, u.attn_class, u.n_groups, u.q_per_group,
             u.d_hidden, u.shared_expert) for u in jax_units(s["jcfg"])]
    got = [(u.name, u.kind, u.attn_class, u.n_groups, u.q_per_group,
            u.d_hidden, u.shared_expert) for u in discover_units(s["cfg"])]
    assert got == want == [
        (MLA0, "mla", 1, 4, 1, 0, False), (MLP0, "mlp", 1, 1, 1, 256, False),
        (MLA1, "mla", 1, 4, 1, 0, False), (MOE, "moe", 1, 1, 1, 128, False),
        (SHARED, "mlp", 1, 1, 1, 128, True)]


@pytest.fixture(scope="module")
def pass1(s):
    want = JaxEngine(s["jax_model"], jax_units(s["jcfg"]), phase=1) \
        .run(s["jax_params"], s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], discover_units(s["cfg"]),
                            phase=1).run(s["pt_params"], s["pt_calib"]())
    return jax.tree.map(np.asarray, want), interop.to_numpy(got)


@pytest.mark.parametrize("unit", [MLA0, MLP0, MLA1, MOE, SHARED])
def test_pass1_statistics_match_jax(pass1, unit):
    """The MLA units' energy ranks over the nope dims of each head (the
    unrolled layer without a layer axis, the stacked one with it); the
    dense, expert and shared moments."""
    want, got = pass1
    keys = sorted(got[unit])
    assert keys == sorted(k for k in want[unit]
                          if k not in ("yn", "ys1", "ys2"))
    for k in keys:
        _close(got[unit][k], want[unit][k], k)
    shapes = {MLA0: (4, 16), MLP0: (256, 256), MLA1: (2, 4, 16),
              MOE: (2, 4, 128, 128), SHARED: (2, 128, 128)}
    assert got[unit]["rank" if "mla" in unit else "s2"].shape == shapes[unit]


def test_keep_sets_identical_to_jax(s, pass1):
    """Nope dims a head (8 of 16) and MLP channels a unit, ranked on the
    same statistics and second matrices (the shared expert's own ``wd``)."""
    want, got = pass1
    for unit in (MLA0, MLA1):
        np.testing.assert_array_equal(
            ranking.rank_attn(got[unit], 8)[0],
            jax_ranking.rank_attn(want[unit], 8)[0])
    for unit, path, n in ((MLP0, ("seg0", "l0"), 128),
                          (MOE, ("seg1", "p0"), 64),
                          (SHARED, ("seg1", "p0", "shared"), 64)):
        blk = s["np"][path[0]][path[1]]["mlp"]
        if len(path) > 2:
            blk = blk["shared"]
        jk, jpr = jax_ranking.rank_mlp(want[unit], blk["wd"], n)
        pk, ppr = ranking.rank_mlp(*mlp_rank_args(got[unit], blk["wd"]), n)
        np.testing.assert_array_equal(pk, jk)
        np.testing.assert_array_equal(ppr, jpr)


def _plan(pass1):
    want = pass1[0]
    return {u: jax_ranking.rank_attn(want[u], 8) for u in (MLA0, MLA1)}


def test_pass2_mla_statistics_match_jax(s, pass1, monkeypatch):
    """G (ds^2 x ds^2 a head), h and t2 of both MLA units, summed over the
    3 batches; the port adds each batch's G into its accumulator in place,
    here 3 heads a chunk (``_KRON_CHUNK`` cut to force several)."""
    plan = _plan(pass1)
    want = JaxEngine(s["jax_model"], jax_units(s["jcfg"]), phase=2,
                     plan=plan).run(s["jax_params"], s["jax_calib"]())
    monkeypatch.setattr(stats_mod, "_KRON_CHUNK", 3 * 8 ** 4)
    got = CalibrationEngine(s["pt_model"], discover_units(s["cfg"]),
                            phase=2, plan=plan).run(s["pt_params"],
                                                    s["pt_calib"]())
    got = interop.to_numpy(got)
    assert sorted(got) == [MLA0, MLA1]
    assert got[MLA0]["G"].shape == (4, 64, 64)
    assert got[MLA1]["G"].shape == (2, 4, 64, 64)
    for u in (MLA0, MLA1):
        for k in ("G", "h", "t2"):
            _close(got[u][k], np.asarray(want[u][k]), f"{u} {k}")


def test_pass2_adds_g_in_place(s, pass1):
    """With the running accumulator, a batch's class-1 G goes into it in
    place (the same storage before and after) and is left out of the
    batch's result, which ``tree_add`` then adds (h, t2)."""
    plan = {k: tuple(torch.as_tensor(a, dtype=torch.int64) for a in v)
            for k, v in _plan(pass1).items()}
    units = discover_units(s["cfg"])
    b0, b1 = list(s["pt_calib"]())[:2]

    def taps(batch):
        t = {}
        s["pt_model"].apply(s["pt_params"], batch, taps=t)
        return t
    acc = stats_mod.pass2_reduce(taps(b0), units, plan)
    ptr, first = acc[MLA1]["G"].data_ptr(), acc[MLA1]["G"].clone()
    nxt = stats_mod.pass2_reduce(taps(b1), units, plan, acc)
    assert sorted(nxt[MLA1]) == ["h", "t2"]
    assert acc[MLA1]["G"].data_ptr() == ptr
    alone = stats_mod.pass2_reduce(taps(b1), units, plan)[MLA1]["G"]
    torch.testing.assert_close(acc[MLA1]["G"], first + alone, rtol=1e-6,
                               atol=1e-6 * float(alone.abs().max()))


def test_add_kron_equals_the_einsum_in_any_chunking(monkeypatch):
    """``_add_kron``: sum_b A (x) C in the [(i l), (j k)] layout the
    reference's einsum gives, chunk sizes from one group to all."""
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.standard_normal((5, 3, 4, 4))
                         .astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((5, 3, 4, 4))
                         .astype(np.float32))
    want = torch.einsum("gbij,gblk->giljk", A, C).reshape(5, 16, 16)
    for chunk in (4 ** 4, 2 * 4 ** 4, 1 << 28):
        monkeypatch.setattr(stats_mod, "_KRON_CHUNK", chunk)
        out = torch.ones(5, 16, 16)
        stats_mod._add_kron(out, A, C)
        torch.testing.assert_close(out, want + 1, rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# corp_prune against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compensate,one_traversal",
                         [(True, False), (False, False), (True, True),
                          (False, True)])
def test_pruned_logits_match_jax(s, compensate, one_traversal):
    """0.5/0.5: the nope blocks 16 -> 8 (the rope block untouched), the
    dense MLP 256 -> 128, each expert and the shared expert 128 -> 64;
    the same config, kept channels and traversals as JAX, logits <= 1e-4
    from JAX's."""
    kw = dict(compensate=compensate, one_traversal=one_traversal,
              spec_margin=1.0)
    jp, jcfg, jrep, want = _jax_prune(s, **kw)
    pp, pcfg, rep = corp_prune(
        s["pt_model"], s["pt_params"], s["pt_calib"],
        PruneConfig(0.5, 0.5, compensate=compensate),
        one_traversal=one_traversal, spec_margin=1.0)
    assert pcfg == to_port_cfg(jcfg)
    assert (pcfg.eff_qk, pcfg.eff_dense_d_ff, pcfg.eff_d_expert) \
        == (8, 128, 64)
    assert rep["traversals"] == jrep["traversals"] \
        == (1 if one_traversal else 2)
    assert rep["plan_sizes"] == {k: tuple(v)
                                 for k, v in jrep["plan_sizes"].items()}
    mixer = pp["seg1"]["p0"]["mixer"]
    assert tuple(mixer["w_uq_nope"].shape) == (2, 32, 4, 8)
    assert tuple(mixer["w_uk_nope"].shape) == (2, 16, 4, 8)
    for k in ("w_uq_rope", "w_k_rope", "rope_inv"):
        assert mixer[k] is s["pt_params"]["seg1"]["p0"]["mixer"][k]
    shared = pp["seg1"]["p0"]["mlp"]["shared"]
    assert tuple(shared["wd"].shape) == (2, 64, 64)
    assert ("bd" in shared) == compensate
    if compensate:
        _check_j(rep)
    _gathered_equal(pp, jp)
    assert rel(_port_logits(s, pp, pcfg), want) <= 1e-4


def test_chunked_class1_solve_equals_one_solve(s, monkeypatch):
    """The fold solves the class-1 systems a chunk of heads at a time
    (``stats._KRON_CHUNK // ds^4``): one head a chunk gives the pruned
    model of one solve."""
    pc = PruneConfig(0.0, 0.5)
    one = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"], pc)
    monkeypatch.setattr(stats_mod, "_KRON_CHUNK", 8 ** 4)
    chunked = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"], pc)
    assert rel(_port_logits(s, *chunked[:2]),
               _port_logits(s, *one[:2])) <= 1e-5
    _check_j(chunked[2])


def test_mla_only_and_mlp_only_prunes_match_jax(s):
    """Attention only (the MLA units, class 1) and MLP only (dense,
    experts, shared): each the same as JAX's."""
    for mlp, attn in ((0.0, 0.5), (0.5, 0.0)):
        jp, jcfg, _, want = _jax_prune(s, mlp=mlp, attn=attn)
        pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"],
                                   s["pt_calib"], PruneConfig(mlp, attn))
        assert pcfg == to_port_cfg(jcfg)
        assert sorted(rep["units"]) == sorted(
            [MLA0, MLA1] if attn else [MLP0, MOE, SHARED])
        assert rel(_port_logits(s, pp, pcfg), want) <= 1e-4


def test_compensation_brings_the_mlps_closer_to_dense(s):
    """MLP only: the dense, per-expert and shared ridge folds are closer
    to the dense model on held-out tokens than plain channel removal."""
    dense = _port_logits(s, s["pt_params"], s["cfg"])
    errs = {}
    for comp in (True, False):
        pp, pcfg, _ = corp_prune(s["pt_model"], s["pt_params"],
                                 s["pt_calib"],
                                 PruneConfig(0.5, 0.0, compensate=comp))
        errs[comp] = rel(_port_logits(s, pp, pcfg), dense)
    assert errs[True] < errs[False], errs
