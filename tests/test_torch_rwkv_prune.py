"""The port's RWKV pruning against the JAX package: rwkv6-3b-reduced (fp32),
whose only prunable units are the channel mixes (``rwkv_mlp``): ranked on
``wv``, compensated through ``wv`` and a ``bv_comp`` bias added before the
receptance gate.

Same numpy-made weights and the reference's Markov calibration tokens
(``torch_parity.lm_prune_setup``) in both packages, on the CPU. Statistics
are held to rtol 1e-4, keep sets must be equal, pruned logits on held-out
tokens within 1e-3 of JAX's (relative error). The port's template of a
pruned RWKV holds ``bv_comp``, so its serve CLI serves the bias that the
JAX CLI's template drops.
"""
from __future__ import annotations

import dataclasses

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
from repro.data import calib_stream as jax_calib_stream  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.core import CalibrationEngine, PruneConfig  # noqa: E402
from repro_torch.core import corp_prune, corp_prune_streamed  # noqa: E402
from repro_torch.core import discover_units  # noqa: E402
from repro_torch.core import pruner as pruner_mod  # noqa: E402
from repro_torch.data import calib_stream  # noqa: E402
from repro_torch.launch import prune as pt_prune  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from torch_parity import lm_logits, lm_prune_setup, rel  # noqa: E402

UNIT = "seg0/p0/rwkv_mlp"
SERVE = ["--device", "cpu", "--trace", "3", "--slots", "2", "--max-len",
         "40", "--prompt-range", "6,16", "--gen-range", "2,6"]

_JAX = {}


@pytest.fixture(scope="module")
def s():
    return lm_prune_setup("rwkv6-3b", seed=23)


def _jax_prune(s, compensate=True):
    if compensate not in _JAX:
        out = jax_corp_prune(s["jax_model"], s["jax_params"], s["jax_calib"],
                             JaxPC(0.5, 0.5, compensate=compensate))
        _JAX[compensate] = out + (lm_logits(jax_build(out[1]), out[0],
                                            s["jax_held"]),)
    return _JAX[compensate]


def _port_logits(s, params, cfg):
    with torch.no_grad():
        return lm_logits(pt_build(cfg), params, s["pt_held"])


def _close(got, want, rtol=1e-4, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, err_msg
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=err_msg)


def test_units_and_token_stream_equal_jax(s):
    units = discover_units(s["cfg"])
    assert [dataclasses.asdict(u) for u in units] == \
        [dataclasses.asdict(u) for u in jax_units(s["jcfg"])]
    assert [(u.kind, u.d_hidden, u.param_key) for u in units] == \
        [("rwkv_mlp", 256, "mlp")]
    for a, b in zip(s["jax_calib"](), s["pt_calib"]()):
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      np.asarray(a["tokens"]))


def test_taps_match_jax(s):
    """The channel mix's ``h`` is RWKV's only tap (the time mix has none),
    stacked (layers, B, T, d_ff)."""
    batch = next(iter(s["pt_calib"]()))
    jt, pt = {}, {}
    s["jax_model"].apply(s["jax_params"],
                         {"tokens": jnp.asarray(batch["tokens"].numpy())},
                         taps=jt)
    s["pt_model"].apply(s["pt_params"], batch, taps=pt)
    assert sorted(pt) == sorted(jt) == ["seg0/p0/h"]
    assert pt["seg0/p0/h"].shape == (2, 8, 32, 256)
    _close(pt["seg0/p0/h"].numpy(), np.asarray(jt["seg0/p0/h"]))


def test_pass1_sums_and_keep_sets_match_jax(s):
    want = JaxEngine(s["jax_model"], jax_units(s["jcfg"]), phase=1) \
        .run(s["jax_params"], s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], discover_units(s["cfg"]),
                            phase=1).run(s["pt_params"], s["pt_calib"]())
    assert sorted(got[UNIT]) == sorted(want[UNIT]) == ["n", "na", "s1",
                                                       "s2"]
    for k, w in want[UNIT].items():
        _close(got[UNIT][k].numpy(), w, err_msg=k)
    wv = np.asarray(s["np"]["seg0"]["p0"]["mlp"]["wv"])
    for policy in ("combined", "act", "mag", "active"):
        keep, prune = jax_ranking.rank_mlp(want[UNIT], wv, 128, policy)
        plan = pruner_mod._rank(discover_units(s["cfg"]), got,
                                s["pt_params"],
                                PruneConfig(0.5, 0.5, rank_policy=policy))
        np.testing.assert_array_equal(plan[UNIT][0], keep, err_msg=policy)
        np.testing.assert_array_equal(plan[UNIT][1], prune, err_msg=policy)


@pytest.mark.parametrize("compensate", [True, False])
def test_pruned_logits_match_jax(s, compensate):
    jp, jcfg, jrep, want = _jax_prune(s, compensate)
    pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                               PruneConfig(0.5, 0.5, compensate=compensate))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert rep["traversals"] == jrep["traversals"] == 1
    got = _port_logits(s, pp, pcfg)
    assert np.isfinite(got).all() and rel(got, want) <= 1e-3
    d = rep["units"][UNIT]
    assert (d["j_star"] <= d["j_uncomp"] * (1 + 1e-5)).all()
    _close(d["j_star"], np.asarray(jrep["units"][UNIT]["j_star"]),
           rtol=1e-3)
    mlp = pp["seg0"]["p0"]["mlp"]
    assert tuple(mlp["wk"].shape) == (2, 64, 128)
    assert tuple(mlp["wv"].shape) == (2, 128, 64)
    assert ("bv_comp" in mlp) == compensate and "bd" not in mlp
    if compensate:
        assert mlp["bv_comp"].dtype == torch.float32
        _close(mlp["bv_comp"].numpy(),
               np.asarray(jp["seg0"]["p0"]["mlp"]["bv_comp"]), rtol=1e-3)


def test_compensation_beats_plain_pruning(s):
    dense = _port_logits(s, s["pt_params"], s["cfg"])
    errs = {c: rel(_port_logits(s, *corp_prune(
        s["pt_model"], s["pt_params"], s["pt_calib"],
        PruneConfig(0.5, 0.5, compensate=c))[:2]), dense)
        for c in (True, False)}
    assert errs[True] < errs[False], errs


@pytest.mark.parametrize("mode", ["one_traversal", "streamed"])
def test_other_modes_equal_two_pass_and_jax(s, mode):
    """No attention unit, so one traversal speculates nothing and takes the
    single pass-1 traversal; streamed CORP is one group."""
    base, _, _ = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                            PruneConfig(0.5, 0.5))
    if mode == "one_traversal":
        pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"],
                                   s["pt_calib"], PruneConfig(0.5, 0.5),
                                   one_traversal=True)
        jp, jcfg, jrep = jax_corp_prune(s["jax_model"], s["jax_params"],
                                        s["jax_calib"], JaxPC(0.5, 0.5),
                                        one_traversal=True)
        assert "speculative" not in rep
    else:
        pp, pcfg, rep = corp_prune_streamed(
            s["pt_model"], s["pt_params"], s["pt_calib"],
            PruneConfig(0.5, 0.5), unit_group_size=1)
        jp, jcfg, jrep = jax_streamed(s["jax_model"], s["jax_params"],
                                      s["jax_calib"], JaxPC(0.5, 0.5),
                                      unit_group_size=1)
        assert rep["groups"] == jrep["groups"] == 1
    assert rep["traversals"] == jrep["traversals"] == 1
    fb, fp = interop.flatten(base), interop.flatten(pp)
    assert fb.keys() == fp.keys() and all(torch.equal(fb[k], fp[k])
                                          for k in fb)
    assert rel(_port_logits(s, pp, pcfg),
               lm_logits(jax_build(jcfg), jp, s["jax_held"])) <= 1e-4


def test_pruned_template_has_a_zero_bv_comp_that_the_dense_lacks(s):
    dense = s["pt_model"].init(torch.Generator().manual_seed(0), "cpu")
    assert "bv_comp" not in dense["seg0"]["p0"]["mlp"]
    pruned = pt_build(s["cfg"].pruned(0.5, 0.5)).init(
        torch.Generator().manual_seed(0), "cpu")
    b = pruned["seg0"]["p0"]["mlp"]["bv_comp"]
    assert tuple(b.shape) == (2, 64) and b.dtype == torch.float32
    assert not b.any()


def test_cli_checkpoint_loads_in_jax_and_serves_in_the_port(s, tmp_path):
    """``--calib-seq 16 --out`` on rwkv6-3b-reduced: JAX's restore into its
    own pruned template drops ``bv_comp``; into one with the leaf it gives
    the port's logits. The port's serve CLI serves it with the bias."""
    out = str(tmp_path / "pruned")
    res = pt_prune.main(["--arch", "rwkv6-3b-reduced", "--calib", "16",
                         "--calib-batch", "8", "--calib-seq", "16",
                         "--device", "cpu", "--out", out])
    pcfg = res["pruned_cfg"]
    want = _port_logits(s, res["pruned_params"], pcfg)
    jcfg = s["jcfg"].pruned(0.5, 0.5)
    jtmpl = jax_build(jcfg).init(jax.random.PRNGKey(0))
    dropped, _ = jax_restore(out, 0, jtmpl)
    assert "bv_comp" not in dropped["seg0"]["p0"]["mlp"]
    jtmpl["seg0"]["p0"]["mlp"]["bv_comp"] = jnp.zeros((2, 64), jnp.float32)
    jparams, _ = jax_restore(out, 0, jtmpl)
    _close(lm_logits(jax_build(jcfg), jparams, s["jax_held"]), want)
    served = pt_serve.main(["--arch", "rwkv6-3b-reduced", "--sparsity",
                            "0.5", "--ckpt-in", out] + SERVE)
    assert len(served["completions"]) == 3
    assert torch.equal(served["params"]["seg0"]["p0"]["mlp"]["bv_comp"],
                       res["pruned_params"]["seg0"]["p0"]["mlp"]["bv_comp"])
    np.testing.assert_array_equal(
        _port_logits(s, served["params"], served["model"].cfg), want)


def test_restore_refuses_a_leaf_the_template_has_no_slot_for(s, tmp_path):
    """The pruned template's slots are ``mlp/bd`` and ``mlp/bv_comp`` only:
    any other leaf a checkpoint adds is still named and refused."""
    pp, _, _ = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                          PruneConfig(0.5, 0.5))
    tree = jax.tree.map(np.asarray, interop.to_numpy(pp))
    tree["seg0"]["p0"]["mlp"]["extra"] = np.zeros(3, np.float32)
    jax_save(str(tmp_path), 0, tree)
    with pytest.raises(ValueError, match="seg0/p0/mlp/extra"):
        pt_serve.main(["--arch", "rwkv6-3b-reduced", "--sparsity", "0.5",
                       "--ckpt-in", str(tmp_path)] + SERVE)
    like = pt_build(s["cfg"].pruned(0.5, 0.5)).init(
        torch.Generator().manual_seed(0), "cpu")
    del tree["seg0"]["p0"]["mlp"]["extra"], tree["seg0"]["p0"]["mlp"]["wr"]
    jax_save(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="no leaf seg0/p0/mlp/wr"):
        restore_checkpoint(str(tmp_path), 1, like,
                           zero_if_absent=pt_serve.COMPENSATION_LEAVES)
