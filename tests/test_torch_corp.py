"""The port's CORP pipeline against the JAX reference on a reduced DeiT-Base.

Same weights (carried across by interop), same numpy calibration images:
  * pass-1 and pass-2 statistics trees match (rtol 1e-4: fp32 sums in
    another order);
  * the keep-sets are identical (ranking is the same numpy code);
  * the pruned models agree on a held-out batch to a relative error of
    1e-3, with and without compensation. Folded weights are not compared:
    the Cholesky solves run in another order, and the class-1 SVD fold is
    unique only up to paired signs, so only outputs are comparable.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.core import CalibrationEngine as JaxEngine  # noqa: E402
from repro.core import PruneConfig as JaxPC  # noqa: E402
from repro.core import corp_prune as jax_corp_prune  # noqa: E402
from repro.core import discover_units as jax_units  # noqa: E402
from repro.core import ranking as jax_ranking  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import CalibrationEngine, PruneConfig  # noqa: E402
from repro_torch.core import corp_prune, discover_units  # noqa: E402
from repro_torch.core import ranking  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from torch_parity import (images, jax_params, mlp_rank_args,  # noqa: E402
                          port_cfg)

N_BATCHES, B = 3, 4


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("deit-base"))
    params = jax_params(cfg, seed=7)
    batches = [images(cfg, B=B, seed=100 + i) for i in range(N_BATCHES)]
    return {
        "cfg": cfg, "params": params, "batches": batches,
        "jax_model": jax_build(cfg),
        "jax_params": jax.tree.map(jnp.asarray, params),
        "jax_calib": lambda: ({"images": jnp.asarray(x)} for x in batches),
        "pt_model": pt_build(port_cfg(cfg)),
        "pt_params": interop.from_numpy(params, device="cpu"),
        "pt_calib": lambda: ({"images": torch.from_numpy(x)}
                             for x in batches),
    }


def _assert_tree_close(got, want, rtol=1e-4):
    for unit, stats in want.items():
        for k, w in stats.items():
            g = got[unit][k].numpy()
            w = np.asarray(w)
            assert g.shape == w.shape, (unit, k)
            np.testing.assert_allclose(
                g, w, rtol=rtol, atol=rtol * float(np.abs(w).max()),
                err_msg=f"{unit}/{k}")


@pytest.fixture(scope="module")
def pass1(setup):
    s = setup
    want = JaxEngine(s["jax_model"], jax_units(s["cfg"]), phase=1) \
        .run(s["jax_params"], s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], discover_units(port_cfg(s["cfg"])),
                            phase=1).run(s["pt_params"], s["pt_calib"]())
    return want, got


def test_pass1_statistics_match(pass1):
    want, got = pass1
    assert sorted(got) == sorted(want)
    _assert_tree_close(got, want)


def test_keep_sets_identical(setup, pass1):
    want, got = pass1
    w2 = setup["params"]["seg0"]["p0"]["mlp"]["wd"]
    for u in jax_units(setup["cfg"]):
        if u.kind == "mlp":
            a = jax_ranking.rank_mlp(want[u.name], w2, 128)
            b = ranking.rank_mlp(*mlp_rank_args(
                {k: v.numpy() for k, v in got[u.name].items()}, w2), 128)
        else:
            a = jax_ranking.rank_attn(want[u.name], 8)
            b = ranking.rank_attn({k: v.numpy() for k, v in
                                   got[u.name].items()}, 8)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=u.name)


def test_pass2_statistics_match(setup, pass1):
    want1, _ = pass1
    units = jax_units(setup["cfg"])
    plan = {u.name: jax_ranking.rank_attn(want1[u.name], 8)
            for u in units if u.kind == "attn"}
    want = JaxEngine(setup["jax_model"], units, phase=2, plan=plan) \
        .run(setup["jax_params"], setup["jax_calib"]())
    got = CalibrationEngine(setup["pt_model"],
                            discover_units(port_cfg(setup["cfg"])),
                            phase=2, plan=plan) \
        .run(setup["pt_params"], setup["pt_calib"]())
    assert sorted(got) == sorted(want)
    _assert_tree_close(got, want)


@pytest.mark.parametrize("compensate", [True, False])
def test_pruned_model_outputs_match_jax(setup, compensate):
    s = setup
    jp, jcfg, _ = jax_corp_prune(s["jax_model"], s["jax_params"],
                                 s["jax_calib"],
                                 JaxPC(0.5, 0.5, compensate=compensate))
    pp, pcfg, report = corp_prune(s["pt_model"], s["pt_params"],
                                  s["pt_calib"],
                                  PruneConfig(0.5, 0.5, compensate=compensate))
    assert (pcfg.eff_d_ff, pcfg.eff_qk) == (jcfg.eff_d_ff, jcfg.eff_qk)
    assert interop.flatten(interop.to_numpy(pp)).keys() \
        == interop.flatten(jax.tree.map(np.asarray, jp)).keys()
    held_out = images(s["cfg"], B=5, seed=999)
    want = np.asarray(jax_build(jcfg).apply(
        jp, {"images": jnp.asarray(held_out)}))
    got = pt_build(pcfg).apply(pp, {"images": torch.from_numpy(held_out)}) \
        .numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-3, rel
    for unit, d in report["units"].items():
        assert np.all(d["j_star"] <= d["j_uncomp"] * (1 + 1e-5)
                      + 1e-6), unit


def test_corp_prune_leaves_the_dense_params_alone(setup):
    s = setup
    before = interop.to_numpy(s["pt_params"])
    corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
               PruneConfig(0.5, 0.5))
    after = interop.to_numpy(s["pt_params"])
    for k, v in interop.flatten(before).items():
        np.testing.assert_array_equal(interop.flatten(after)[k], v)
