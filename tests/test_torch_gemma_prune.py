"""The port's class-3 pruning of gemma3-1b against the JAX package: qk-norm
attention units (a real diagonal compensator per kept rotary pair, folded
into the per-head qk-norm scales), GELU GLU MLP units, stacked and
unrolled.

gemma3-1b-reduced (fp32) at 6 layers (one scanned segment, as JAX's
reduced config) here, and at 8 (the segment plus 2 unrolled layers, the
shape of the full model's 4 x 6 + 2) in
``test_torch_gemma_prune_unrolled.py``, which runs this file's cases that
take the ``s`` fixture, on the same numpy-made weights and the
reference's own Markov calibration tokens (``torch_parity.lm_prune_setup``)
in both packages, on the CPU; the JAX package takes its plain paths there,
as its own tests do. Statistics are held to rtol 1e-4 (fp32 sums in
another order; an activity count within one token), keep sets must be
equal, and pruned models are compared through their logits on held-out
tokens (relative error): <= 1e-3 against JAX's ``corp_prune`` (the ridge
solves of two libraries), <= 1e-4 between the port's own modes, which
reduce the same taps.
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
from repro.core import discover_units as jax_units  # noqa: E402
from repro.core import ranking as jax_ranking  # noqa: E402
from repro.core import solve as jax_solve  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro.serve import synthetic_trace as jax_trace  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import CalibrationEngine, PruneConfig  # noqa: E402
from repro_torch.core import corp_prune, discover_units  # noqa: E402
from repro_torch.core import ranking, solve  # noqa: E402
from repro_torch.core import pruner as pruner_mod  # noqa: E402
from repro_torch.core import stats as stats_mod  # noqa: E402
from repro_torch.launch import prune as pt_prune  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from torch_parity import lm_logits, lm_prune_setup, rel  # noqa: E402

KEEP_PAIRS = 4            # of 8 rotary pairs per head at sparsity 0.5
LAYERS = [6]              # 8 layers: test_torch_gemma_prune_unrolled.py
_SETUPS, _JAX = {}, {}


def _s(n_layers):
    if n_layers not in _SETUPS:
        _SETUPS[n_layers] = lm_prune_setup("gemma3-1b", seed=21,
                                           n_layers=n_layers)
    return _SETUPS[n_layers]


@pytest.fixture(scope="module", params=LAYERS)
def s(request):
    return _s(request.param)


def _attn_units(units):
    return [u for u in units if u.kind == "attn"]


def _jax_prune(s, **kw):
    """JAX's ``corp_prune`` of the setup, once per keyword set, as
    (params, config, report, logits)."""
    key = (s["cfg"].n_layers,) + tuple(sorted(kw.items()))
    if key not in _JAX:
        kw = dict(kw)
        pc = JaxPC(0.5, 0.5, compensate=kw.pop("compensate", True))
        out = jax_corp_prune(s["jax_model"], s["jax_params"], s["jax_calib"],
                             pc, **kw)
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
    """Leaf by leaf; an activity count ``na`` (tokens with |h| > 1e-2) may
    differ by one token where an activation lies within fp32 rounding of
    the threshold (GELU GLU activations put a few there)."""
    g = interop.flatten(interop.to_numpy(got))
    w = interop.flatten(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    for k in w:
        if k.endswith("/na"):
            assert g[k].shape == w[k].shape, k
            assert np.abs(g[k] - w[k]).max() <= 1, k
        else:
            _close(g[k], w[k], rtol, k)


def _check_j(report):
    for unit, d in report["units"].items():
        js, ju = np.asarray(d["j_star"]), np.asarray(d["j_uncomp"])
        assert (js <= ju * (1 + 1e-5) + 1e-6).all(), unit


# ---------------------------------------------------------------------------
# units, solve and fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_real_solve_and_fold_match_jax(seed):
    """Seeded real PSD systems batched over (layer, group) rows, as the
    fold solves them; the Q and K scales multiply to 1 + m, the sign on
    the Q side."""
    rng = np.random.default_rng(seed)
    R, dp = 6, 5
    z = rng.standard_normal((R, 40, dp)).astype(np.float32)
    Gd = np.einsum("rts,rtu->rsu", z, z).astype(np.float32)
    hd = rng.standard_normal((R, dp)).astype(np.float32)
    t2 = (hd ** 2).sum(-1).astype(np.float32) * 3.0
    lam = (1e-4 * np.einsum("rii->ri", Gd).mean(-1)).astype(np.float32)
    want = jax.vmap(jax_solve.solve_diag_real)(
        jnp.asarray(Gd), jnp.asarray(hd), jnp.asarray(t2), jnp.asarray(lam))
    got = solve.solve_diag_real(*(torch.from_numpy(a)
                                  for a in (Gd, hd, t2, lam)))
    for k in ("m", "j_star", "j_uncomp", "rho2"):
        _close(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    m = torch.from_numpy(np.concatenate(
        [got["m"].numpy(), [[-3.0, -1.0, 0.0, 0.5, -0.2]]]).astype(
            np.float32))
    fq, fk = solve.fold_diag_real(m)
    jq, jk = jax.vmap(jax_solve.fold_diag_real)(jnp.asarray(m.numpy()))
    _close(fq.numpy(), np.asarray(jq))
    _close(fk.numpy(), np.asarray(jk))
    np.testing.assert_allclose((fq * fk).numpy(), (1 + m).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert (fk >= 0).all()


# ---------------------------------------------------------------------------
# pass 1, ranking, pass 2, the speculative sums (class 3, stacked and not)
# ---------------------------------------------------------------------------

_PASS1 = {}


def _pass1(s):
    L = s["cfg"].n_layers
    if L not in _PASS1:
        want = JaxEngine(s["jax_model"], jax_units(s["jcfg"]), phase=1) \
            .run(s["jax_params"], s["jax_calib"]())
        got = CalibrationEngine(s["pt_model"], discover_units(s["cfg"]),
                                phase=1).run(s["pt_params"], s["pt_calib"]())
        _PASS1[L] = (want, got)
    return _PASS1[L]


def test_pass1_sums_match_jax(s):
    want, got = _pass1(s)
    assert got["seg0/p0/attn"]["rank"].shape == (1, 1, 8)   # (L, G, pairs)
    if s["cfg"].n_layers == 8:                  # an unrolled unit: no L
        assert got["seg1/l1/attn"]["rank"].shape == (1, 8)
        assert got["seg1/l1/mlp"]["s2"].shape == (256, 256)
        assert got["seg1/l1/mlp"]["n"].shape == ()
    _close_tree(got, want)


def _plan(s):
    want, got = _pass1(s)
    pc = PruneConfig(0.5, 0.5)
    return pruner_mod._rank(discover_units(s["cfg"]), got, s["pt_params"],
                            pc), want


def test_keep_sets_identical_to_jax(s):
    plan, want = _plan(s)
    for u in discover_units(s["cfg"]):
        blk = s["np"][u.seg][u.layer_key][u.param_key]
        ref = jax_ranking.rank_mlp(want[u.name], blk["wd"], 128) \
            if u.kind == "mlp" \
            else jax_ranking.rank_attn(want[u.name], KEEP_PAIRS)
        for a, b in zip(plan[u.name], ref):
            np.testing.assert_array_equal(a, b, err_msg=u.name)
    if s["cfg"].n_layers == 8:
        assert plan["seg1/l0/attn"][0].shape == (1, KEEP_PAIRS)
        assert plan["seg1/l0/mlp"][0].shape == (128,)


def _attn_plan(s):
    plan, _ = _plan(s)
    return {u.name: plan[u.name] for u in _attn_units(discover_units(
        s["cfg"]))}


def test_class3_pass2_statistics_match_jax(s):
    plan = _attn_plan(s)
    want = JaxEngine(s["jax_model"], jax_units(s["jcfg"]), phase=2,
                     plan=plan).run(s["jax_params"], s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], discover_units(s["cfg"]),
                            phase=2, plan=plan) \
        .run(s["pt_params"], s["pt_calib"]())
    g = got["seg0/p0/attn"]
    assert g["G"].shape == (1, 1, KEEP_PAIRS, KEEP_PAIRS)
    assert g["G"].dtype == g["h"].dtype == torch.float32
    if s["cfg"].n_layers == 8:
        assert got["seg1/l0/attn"]["G"].shape == (1, KEEP_PAIRS, KEEP_PAIRS)
    _close_tree(got, want)


def _spec_plan(s, margin=0.25):
    _, got = _pass1(s)
    return {u.name: ranking.candidate_attn(
        {k: v.numpy() for k, v in got[u.name].items()}, KEEP_PAIRS, margin)
        for u in _attn_units(discover_units(s["cfg"]))}


def test_speculative_sums_match_jax(s):
    spec_plan = _spec_plan(s)
    want = JaxEngine(s["jax_model"], jax_units(s["jcfg"]), phase="1+2",
                     spec_plan=spec_plan).run(s["jax_params"],
                                              s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], discover_units(s["cfg"]),
                            phase="1+2", spec_plan=spec_plan) \
        .run(s["pt_params"], s["pt_calib"]())
    sp = got["p2spec"]["seg0/p0/attn"]
    assert sp["Gc"].shape == (1, 1, 5, 5) and sp["Gc"].dtype == \
        torch.complex64
    _close_tree(got, want)


def test_spec_reconstruct_class3_equals_the_ports_pass2(s):
    spec_plan = _spec_plan(s)
    plan = _attn_plan(s)
    units = discover_units(s["cfg"])
    spec = CalibrationEngine(s["pt_model"], units, phase="1+2",
                             spec_plan=spec_plan) \
        .run(s["pt_params"], s["pt_calib"]())["p2spec"]
    want = CalibrationEngine(s["pt_model"], units, phase=2, plan=plan) \
        .run(s["pt_params"], s["pt_calib"]())
    for u in _attn_units(units):
        keep = plan[u.name][0]
        assert ranking.covers(spec_plan[u.name], keep), u.name
        rec = stats_mod.spec_reconstruct(
            {k: v.numpy() for k, v in spec[u.name].items()},
            spec_plan[u.name], keep, u)
        for k, w in want[u.name].items():
            assert rec[k].dtype == np.float32, k
            _close(rec[k], w.numpy(), err_msg=f"{u.name} {k}")


# ---------------------------------------------------------------------------
# corp_prune, two-pass and one traversal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compensate", [True, False])
def test_pruned_logits_match_jax(s, compensate):
    """The fold: kept dims gathered, the per-pair scales multiplied into
    per-head qk-norm scales, the kept rope pairs; its params and logits
    equal JAX's."""
    pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                               PruneConfig(0.5, 0.5, compensate=compensate))
    jp, jcfg, jrep, want = _jax_prune(s, compensate=compensate)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert (pcfg.eff_d_ff, pcfg.eff_qk) == (128, 8)
    mixer = pp["seg0"]["p0"]["mixer"]
    assert mixer["q_scale"].shape == (1, 4, 8)           # (L, H, qk_kept)
    assert mixer["k_scale"].shape == (1, 1, 8)
    if s["cfg"].n_layers == 8:
        assert pp["seg1"]["l0"]["mixer"]["q_scale"].shape == (4, 8)
        assert pp["seg1"]["l0"]["mlp"]["wd"].shape == (128, 64)
    assert rel(_port_logits(s, pp, pcfg), want) <= 1e-3
    _close_tree(pp, jp, rtol=1e-3)
    assert sorted(rep["units"]) == sorted(jrep["units"])
    for u, d in jrep["units"].items():
        for k, v in d.items():
            assert np.shape(rep["units"][u][k]) == np.shape(v), (u, k)
    _check_j(rep)


def test_compensated_qk_scales_multiply_to_one_plus_m(s):
    """Per kept pair, the folded Q and K scales over the old ones multiply
    to 1 + m; uncompensated, they are the old scales' kept dims."""
    pp, _, _ = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                          PruneConfig(0.5, 0.5))
    pu, _, _ = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                          PruneConfig(0.5, 0.5, compensate=False))
    keep = _attn_plan(s)["seg0/p0/attn"][0][0, 0]         # (pairs,)
    dims = np.stack([2 * keep, 2 * keep + 1], -1).reshape(-1)
    old = s["np"]["seg0"]["p0"]["mixer"]
    ratio_q = pp["seg0"]["p0"]["mixer"]["q_scale"][0].numpy() \
        / old["q_scale"][0][dims]
    ratio_k = pp["seg0"]["p0"]["mixer"]["k_scale"][0].numpy() \
        / old["k_scale"][0][dims]
    prod = ratio_q * ratio_k                               # (H, 2 pairs)
    np.testing.assert_allclose(prod[:, 0::2], prod[:, 1::2], rtol=1e-5)
    assert not np.allclose(prod, 1.0)
    np.testing.assert_array_equal(
        pu["seg0"]["p0"]["mixer"]["q_scale"][0].numpy(),
        np.broadcast_to(old["q_scale"][0][dims], (4, 8)))


@pytest.mark.parametrize("margin,traversals", [(1.0, 1), (0.0, None)])
def test_one_traversal_matches_jax_and_two_pass(s, margin, traversals):
    """Margin 1.0: every unit's candidates are all its pairs, a sure hit in
    one traversal; margin 0: whatever escaped takes a targeted pass 2. The
    result is the two-pass prune either way."""
    two, tcfg, _ = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                              PruneConfig(0.5, 0.5))
    pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                               PruneConfig(0.5, 0.5), one_traversal=True,
                               spec_margin=margin)
    sp = rep["speculative"]
    n_attn = len(_attn_units(discover_units(s["cfg"])))
    assert len(sp["hits"]) + len(sp["misses"]) == n_attn
    if traversals is not None:
        assert rep["traversals"] == traversals and not sp["misses"]
    else:
        assert rep["traversals"] == (2 if sp["misses"] else 1)
    assert rel(_port_logits(s, pp, pcfg), _port_logits(s, two, tcfg)) \
        <= 1e-4
    if margin == 1.0:
        _, _, jrep, want = _jax_prune(s, one_traversal=True, spec_margin=1.0)
        assert jrep["traversals"] == 1
        assert rel(_port_logits(s, pp, pcfg), want) <= 1e-3
    _check_j(rep)


# ---------------------------------------------------------------------------
# the prune CLI and serving the pruned checkpoint of either package
# ---------------------------------------------------------------------------

def _jax_template_with_head_scales(jcfg):
    """JAX's pruned template with the slots JAX's own lacks: ``mlp/bd``
    and the per-head qk-norm scales the class-3 fold writes."""
    tmpl = jax_build(jcfg).init(jax.random.PRNGKey(0))
    H, Hkv, n = jcfg.n_heads, jcfg.n_kv_heads, jcfg.eff_qk
    for name, seg in tmpl.items():
        if not name.startswith("seg"):
            continue
        for blk in seg.values():
            lead = blk["mixer"]["q_scale"].shape[:-1]
            blk["mixer"]["q_scale"] = jnp.ones(lead + (H, n), jnp.float32)
            blk["mixer"]["k_scale"] = jnp.ones(lead + (Hkv, n), jnp.float32)
            blk["mlp"]["bd"] = jnp.zeros(lead + (jcfg.d_model,),
                                         jnp.float32)
    return tmpl


def test_cli_checkpoint_restores_in_the_port_not_in_jax(tmp_path):
    """``launch.prune --arch gemma3-1b-reduced --calib-seq 16 --out``:
    JAX's pruned template cannot take the per-head qk-norm scales (its
    restore asserts on the shape); given a template with their shapes,
    JAX's model computes the port's logits from the checkpoint."""
    s = _s(6)
    out = str(tmp_path / "pruned")
    res = pt_prune.main(["--arch", "gemma3-1b-reduced", "--calib", "16",
                         "--calib-batch", "8", "--calib-seq", "16",
                         "--device", "cpu", "--out", out])
    pcfg = res["pruned_cfg"]
    assert (pcfg.eff_d_ff, pcfg.eff_qk) == (128, 8)
    jcfg = s["jcfg"].pruned(0.5, 0.5)
    with pytest.raises(AssertionError, match="_scale"):
        jax_restore(out, 0, jax_build(jcfg).init(jax.random.PRNGKey(0)))
    jparams, extra = jax_restore(out, 0,
                                 _jax_template_with_head_scales(jcfg))
    assert extra["config"] == pcfg.name
    want = _port_logits(s, res["pruned_params"], pcfg)
    got = lm_logits(jax_build(jcfg), jparams, s["jax_held"])
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serve_cli_serves_a_pruned_checkpoint_of_either_package(
        tmp_path, writer):
    """``launch.serve --sparsity 0.5 --ckpt-in`` restores the per-head
    qk-norm scales and ``mlp/bd`` of a pruned gemma written by JAX's
    ``corp_prune`` + ``save_checkpoint`` or by the port's CLI, and its
    streams equal the JAX engine's on the same pruned params (which JAX's
    own serve CLI cannot restore)."""
    s = _s(6)
    jcfg = s["jcfg"].pruned(0.5, 0.5)
    if writer == "jax":
        jp = _jax_prune(s)[0]
        jax_save(str(tmp_path), 0, jax.tree.map(np.asarray, jp),
                 extra={"config": jcfg.name})
    else:
        pt_prune.main(["--arch", "gemma3-1b-reduced", "--calib", "16",
                       "--calib-batch", "8", "--calib-seq", "16",
                       "--device", "cpu", "--out", str(tmp_path)])
        jp = jax_restore(str(tmp_path), 0,
                         _jax_template_with_head_scales(jcfg))[0]
    served = pt_serve.main(
        ["--arch", "gemma3-1b-reduced", "--sparsity", "0.5", "--ckpt-in",
         str(tmp_path), "--device", "cpu", "--trace", "4", "--slots", "2",
         "--max-len", "48", "--prompt-range", "6,20", "--gen-range",
         "6,14"])
    mixer = served["params"]["seg0"]["p0"]["mixer"]
    assert mixer["q_scale"].shape == (1, 4, 8)
    np.testing.assert_array_equal(
        mixer["q_scale"].numpy(), np.asarray(jp["seg0"]["p0"]["mixer"]
                                             ["q_scale"]))
    jeng = JaxServe(jax_build(jcfg), jax.tree.map(jnp.asarray, jp),
                    n_slots=2, max_len=48)
    want = jeng.run(jax_trace(4, jcfg.vocab_size, seed=0,
                              prompt_range=(6, 20), gen_range=(6, 14)))
    assert [c.tokens.tolist() for c in served["completions"]] == \
        [c.tokens.tolist() for c in want]
