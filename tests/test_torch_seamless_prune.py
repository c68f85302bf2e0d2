"""The port's CORP on seamless-m4t-large-v2 (the encoder-decoder) against
the JAX package: the calibration stream of frames and tokens, the units
(encoder and decoder attention and MLPs, and the decoder's class-1 cross
attention on ``cross_q``/``cross_k``), their statistics, the pruned
model, the other prune modes and the CLI's checkpoint served back.

seamless-m4t-large-v2-reduced in fp32 on the CPU, the same numpy-made
weights and the reference's calibration stream (Markov tokens, Gaussian
frames; 3 batches of 8 x 32) in both packages. Statistics are held to
rtol 1e-5 and atol 1e-5 of each array's scale (its largest magnitude, at
least 1); pruned logits on a held-out batch to 1e-4; bf16 taps and the
streamed prune to the port's two-pass prune within 1e-2 and 1e-4
(relative norm); the CLI's checkpoint, restored, within 1e-3.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.core import CalibrationEngine as JaxEngine  # noqa: E402
from repro.core import PruneConfig as JaxPC  # noqa: E402
from repro.core import corp_prune as jax_corp_prune  # noqa: E402
from repro.core import discover_units as jax_units  # noqa: E402
from repro.core import ranking as jax_ranking  # noqa: E402
from repro.core import stats as jax_stats  # noqa: E402
from repro.data import calib_stream as jax_stream  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import CalibrationEngine, PruneConfig  # noqa: E402
from repro_torch.core import corp_prune, corp_prune_streamed  # noqa: E402
from repro_torch.core import discover_units  # noqa: E402
from repro_torch.core import stats as stats_mod  # noqa: E402
from repro_torch.data import calib_stream  # noqa: E402
from repro_torch.launch import prune as pt_prune  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from torch_parity import jax_params, lm_cfgs, rel, to_port_cfg  # noqa: E402

ARCH = "seamless-m4t-large-v2"
ENC_ATTN, ENC_MLP = "enc/p0/attn", "enc/p0/mlp"
DEC_ATTN, CROSS, DEC_MLP = "dec/p0/attn", "dec/p0/cross", "dec/p0/mlp"
ATTN_UNITS = (ENC_ATTN, DEC_ATTN, CROSS)
RTOL, ATOL = 1e-5, 1e-5
_JAX = {}


def _close(got, want, err_msg="", rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * scale, err_msg=err_msg)


@pytest.fixture(scope="module")
def s():
    jcfg, pcfg = lm_cfgs(arch=ARCH)
    params = jax_params(jcfg, seed=13)
    rng = np.random.default_rng(13)
    held = {"frames": rng.standard_normal((3, 20, 64)).astype(np.float32),
            "tokens": rng.integers(0, jcfg.vocab_size, (3, 14))
            .astype(np.int32)}
    kw = dict(n_samples=24, batch=8, seq=32)
    return {"jcfg": jcfg, "cfg": pcfg, "np": params,
            "jax_model": jax_build(jcfg),
            "jax_params": jax.tree.map(jnp.asarray, params),
            "pt_model": pt_build(pcfg),
            "pt_params": interop.from_numpy(params, device="cpu"),
            "jax_calib": jax_stream(jcfg, **kw),
            "pt_calib": calib_stream(pcfg, device="cpu", **kw),
            "jax_held": {k: jnp.asarray(v) for k, v in held.items()},
            "pt_held": {k: torch.from_numpy(v) for k, v in held.items()}}


def _jax_logits(cfg, params, s):
    return np.asarray(jax_build(cfg).apply(params, s["jax_held"])[0])


def _port_logits(cfg, params, s):
    with torch.no_grad():
        return pt_build(cfg).apply(params, s["pt_held"])[0].numpy()


def _jax_prune(s, **kw):
    """JAX's two-pass ``corp_prune`` at 0.5/0.5 (or ``kw``'s sparsities
    and streaming dtype), once per keyword set: (params, config, report,
    held-out logits)."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX:
        pc = {"mlp_sparsity": 0.5, "attn_sparsity": 0.5, **kw}
        dtype = pc.pop("stats_dtype", "float32")
        out = jax_corp_prune(s["jax_model"], s["jax_params"], s["jax_calib"],
                             JaxPC(**pc), stats_dtype=dtype)
        _JAX[key] = out + (_jax_logits(out[1], out[0], s),)
    return _JAX[key]


def test_calib_stream_is_jax_bit_for_bit(s):
    """Tokens from the reference's Markov chain, then frames (8, 32, 64)
    float32 from ``RandomState(seed + i)``, batch by batch."""
    want = list(s["jax_calib"]())
    got = list(s["pt_calib"]())
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b) == ["frames", "tokens"]
        assert tuple(a["frames"].shape) == (8, 32, 64)
        assert a["frames"].dtype == torch.float32
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), k)


def test_units_are_the_jax_units(s):
    """The encoder's attention and MLP, then the decoder's attention, its
    class-1 cross unit (params under ``cross``) and MLP."""
    want = [(u.name, u.seg, u.kind, u.attn_class, u.n_groups, u.d_hidden,
             u.param_key) for u in jax_units(s["jcfg"])]
    got = [(u.name, u.seg, u.kind, u.attn_class, u.n_groups, u.d_hidden,
            u.param_key) for u in discover_units(s["cfg"])]
    assert got == want == [
        (ENC_ATTN, "enc", "attn", 1, 4, 0, "mixer"),
        (ENC_MLP, "enc", "mlp", 1, 1, 256, "mlp"),
        (DEC_ATTN, "dec", "attn", 1, 4, 0, "mixer"),
        (CROSS, "dec", "cross", 1, 4, 0, "cross"),
        (DEC_MLP, "dec", "mlp", 1, 1, 256, "mlp")]


@pytest.fixture(scope="module")
def pass1(s):
    want = JaxEngine(s["jax_model"], jax_units(s["jcfg"]), phase=1) \
        .run(s["jax_params"], s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], discover_units(s["cfg"]),
                            phase=1).run(s["pt_params"], s["pt_calib"]())
    return jax.tree.map(np.asarray, want), interop.to_numpy(got)


@pytest.mark.parametrize("unit", [ENC_ATTN, ENC_MLP, DEC_ATTN, CROSS,
                                  DEC_MLP])
def test_pass1_statistics_match_jax(pass1, unit):
    """The MLP moments {n, s1, s2, na} (2, 256, 256) and the attention
    units' logit energies {rank (2, 4, 16), n}."""
    want, got = pass1
    assert sorted(got[unit]) == sorted(want[unit])
    for k in got[unit]:
        _close(got[unit][k], want[unit][k], k)
    shape = (2, 4, 16) if unit in ATTN_UNITS else (2, 256, 256)
    assert got[unit]["rank" if unit in ATTN_UNITS else "s2"].shape == shape


def test_pass2_statistics_match_jax(s, pass1):
    """G (2, 4, 64, 64), h and t2 of the three attention units on JAX's
    keep sets (8 of 16 dims a head), summed over the 3 batches."""
    want1 = pass1[0]
    plan = {u: jax_ranking.rank_attn(want1[u], 8) for u in ATTN_UNITS}
    want = JaxEngine(s["jax_model"], jax_units(s["jcfg"]), phase=2,
                     plan=plan).run(s["jax_params"], s["jax_calib"]())
    got = CalibrationEngine(s["pt_model"], discover_units(s["cfg"]),
                            phase=2, plan=plan).run(s["pt_params"],
                                                    s["pt_calib"]())
    got = interop.to_numpy(got)
    assert sorted(got) == sorted(ATTN_UNITS)
    for u in ATTN_UNITS:
        assert got[u]["G"].shape == (2, 4, 64, 64)
        for k in ("G", "h", "t2"):
            _close(got[u][k], np.asarray(want[u][k]), f"{u} {k}")


def test_cross_statistics_at_t_not_s(s):
    """The class-1 sums take the T decoder rows and the S memory rows as
    they come: one batch of 20 tokens against 12 frames, reduced by both
    packages from the same taps (pass 1, pass 2 on a keep set and the
    one-traversal speculative sums)."""
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((3, 12, 64)).astype(np.float32)
    tokens = rng.integers(0, 503, (3, 20)).astype(np.int32)
    jt, pt = {}, {}
    s["jax_model"].apply(s["jax_params"], {"frames": jnp.asarray(frames),
                                           "tokens": jnp.asarray(tokens)},
                         taps=jt)
    s["pt_model"].apply(s["pt_params"], {"frames": torch.from_numpy(frames),
                                         "tokens": torch.from_numpy(tokens)},
                        taps=pt)
    assert tuple(pt["dec/p0/cross_q"].shape) == (2, 3, 20, 4, 16)
    assert tuple(pt["dec/p0/cross_k"].shape) == (2, 3, 12, 4, 16)
    ju = [u for u in jax_units(s["jcfg"]) if u.name == CROSS]
    pu = [u for u in discover_units(s["cfg"]) if u.name == CROSS]
    want = jax_stats.pass1_reduce(jt, ju, s["jcfg"])[CROSS]
    got = stats_mod.pass1_reduce(pt, pu)[CROSS]
    for k in want:
        _close(got[k].numpy(), want[k], f"pass 1 {k}")
    keep, prune = jax_ranking.rank_attn(jax.tree.map(np.asarray, want), 8)
    want = jax_stats.pass2_reduce(jt, ju, {CROSS: (keep, prune)})[CROSS]
    got = stats_mod.pass2_reduce(pt, pu, {CROSS: (
        torch.as_tensor(keep, dtype=torch.int64),
        torch.as_tensor(prune, dtype=torch.int64))})[CROSS]
    for k in ("G", "h", "t2"):
        _close(got[k].numpy(), want[k], f"pass 2 {k}")
    cand = np.broadcast_to(np.arange(12)[None, None], (2, 4, 12))
    want = jax_stats.spec_pass2_reduce(jt, ju, {CROSS: jnp.asarray(cand)})
    got = stats_mod.spec_pass2_reduce(pt, pu, {CROSS: torch.as_tensor(
        np.ascontiguousarray(cand), dtype=torch.int64)})
    for k in ("Gc", "Hfull", "t2_tot"):
        _close(got[CROSS][k].numpy(), want[CROSS][k], f"speculative {k}")


# ---------------------------------------------------------------------------
# corp_prune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["two-pass", "one traversal"])
def test_pruned_logits_match_jax(s, mode):
    """0.5/0.5: d_ff 256 -> 128 in every MLP, qk 16 -> 8 in every
    attention (one ``eff_qk`` for the encoder's, the decoder's and the
    cross unit's, whose ``cross/{wq,wk}`` fold while ``wv``/``wo`` stay
    the dense ones); the config, plan sizes and held-out logits are JAX's
    two-pass prune's. One traversal (margin 1.0) hits in one traversal."""
    jp, jcfg, jrep, want = _jax_prune(s)
    pc = PruneConfig(0.5, 0.5)
    if mode == "one traversal":
        pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"],
                                   s["pt_calib"], pc, one_traversal=True,
                                   spec_margin=1.0)
        assert rep["traversals"] == 1
        assert sorted(rep["speculative"]["hits"]) == sorted(ATTN_UNITS)
    else:
        pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"],
                                   s["pt_calib"], pc)
        assert rep["traversals"] == jrep["traversals"] == 2
    assert pcfg == to_port_cfg(jcfg)
    assert (pcfg.eff_d_ff, pcfg.eff_qk) == (128, 8)
    assert rep["plan_sizes"] == {k: tuple(v)
                                 for k, v in jrep["plan_sizes"].items()}
    cross = pp["dec"]["p0"]["cross"]
    assert tuple(cross["wq"].shape) == tuple(cross["wk"].shape) \
        == (2, 64, 4, 8)
    dense = s["pt_params"]["dec"]["p0"]["cross"]
    assert cross["wv"] is dense["wv"] and cross["wo"] is dense["wo"]
    for unit, d in rep["units"].items():
        assert (np.asarray(d["j_star"])
                <= np.asarray(d["j_uncomp"]) * (1 + 1e-5) + 1e-6).all(), unit
    # the fold splits each head's M into two factors (an SVD, unique up to
    # signs and rotations): compare the bilinear form W_q W_k^T a head
    jcross = jp["dec"]["p0"]["cross"]
    _close(torch.einsum("ldhq,lehq->lhde", cross["wq"], cross["wk"]).numpy(),
           np.einsum("ldhq,lehq->lhde", jcross["wq"], jcross["wk"]),
           "cross W_q W_k^T", rtol=1e-4, atol=1e-4)
    _close(_port_logits(pcfg, pp, s), want, rtol=1e-4, atol=1e-4)


def test_cross_unit_alone_matches_jax(s):
    """MLP sparsity 0, attention 0.5: the cross unit's ridge diagnostics
    and the logits of the attention-only prune, compensated, are JAX's."""
    jp, jcfg, jrep, want = _jax_prune(s, mlp_sparsity=0.0)
    pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                               PruneConfig(0.0, 0.5))
    assert pcfg == to_port_cfg(jcfg) and pcfg.d_ff_kept is None
    for k in ("j_star", "j_uncomp", "rho2"):
        _close(rep["units"][CROSS][k], jrep["units"][CROSS][k], k,
               rtol=1e-4, atol=1e-4)
    _close(_port_logits(pcfg, pp, s), want, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def two_pass(s):
    pp, pcfg, _ = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                             PruneConfig(0.5, 0.5))
    return _port_logits(pcfg, pp, s)


def test_bf16_taps_match_jax_bf16_taps(s, two_pass):
    """bf16 taps in both packages: the same rounding of fp32 taps that
    differ in their last bits, held to 2e-3 as the LMs' bf16 stream
    (tests/test_torch_lm_prune.py). At this size the bf16 stream moves
    the pruned logits 4.9e-2 from the fp32 one, in JAX and in the port
    alike: the port's gap is JAX's to 1e-3."""
    _, _, _, want = _jax_prune(s, stats_dtype="bfloat16")
    pp, pcfg, _ = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                             PruneConfig(0.5, 0.5), stats_dtype="bfloat16")
    got = _port_logits(pcfg, pp, s)
    assert rel(got, want) <= 2e-3
    jax_gap = rel(want, _jax_prune(s)[3])
    assert abs(rel(got, two_pass) - jax_gap) <= 1e-3 * max(1.0, jax_gap)


def test_streamed_within_1e4_of_two_pass(s, two_pass):
    """Two units a group: three groups, the first two with attention
    (two traversals each), the last the decoder MLP (one)."""
    pp, pcfg, rep = corp_prune_streamed(s["pt_model"], s["pt_params"],
                                        s["pt_calib"], PruneConfig(0.5, 0.5),
                                        unit_group_size=2)
    assert rep["groups"] == 3 and rep["traversals"] == 5
    assert rel(_port_logits(pcfg, pp, s), two_pass) <= 1e-4


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_cli_checkpoint_restores_in_jax_and_serves_in_the_port(s, tmp_path):
    """``launch.prune`` of the reduced seamless writes a checkpoint that
    JAX's pruned template restores whole (the plain MLPs keep their
    ``bd``: no leaf of the port's is missing there), whose logits are the
    port's; the port's serve CLI restores it with ``--ckpt-in --mem-len``
    and serves it."""
    out = str(tmp_path)
    res = pt_prune.main(["--arch", ARCH + "-reduced", "--sparsity", "0.5",
                         "--calib", "16", "--calib-batch", "8",
                         "--calib-seq", "16", "--device", "cpu", "--out",
                         out])
    pcfg, pm = res["pruned_cfg"], res["pruned_params"]
    jcfg = s["jcfg"].pruned(0.5, 0.5)
    assert pcfg == to_port_cfg(jcfg)
    jtmpl = jax_build(jcfg).init(jax.random.PRNGKey(0))
    restored, extra = jax_restore(out, 0, jtmpl)
    assert extra["config"] == jcfg.name
    assert sorted(interop.flatten(jax.tree.map(np.asarray, restored))) \
        == sorted(interop.flatten(pm))
    want = _port_logits(pcfg, pm, s)
    _close(_jax_logits(jcfg, restored, s), want, rtol=1e-3, atol=1e-3)
    served = pt_serve.main(["--arch", ARCH + "-reduced", "--sparsity", "0.5",
                            "--ckpt-in", out, "--mem-len", "12", "--trace",
                            "3", "--slots", "2", "--max-len", "32",
                            "--prompt-range", "4,10", "--gen-range", "2,5",
                            "--device", "cpu"])
    for k, v in interop.flatten(pm).items():
        assert torch.equal(interop.flatten(served["params"])[k], v), k
    _close(_port_logits(pcfg, served["params"], s), want, rtol=1e-3,
           atol=1e-3)
    assert len(served["completions"]) == 3
