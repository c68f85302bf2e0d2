"""The port's routed Mixture-of-Experts (qwen3-moe-235b-a22b) against the
JAX package: top-k routing with capacity drops and ties, the MoE block in
the LM forward, prefill and decode, the pass-1 per-expert moments, the
parameter tree and serving.

qwen3-moe-235b-a22b-reduced in fp32 on the CPU (2 layers, d 64, 4 experts
of 128, top 2, capacity factor 1.25, qk-norm), on the same numpy-made
weights (``torch_parity.jax_params``). Sums run in other orders, so values
are held to rtol 1e-4 and atol 1e-5 of each array's scale (its largest
magnitude, at least 1): the reference scales an expert stack by its expert
count (``dense_init`` fan-in E = 4), so expert outputs reach ~100 and an
entry that cancels to ~0.1 carries fp32 rounding of ~1e-5 in either
package. Masks, counts, cache positions and token streams must be equal.
bf16 is held to 2e-2 of the output's scale.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.ckpt import _flatten as jax_flatten  # noqa: E402
from repro.core import CalibrationEngine as JaxEngine  # noqa: E402
from repro.core import discover_units as jax_units  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import mlp as jax_mlp  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import CalibrationEngine, discover_units  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from repro_torch.models import mlp as pt_mlp  # noqa: E402
from repro_torch.models.common import expert_taps  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from torch_parity import jax_params, lm_cfgs  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ARCH = "qwen3-moe-235b-a22b"
MAX_LEN = 48
MOE = "seg0/p0/moe"


@pytest.fixture(scope="module")
def s():
    jcfg, pcfg = lm_cfgs(arch=ARCH)
    params = jax_params(jcfg, seed=4)
    return {"jcfg": jcfg, "cfg": pcfg, "np": params,
            "jm": jax_build(jcfg), "jp": jax.tree.map(jnp.asarray, params),
            "pm": pt_build(pcfg),
            "pp": interop.from_numpy(params, device="cpu")}


def _layer(s, i=0):
    """One layer's MoE params (numpy), unstacked."""
    return {k: v[i] for k, v in s["np"]["seg0"]["p0"]["mlp"].items()}


def _moe_both(cfg_j, cfg_p, p, x, jdt=jnp.float32, tdt=torch.float32):
    """apply_moe of both packages on the same params and input; returns
    (JAX y, JAX taps, port y, port taps), the taps with the expert-removal
    ones."""
    jp = {k: jnp.asarray(v) if k == "router" else jnp.asarray(v).astype(jdt)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(np.array(v)).to(
        torch.float32 if k == "router" else tdt) for k, v in p.items()}
    jt, pt = {}, {}
    yj, _ = jax_mlp.apply_moe(jp, jnp.asarray(x).astype(jdt), cfg_j,
                              taps=jt)
    with expert_taps():
        yp = pt_mlp.apply_moe(tp, torch.from_numpy(x).to(tdt), cfg_p,
                              taps=pt)
    return yj, jt, yp, pt


def _close(got, want, err_msg=""):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=err_msg)


def _close_tree(got, want):
    g = interop.flatten(interop.to_numpy(got))
    w = interop.flatten(jax.tree.map(np.asarray, want))
    assert list(g) == list(w)
    for k in w:
        assert (g[k].shape, g[k].dtype) == (w[k].shape, w[k].dtype), k
        if w[k].dtype.kind == "i":
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            _close(g[k], w[k], k)


# ---------------------------------------------------------------------------
# config, parameter tree
# ---------------------------------------------------------------------------

def test_reduced_config_keeps_the_moe_shape(s):
    cfg = s["cfg"]
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_expert,
            cfg.moe.capacity_factor) == (4, 2, 128, 1.25)
    assert cfg.qk_norm and cfg.layout() == [("scan", 2, [0])]
    assert all(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    assert (cfg.eff_num_experts, cfg.eff_d_expert) == (4, 128)
    p = cfg.pruned(0.5, 0.5, expert_sparsity=0.5)
    assert (p.eff_num_experts, p.eff_d_expert) == (2, 64)


def test_param_tree_carries_the_moe_leaves_with_jax_key_paths(s):
    """interop carries the router (fp32, (L, D, E)), the expert stacks
    ``wg``/``wu`` (L, E, D, F) and ``wd`` (L, E, F, D) under the key paths
    of ``repro.checkpoint.ckpt._flatten``; the port's own init makes the
    same tree."""
    want = jax_flatten(s["jp"])[0]
    got = interop.flatten(interop.to_numpy(s["pp"]))
    assert list(got) == sorted(want)
    L, D, E, F = 2, 64, 4, 128
    shapes = {"router": (L, D, E), "wg": (L, E, D, F), "wu": (L, E, D, F),
              "wd": (L, E, F, D)}
    for k, shape in shapes.items():
        a = got[f"seg0/p0/mlp/{k}"]
        assert a.shape == shape and a.dtype == np.float32, k
        np.testing.assert_array_equal(a, want[f"seg0/p0/mlp/{k}"])
    own = interop.flatten(interop.to_numpy(
        s["pm"].init(torch.Generator().manual_seed(0), "cpu")))
    assert {k: v.shape for k, v in own.items()} \
        == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("mlp,experts", [(0.5, 0.0), (0.0, 0.5),
                                         (0.5, 0.5)])
def test_pruned_template_holds_the_compensation_slots(s, mlp, experts):
    """A pruned template adds, zeros fp32: ``bd_moe`` (E, D) when hidden
    channels were pruned, ``moe_resid`` (D, D) and ``moe_out_b`` (D,)
    when experts were removed. JAX's ``init_moe`` has none of them."""
    pcfg = s["cfg"].pruned(mlp, 0.0, expert_sparsity=experts)
    jcfg = s["jcfg"].pruned(mlp, 0.0, expert_sparsity=experts)
    got = interop.flatten(interop.to_numpy(
        pt_build(pcfg).init(torch.Generator().manual_seed(0), "cpu")))
    want = jax_flatten(jax_build(jcfg).init(jax.random.PRNGKey(0)))[0]
    extra = {k: got.pop(k) for k in list(got) if k not in want}
    E, D = pcfg.eff_num_experts, pcfg.d_model
    shapes = {}
    if mlp:
        shapes["seg0/p0/mlp/bd_moe"] = (2, E, D)
    if experts:
        shapes.update({"seg0/p0/mlp/moe_resid": (2, D, D),
                       "seg0/p0/mlp/moe_out_b": (2, D)})
    assert {k: v.shape for k, v in extra.items()} == shapes
    assert all(v.dtype == np.float32 and not v.any()
               for v in extra.values())
    assert {k: v.shape for k, v in got.items()} \
        == {k: v.shape for k, v in want.items()}


# ---------------------------------------------------------------------------
# apply_moe: routing, capacity, ties, bf16
# ---------------------------------------------------------------------------

def test_apply_moe_with_capacity_drops_matches_jax(s):
    """6 tokens pushed towards expert 0: capacity C = 4 < 6 picks, so two
    (token, k) pairs are dropped; the same ones as JAX drops (the masks are
    equal) and the outputs and every tap agree."""
    p = _layer(s)
    rng = np.random.default_rng(2)
    common = rng.standard_normal(64).astype(np.float32)
    x = (common + 0.3 * rng.standard_normal((1, 6, 64))).astype(np.float32)
    p["router"] = p["router"] + 0.5 * common[:, None] * \
        np.array([1.0, 0, 0, 0], np.float32)
    assert pt_mlp.capacity(6, s["cfg"]) == 4
    yj, jt, yp, pt = _moe_both(s["jcfg"], s["cfg"], p, x)
    mask = pt["moe_mask"].numpy()
    assert mask[0, 0].sum() == 4 and mask.sum() < 6 * 2      # drops
    np.testing.assert_array_equal(mask, np.asarray(jt["moe_mask"]))
    _close(yp.numpy(), np.asarray(yj))
    assert sorted(pt) == sorted(jt)
    for k in jt:
        _close(pt[k].numpy(), np.asarray(jt[k]), k)


def test_apply_moe_groups_and_overflows_like_jax(s):
    """B*T = 2 x 9 tokens form one routing group (C = 12) and the output
    and taps equal JAX's on the module's weights."""
    p = _layer(s, 1)
    x = np.random.default_rng(3).standard_normal((2, 9, 64)) \
        .astype(np.float32)
    yj, jt, yp, pt = _moe_both(s["jcfg"], s["cfg"], p, x)
    assert pt["moe_h"].shape == (1, 4, 12, 128)
    _close(yp.numpy(), np.asarray(yj))
    for k in jt:
        _close(pt[k].numpy(), np.asarray(jt[k]), k)


def test_router_ties_break_to_the_lower_expert_as_jax(s):
    """A zero router gives every expert the same probability: exact ties.
    ``jax.lax.top_k`` takes the lower indices; so does the port (a stable
    descending sort), so only experts 0 and 1 take tokens, 4 each (the
    capacity of 5 tokens), and the fifth token's pairs are dropped."""
    p = _layer(s)
    p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(4).standard_normal((1, 5, 64)) \
        .astype(np.float32)
    yj, jt, yp, pt = _moe_both(s["jcfg"], s["cfg"], p, x)
    filled = pt["moe_mask"].numpy()[0].sum(-1)
    np.testing.assert_array_equal(filled, [4, 4, 0, 0])
    np.testing.assert_array_equal(pt["moe_mask"].numpy(),
                                  np.asarray(jt["moe_mask"]))
    _close(yp.numpy(), np.asarray(yj))


def test_bf16_apply_moe_matches_jax_within_bf16(s):
    """bf16 experts with the gate weights rounded to bf16 before they
    combine (as the reference's ``combine.astype(dt)``): within 2e-2 of
    the output's scale."""
    p = _layer(s)
    cj, cp = s["jcfg"].replace(dtype="bfloat16"), \
        s["cfg"].replace(dtype="bfloat16")
    x = np.random.default_rng(5).standard_normal((2, 8, 64)) \
        .astype(np.float32)
    yj, jt, yp, pt = _moe_both(cj, cp, p, x, jnp.bfloat16, torch.bfloat16)
    assert yp.dtype == torch.bfloat16
    want = np.asarray(yj.astype(jnp.float32))
    np.testing.assert_allclose(yp.float().numpy(), want, rtol=0,
                               atol=2e-2 * float(np.abs(want).max()))
    np.testing.assert_array_equal(pt["moe_mask"].numpy(),
                                  np.asarray(jt["moe_mask"]))


def test_expert_taps_are_recorded_only_when_asked(s):
    taps = {}
    s["pm"].apply(s["pp"], {"tokens": torch.zeros(2, 5, dtype=torch.int64)},
                  taps=taps)
    assert sorted(k.rsplit("/", 1)[1] for k in taps if "moe" in k) \
        == ["moe_h", "moe_mask"]
    with expert_taps():
        s["pm"].apply(s["pp"], {"tokens": torch.zeros(2, 5,
                                                      dtype=torch.int64)},
                      taps=taps)
    assert {"seg0/p0/moe_x", "seg0/p0/moe_yc"} <= set(taps)


def test_shared_experts_raise_by_name(s):
    """Shared experts were refused by name until they were ported with
    deepseek-v3 (``tests/test_torch_deepseek.py`` holds them to JAX): the
    same config now builds a ``shared`` GLU of ``num_shared * d_expert``
    under JAX's key paths, and its output is added to the routed one."""
    moe = s["cfg"].moe.__class__(num_experts=4, top_k=2, d_expert=128,
                                 num_shared=1)
    cfg = s["cfg"].replace(moe=moe)
    jcfg = s["jcfg"].replace(moe=s["jcfg"].moe.__class__(
        num_experts=4, top_k=2, d_expert=128, num_shared=1))
    got = interop.flatten(pt_build(cfg).init(torch.Generator().manual_seed(0),
                                             "cpu"))
    want = jax_flatten(jax_build(jcfg).init(jax.random.PRNGKey(0)))[0]
    assert {k: tuple(v.shape) for k, v in got.items()} \
        == {k: v.shape for k, v in want.items()}
    assert tuple(got["seg0/p0/mlp/shared/wd"].shape) == (2, 128, 64)


# ---------------------------------------------------------------------------
# the LM: forward, prefill, decode
# ---------------------------------------------------------------------------

def _tokens(cfg, T, seed=0, B=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def test_apply_lm_logits_and_taps_match_jax(s):
    toks = _tokens(s["cfg"], 14)
    jt, pt = {}, {}
    want, _ = s["jm"].apply(s["jp"], {"tokens": jnp.asarray(toks)}, taps=jt)
    got, _ = s["pm"].apply(s["pp"], {"tokens": torch.from_numpy(toks)},
                           taps=pt)
    _close(got.numpy(), np.asarray(want))
    # JAX records the expert-removal taps on every taped forward
    assert sorted(pt) == sorted(k for k in jt
                                if not k.endswith(("moe_x", "moe_yc")))
    for k in pt:
        _close(pt[k].numpy(), np.asarray(jt[k]), k)


def test_prefill_then_decode_match_jax(s):
    """A 12-token prefill, then 6 decode steps (each a routing group of the
    2 rows): the logits of every step and the final cache equal JAX's."""
    toks = _tokens(s["cfg"], 12, seed=1)
    jl, jc = s["jm"].prefill(s["jp"], {"tokens": jnp.asarray(toks)}, MAX_LEN)
    pl, pc = s["pm"].prefill(s["pp"], {"tokens": torch.from_numpy(toks)},
                             MAX_LEN)
    _close(pl.numpy(), np.asarray(jl))
    for step in range(6):
        nxt = np.asarray(jnp.argmax(jl[:, -1, :s["cfg"].vocab_size], -1),
                         np.int32)[:, None]
        jl, jc = s["jm"].decode_step(s["jp"], jnp.asarray(nxt), jc)
        pl, pc = s["pm"].decode_step(s["pp"], torch.from_numpy(nxt), pc)
        _close(pl.numpy(), np.asarray(jl), f"step {step}")
    _close_tree(pc, jc)


# ---------------------------------------------------------------------------
# pass 1: per-expert moments (and the expert-removal ones when asked)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pass1(s):
    from repro.data import calib_stream as jax_stream
    from repro_torch.data import calib_stream as pt_stream
    kw = dict(n_samples=16, batch=8, seq=12)
    want = JaxEngine(s["jm"], jax_units(s["jcfg"]), phase=1) \
        .run(s["jp"], jax_stream(s["jcfg"], **kw)())
    got = {flag: CalibrationEngine(
        s["pm"], discover_units(s["cfg"]), phase=1,
        expert_moments=flag).run(s["pp"], pt_stream(s["cfg"], device="cpu",
                                                    **kw)())
        for flag in (False, True)}
    return want, got


@pytest.mark.parametrize("expert_moments", [False, True])
def test_pass1_moe_moments_match_jax(pass1, expert_moments):
    """n (L, E), s1, s2 (L, E, F, F) and na of each expert's queue, as JAX's
    ``_p1_moe`` reduces them; yn, ys1, ys2 ((E+1) D wide) only when the
    engine asks for them (JAX always reduces them)."""
    want, got = pass1
    w, g = jax.tree.map(np.asarray, want[MOE]), got[expert_moments][MOE]
    keys = ["n", "s1", "s2", "na"] + (["yn", "ys1", "ys2"]
                                      if expert_moments else [])
    assert sorted(g) == sorted(keys)
    assert g["s2"].shape == (2, 4, 128, 128)
    assert sorted(w) == sorted(["n", "s1", "s2", "na", "yn", "ys1", "ys2"])
    for k in keys:
        _close(g[k].numpy(), w[k], k)
    # the queues fill up to capacity, less the drops
    assert float(g["n"].sum()) <= 2 * 2 * 16 * 12


def test_reference_reduces_the_expert_moments_even_when_unused(pass1):
    """A fault of the reference kept out of the port: JAX's pass 1 reduces
    ys2, the ((E+1) D)^2 second moment, on every MoE prune
    (``repro.core.stats._p1_moe``), though only expert removal reads it.
    At qwen3-moe's full width that is 1.1 TB a layer."""
    want, got = pass1
    assert want[MOE]["ys2"].shape == (2, 5 * 64, 5 * 64)
    assert "ys2" not in got[False][MOE]
    full = (128 + 1) * 4096
    assert full * full * 4 > 1.1e12


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

SPECS = [(5, 7), (13, 3), (9, 10), (3, 1), (11, 6)]


@pytest.fixture(scope="module")
def served(s):
    """The JAX engine's streams on the module's weights, whole-prompt and
    chunked: ragged bucketed prefills (pad tokens routed and taking
    capacity slots) and shared decode steps over all 3 slots, whose tokens
    route as one group, so a stream depends on its neighbours."""
    rng = np.random.RandomState(5)
    toks = [rng.randint(0, s["cfg"].vocab_size, size=p).astype(np.int32)
            for p, _ in SPECS]
    streams = {}
    for chunk in (None, 4):
        jeng = JaxServe(s["jm"], s["jp"], n_slots=3, max_len=MAX_LEN)
        streams[chunk] = [c.tokens.tolist() for c in jeng.run(
            [JaxRequest(rid=i, tokens=t, gen=g)
             for i, (t, (_, g)) in enumerate(zip(toks, SPECS))],
            prefill_chunk=chunk)]
    return {"streams": streams,
            "trace": [Request(rid=i, tokens=t, gen=g)
                      for i, (t, (_, g)) in enumerate(zip(toks, SPECS))]}


@pytest.mark.parametrize("chunk", [None, 4])
def test_engine_streams_equal_the_jax_engine(s, served, chunk):
    eng = ServeEngine(s["pm"], s["pp"], n_slots=3, max_len=MAX_LEN)
    assert eng.ragged_ok
    comps = eng.run(served["trace"], prefill_chunk=chunk)
    assert [c.tokens.tolist() for c in comps] == served["streams"][chunk]
    assert [len(c.tokens) for c in comps] == [g for _, g in SPECS]
    if chunk is not None:
        assert eng.stats["chunk_steps"] > 0
