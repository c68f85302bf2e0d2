"""The port's jamba-1.5-large-398b against the JAX package: the Mamba mixer
(its causal conv, the chunked selective scan and the one-token step), the
hybrid block with a dense or routed-MoE MLP, the LM forward, prefill and
decode caches, the recurrent slot cache with attention K/V lanes, the
engine's streams and the serve CLI; the config copy and its layout below
one period (reference fault 6).

jamba-1.5-large-398b-reduced in fp32 on the CPU (8 layers: Mamba 0-3 and
5-7, attention at 4, MoE of 4 experts of 128, top 2, on the odd layers;
d 64, d_inner 128, d_state 4, d_conv 4), on the same numpy-made weights
(``torch_parity.jax_params``). Sums run in other orders, so values are
held to rtol 1e-5 and atol 1e-5 of each array's scale (its largest
magnitude, at least 1); cache positions and token streams must be equal.
bf16 is held to 2e-2 of the output's scale.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.checkpoint.ckpt import _flatten as jax_flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro.serve import synthetic_trace as jax_trace  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as pt_get_config  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import blocks as pt_blocks  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from repro_torch.models import ssm as pt_ssm  # noqa: E402
from repro_torch.serve import Request, ServeEngine, cache_bytes  # noqa: E402
from torch_parity import jax_params, lm_cfgs, to_port_cfg  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
ARCH = "jamba-1.5-large-398b"
MAX_LEN = 48
SERVE = ["--trace", "4", "--slots", "2", "--max-len", "40",
         "--prompt-range", "6,16", "--gen-range", "3,8", "--device", "cpu"]


@pytest.fixture(scope="module")
def s():
    jcfg, pcfg = lm_cfgs(arch=ARCH)
    params = jax_params(jcfg, seed=6)
    return {"jcfg": jcfg, "cfg": pcfg, "np": params,
            "jm": jax_build(jcfg), "jp": jax.tree.map(jnp.asarray, params),
            "pm": pt_build(pcfg),
            "pp": interop.from_numpy(params, device="cpu")}


def _close(got, want, err_msg="", rtol=RTOL, atol=ATOL):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
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


def _layer(s, j):
    """Layer j of the scanned segment (numpy fp32, the stack axis off)."""
    return jax.tree.map(lambda a: a[0], s["np"]["seg0"][f"p{j}"])


def _mixer(s, out_b=False):
    p = dict(_layer(s, 0)["mixer"])
    if out_b:
        p["out_b"] = np.random.default_rng(4).standard_normal(64) \
            .astype(np.float32)
    return p


def _both(tree, jdt=jnp.float32, tdt=torch.float32):
    """numpy params -> (JAX params, port params), matrices in the given
    dtypes and the fp32 leaves of the reference (``conv_w``, ``a_log``,
    ``dt_proj``, 1-d leaves) in fp32."""
    fp32 = ("conv_w", "a_log", "dt_proj")

    def one(k, v):
        keep = v.ndim == 1 or k in fp32
        return (jnp.asarray(v).astype(jnp.float32 if keep else jdt),
                torch.from_numpy(np.array(v)).to(torch.float32 if keep
                                                  else tdt))
    pairs = {k: one(k, v) for k, v in tree.items()}
    return ({k: a for k, (a, _) in pairs.items()},
            {k: b for k, (_, b) in pairs.items()})


def _tokens(cfg, T, seed=0, B=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _state(seed, di=128, B=2):
    rng = np.random.default_rng(seed)
    return {"conv": rng.standard_normal((B, 3, di)).astype(np.float32),
            "ssm": rng.standard_normal((B, di, 4)).astype(np.float32)}


# ---------------------------------------------------------------------------
# config, layout, parameter tree
# ---------------------------------------------------------------------------

def test_config_is_the_jax_config_and_reduced_keeps_the_hybrid(s):
    cfg = s["cfg"]
    full = pt_get_config(ARCH)
    assert full == to_port_cfg(jax_get_config(ARCH))
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.d_head,
            full.eff_d_inner, full.mamba.d_state) == (8192, 64, 8, 128,
                                                      16384, 16)
    assert (cfg.n_layers, cfg.eff_d_inner, cfg.mamba.d_state,
            cfg.moe.num_experts, cfg.moe.d_expert) == (8, 128, 4, 4, 128)
    assert cfg.layer_kinds == ("mamba",) * 4 + ("attn",) + ("mamba",) * 3
    assert [cfg.layer_is_moe(i) for i in range(8)] == [False, True] * 4
    p = cfg.pruned(0.5, 0.5)
    assert (p.eff_d_inner, p.d_inner_kept, p.eff_d_ff, p.eff_qk) \
        == (64, 64, 64, 8)


def test_layout_below_one_period_is_reference_fault_6(s):
    """Reference fault 6: JAX's ``layout()`` reads ``layer_spec`` past the
    last layer when fewer layers than one period remain
    (``src/repro/configs/base.py:183``), so jamba cut to 5 layers raises
    ``IndexError``; the port unrolls them, the layout JAX reaches with no
    full period. Where JAX lays out, the port's layout is its."""
    with pytest.raises(IndexError):
        jax_get_config(ARCH).replace(n_layers=5).layout()
    full = pt_get_config(ARCH)
    assert full.replace(n_layers=5).layout() == [("unroll", [0, 1, 2, 3, 4])]
    assert full.replace(n_layers=2).layout() == [("unroll", [0, 1])]
    assert full.layout() == jax_get_config(ARCH).layout() \
        == [("scan", 9, list(range(8)))]
    assert s["cfg"].layout() == s["jcfg"].layout() \
        == [("scan", 1, list(range(8)))]


def test_five_layers_match_the_jax_blocks_one_by_one(s):
    """The port at 5 layers (unrolled: a cut JAX cannot lay out) against
    JAX's blocks run in turn on the same layers' params."""
    cfg = s["cfg"].replace(n_layers=5)
    p5 = {k: v for k, v in s["np"].items() if not k.startswith("seg")}
    p5["seg0"] = {f"l{j}": _layer(s, j) for j in range(5)}
    toks = _tokens(cfg, 11, seed=3)
    jp = jax.tree.map(jnp.asarray, p5)
    x = jp["embed"][jnp.asarray(toks)]
    pos = jnp.broadcast_to(jnp.arange(11, dtype=jnp.int32)[None], (2, 11))
    for j in range(5):
        x, _ = jax_blocks.apply_block(jp["seg0"][f"l{j}"], x, s["jcfg"],
                                      *cfg.layer_spec(j), positions=pos)
    x = jax_common.apply_norm(jp["final_norm"], x, s["jcfg"])
    want = np.asarray(x @ jp["head"])
    got = pt_build(cfg).apply(interop.from_numpy(p5, device="cpu"),
                              {"tokens": torch.from_numpy(toks)})[0]
    _close(got.numpy(), want)


def test_param_tree_matches_jax_and_the_pruned_template_holds_out_b(s):
    """The port's init makes JAX's tree (``mixer/a_log`` (di, d_state),
    ``conv_w`` (d_conv, di), ``x_proj`` (di, dt_rank + 2 d_state) ...);
    pruned at 0.5 its template adds ``mixer/out_b``, zeros (D,) fp32, to
    every Mamba layer, which JAX's template lacks (reference fault 2)."""
    want = jax_flatten(s["jp"])[0]
    own = interop.flatten(interop.to_numpy(
        s["pm"].init(torch.Generator().manual_seed(0), "cpu")))
    assert {k: v.shape for k, v in own.items()} \
        == {k: v.shape for k, v in want.items()}
    shapes = {"seg0/p0/mixer/a_log": (1, 128, 4),
              "seg0/p0/mixer/conv_w": (1, 4, 128),
              "seg0/p0/mixer/x_proj": (1, 128, 12),
              "seg0/p0/mixer/in_proj": (1, 64, 256),
              "seg0/p1/mlp/wd": (1, 4, 128, 64),
              "seg0/p4/mixer/wk": (1, 64, 1, 16)}
    assert {k: own[k].shape for k in shapes} == shapes
    init = jax_flatten(s["jm"].init(jax.random.PRNGKey(0)))[0]
    for k in ("a_log", "dt_bias", "d_skip", "conv_b"):
        np.testing.assert_array_equal(own[f"seg0/p0/mixer/{k}"],
                                      np.asarray(init[f"seg0/p0/mixer/{k}"]))
    pcfg, jcfg = s["cfg"].pruned(0.5, 0.5), s["jcfg"].pruned(0.5, 0.5)
    got = interop.flatten(interop.to_numpy(
        pt_build(pcfg).init(torch.Generator().manual_seed(0), "cpu")))
    jwant = jax_flatten(jax_build(jcfg).init(jax.random.PRNGKey(0)))[0]
    extra = {k: got.pop(k) for k in list(got) if k not in jwant}
    assert {k: (v.shape, v.dtype) for k, v in extra.items()} == {
        f"seg0/p{j}/mixer/out_b": ((1, 64), np.float32)
        for j in (0, 1, 2, 3, 5, 6, 7)} | {
        f"seg0/p{j}/mlp/bd": ((1, 64), np.float32) for j in (0, 2, 4, 6)} \
        | {f"seg0/p{j}/mlp/bd_moe": ((1, 4, 64), np.float32)
           for j in (1, 3, 5, 7)}
    assert not any(v.any() for v in extra.values())
    assert {k: v.shape for k, v in got.items()} \
        == {k: v.shape for k, v in jwant.items()}


def test_interop_carries_the_fp32_mamba_leaves_unchanged(s):
    """``a_log`` and ``conv_w`` (and ``dt_proj``) are fp32 in JAX's bf16
    model too: the port's bf16 init keeps them fp32, and the stacked
    leaves cross by ``interop`` bit for bit."""
    flat = interop.flatten(s["pp"])
    back = interop.flatten(interop.to_numpy(s["pp"]))
    for k in ("seg0/p0/mixer/a_log", "seg0/p5/mixer/conv_w",
              "seg0/p3/mixer/dt_proj"):
        assert flat[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k], interop.flatten(s["np"])[k])
    jbf = interop.flatten(jax_build(s["jcfg"].replace(dtype="bfloat16"))
                          .init(jax.random.PRNGKey(0)))
    pbf = interop.flatten(pt_build(s["cfg"].replace(dtype="bfloat16"))
                          .init(torch.Generator().manual_seed(0), "cpu"))
    for k in jbf:
        assert str(pbf[k].dtype)[6:] == str(jbf[k].dtype), k


# ---------------------------------------------------------------------------
# the Mamba mixer
# ---------------------------------------------------------------------------

def test_causal_conv_with_prev_matches_jax(s):
    p = _mixer(s)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    prev = rng.standard_normal((2, 3, 128)).astype(np.float32)
    for pv in (None, prev):
        yj, cj = jax_ssm._causal_conv(
            jnp.asarray(x), jnp.asarray(p["conv_w"]), jnp.asarray(p["conv_b"]),
            None if pv is None else jnp.asarray(pv))
        yp, cp = pt_ssm._causal_conv(
            torch.from_numpy(x), torch.from_numpy(p["conv_w"]),
            torch.from_numpy(p["conv_b"]),
            None if pv is None else torch.from_numpy(pv))
        _close(yp.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [1, 7, 256, 300])
def test_apply_mamba_matches_jax(s, T, with_state):
    """y and both state leaves, from an empty or a given state: T = 1 is
    the one-token step, 7 a prime length, 256 one whole chunk, 300 a
    partial last chunk; ``out_b`` added when present."""
    jp, tp = _both(_mixer(s, out_b=True))
    x = np.random.default_rng(T).standard_normal((2, T, 64)) \
        .astype(np.float32)
    st = _state(T) if with_state else None
    jt, pt = {}, {}
    yj, sj = jax_ssm.apply_mamba(
        jp, jnp.asarray(x), s["jcfg"], taps=jt,
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    yp, sp = pt_ssm.apply_mamba(
        tp, torch.from_numpy(x), s["cfg"], taps=pt,
        state=None if st is None else
        {k: torch.from_numpy(v.copy()) for k, v in st.items()})
    _close(yp.numpy(), np.asarray(yj))
    _close(pt["mamba_y"].numpy(), np.asarray(jt["mamba_y"]))
    for k in ("conv", "ssm"):
        _close(sp[k].numpy(), np.asarray(sj[k]), k)
    without, _ = pt_ssm.apply_mamba(
        {k: v for k, v in tp.items() if k != "out_b"}, torch.from_numpy(x),
        s["cfg"])
    assert not torch.allclose(without, yp)


def test_fixed_chunks_at_a_prime_length_match_jax(s):
    """At a prime T past one chunk, JAX scans chunks of one token (the
    largest divisor <= 256) and the port 256 + 7: the same result up to
    fp32 reassociation (a deliberate difference)."""
    jp, tp = _both(_mixer(s))
    T = 263
    x = np.random.default_rng(9).standard_normal((1, T, 64)) \
        .astype(np.float32)
    yj, sj = jax_ssm.apply_mamba(jp, jnp.asarray(x), s["jcfg"])
    yp, sp = pt_ssm.apply_mamba(tp, torch.from_numpy(x), s["cfg"])
    _close(yp.numpy(), np.asarray(yj))
    _close(sp["ssm"].numpy(), np.asarray(sj["ssm"]))


def test_inclusive_scan_is_the_sequential_recurrence():
    """The log-depth scan equals h_t = a_t h_{t-1} + b_t run token by
    token (fp64), at lengths that are and are not powers of two."""
    rng = np.random.default_rng(0)
    for L in (1, 2, 5, 64, 100):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, L, 3, 2)))
        b = torch.from_numpy(rng.standard_normal((2, L, 3, 2)))
        want_a, want_b = [a[:, 0]], [b[:, 0]]
        for t in range(1, L):
            want_a.append(want_a[-1] * a[:, t])
            want_b.append(want_b[-1] * a[:, t] + b[:, t])
        ga, gb = pt_ssm._inclusive_scan(a.clone(), b.clone())
        torch.testing.assert_close(ga, torch.stack(want_a, 1))
        torch.testing.assert_close(gb, torch.stack(want_b, 1))


def test_apply_mamba_bf16_matches_jax(s):
    jp, tp = _both(_mixer(s), jnp.bfloat16, torch.bfloat16)
    x = np.random.default_rng(3).standard_normal((2, 40, 64)) \
        .astype(np.float32)
    yj, _ = jax_ssm.apply_mamba(jp, jnp.asarray(x).astype(jnp.bfloat16),
                                s["jcfg"])
    yp, _ = pt_ssm.apply_mamba(tp, torch.from_numpy(x).bfloat16(),
                               s["cfg"])
    assert yp.dtype == torch.bfloat16
    _close(yp.float().numpy(), np.asarray(yj.astype(jnp.float32)),
           rtol=2e-2, atol=2e-2)


def test_decode_updates_the_state_in_place(s):
    """A decode step writes the new conv rows and SSM state over the
    given ones, as the port's other decode states do."""
    _, tp = _both(_mixer(s))
    st = {k: torch.from_numpy(v) for k, v in _state(5).items()}
    bufs = dict(st)
    x = torch.randn((2, 1, 64), generator=torch.Generator().manual_seed(1))
    _, out = pt_ssm.apply_mamba(tp, x, s["cfg"], state=st)
    assert out is st and all(out[k] is bufs[k] for k in bufs)


# ---------------------------------------------------------------------------
# blocks and the LM
# ---------------------------------------------------------------------------

def test_mamba_moe_block_and_its_decode_match_jax(s):
    """Layer 1 (Mamba mixer, routed MoE MLP): ``apply_block`` with its
    taps, then ``decode_block`` from a given state for 3 steps."""
    p = _layer(s, 1)
    jp, tp = jax.tree.map(jnp.asarray, p), interop.from_numpy(p, "cpu")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 10, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    jt, pt = {}, {}
    want, _ = jax_blocks.apply_block(jp, jnp.asarray(x), s["jcfg"], "mamba",
                                     True, positions=jnp.asarray(pos),
                                     taps=jt)
    got = pt_blocks.apply_block(tp, torch.from_numpy(x), s["cfg"], "mamba",
                                True, positions=torch.from_numpy(pos.copy()),
                                taps=pt)
    _close(got.numpy(), np.asarray(want))
    assert {"mamba_y", "moe_h", "moe_mask"} <= set(pt)
    for k in pt:
        _close(pt[k].numpy(), np.asarray(jt[k]), k)
    st = _state(12)
    jc = jax.tree.map(jnp.asarray, st)
    tc = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    for step in range(3):
        xs = rng.standard_normal((2, 1, 64)).astype(np.float32)
        yj, jc = jax_blocks.decode_block(jp, jnp.asarray(xs), jc, s["jcfg"],
                                         "mamba", True)
        yp, tc = pt_blocks.decode_block(tp, torch.from_numpy(xs), tc,
                                        s["cfg"], "mamba", True)
        _close(yp.numpy(), np.asarray(yj), f"step {step}")
    _close_tree(tc, jc)


def test_apply_lm_logits_and_taps_match_jax(s):
    toks = _tokens(s["cfg"], 14)
    jt, pt = {}, {}
    want, _ = s["jm"].apply(s["jp"], {"tokens": jnp.asarray(toks)}, taps=jt)
    got, _ = s["pm"].apply(s["pp"], {"tokens": torch.from_numpy(toks)},
                           taps=pt)
    _close(got.numpy(), np.asarray(want))
    assert sorted(pt) == sorted(k for k in jt
                                if not k.endswith(("moe_x", "moe_yc")))
    assert {"seg0/p0/mamba_y", "seg0/p0/h", "seg0/p1/moe_h",
            "seg0/p4/q"} <= set(pt)
    for k in pt:
        _close(pt[k].numpy(), np.asarray(jt[k]), k)


def test_prefill_then_decode_match_jax(s):
    """A 12-token prefill and 8 decode steps: the logits of every step and
    the final cache (Mamba ``conv`` and ``ssm``, attention ``k``, ``v``,
    ``pos``) equal JAX's."""
    toks = _tokens(s["cfg"], 12, seed=1)
    jl, jc = s["jm"].prefill(s["jp"], {"tokens": jnp.asarray(toks)}, MAX_LEN)
    pl, pc = s["pm"].prefill(s["pp"], {"tokens": torch.from_numpy(toks)},
                             MAX_LEN)
    _close(pl.numpy(), np.asarray(jl))
    leaves = interop.flatten(pc)
    assert leaves["seg0/p0/ssm"].shape == (1, 2, 128, 4)
    assert leaves["seg0/p4/k"].shape == (1, 2, MAX_LEN, 1, 16)
    for step in range(8):
        nxt = np.asarray(jnp.argmax(jl[:, -1, :s["cfg"].vocab_size], -1),
                         np.int32)[:, None]
        jl, jc = s["jm"].decode_step(s["jp"], jnp.asarray(nxt), jc)
        pl, pc = s["pm"].decode_step(s["pp"], torch.from_numpy(nxt), pc)
        _close(pl.numpy(), np.asarray(jl), f"step {step}")
    _close_tree(pc, jc)


def test_empty_cache_is_the_jax_cache(s):
    """``init_cache``: ``{"conv", "ssm"}`` a Mamba layer, ``k``, ``v``,
    ``pos`` the attention layer; at full width a Mamba layer's state is
    3 x 16384 bf16 + 16384 x 16 fp32 = 1.15 MB a slot."""
    _close_tree(s["pm"].init_cache(2, MAX_LEN, "cpu"),
                s["jm"].init_cache(2, MAX_LEN))
    full = pt_get_config(ARCH).replace(n_layers=1)
    slot = cache_bytes(pt_build(full).init_cache(1, 2048, "meta"))
    assert slot == 3 * 16384 * 2 + 16384 * 16 * 4 + 4


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

SPECS = [(5, 7), (13, 3), (9, 10), (3, 1), (11, 6)]


@pytest.fixture(scope="module")
def served(s):
    """The JAX engine's streams on the module's weights, whole-prompt and
    chunked: exact-length prefills, the batch-1 walk and shared decode
    steps over all 3 slots."""
    rng = np.random.RandomState(7)
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
    assert not eng.ragged_ok and eng.contract == "recurrent"
    axes = eng.slotcache.batch_axes
    assert (axes["seg0/p0/ssm"], axes["seg0/p4/k"], axes["pos"]) == (1, 1, 0)
    comps = eng.run(served["trace"], prefill_chunk=chunk)
    assert [c.tokens.tolist() for c in comps] == served["streams"][chunk]
    assert [len(c.tokens) for c in comps] == [g for _, g in SPECS]
    assert eng.stats["walk_steps"] > 0
    if chunk is not None:
        assert eng.stats["chunk_steps"] > 0


def test_retire_leaves_the_lane_inert_and_slot_parts_split_the_bytes(s):
    """Retire writes the empty cache back into the lane: zero Mamba
    states, and the attention lane inert (``pos`` 0, zero K/V) as the
    blank template holds it. ``slot_parts`` splits a slot's bytes into
    the Mamba states (constant in max_len) and the K/V part (growing)."""
    eng = ServeEngine(s["pm"], s["pp"], n_slots=2, max_len=MAX_LEN)
    eng.begin()
    eng.admit(Request(rid=0, tokens=np.arange(9, dtype=np.int32), gen=4), 1)
    eng.decode_step()
    flat = interop.flatten(eng.slotcache.cache)
    axes = eng.slotcache.batch_axes
    lane = {k: v.select(axes[k], 1) for k, v in flat.items()}
    assert int(lane["seg0/p4/pos"][0]) == 10 and lane["seg0/p0/ssm"].any()
    eng.retire(1)
    for k, v in flat.items():
        assert not v.select(axes[k], 1).any(), k
    parts = eng.slotcache.slot_parts
    assert sum(parts.values()) == eng.slotcache.slot_bytes
    assert parts["state"] == 7 * (3 * 128 + 128 * 4) * 4
    big = ServeEngine(s["pm"], s["pp"], n_slots=2, max_len=2 * MAX_LEN)
    assert big.slotcache.slot_parts["state"] == parts["state"]
    assert big.slotcache.slot_parts["kv"] > parts["kv"]


def test_serve_cli_streams_equal_the_jax_engine(s, tmp_path):
    """``launch.serve --ckpt-in`` of the JAX params: the trace's streams
    equal the JAX engine's (as ``tests/test_serve_zoo.py`` drives it),
    and the stats line splits the slot bytes."""
    jax_save(str(tmp_path), 0, s["np"], extra={"config": s["jcfg"].name})
    served = pt_serve.main(["--arch", ARCH + "-reduced", "--ckpt-in",
                            str(tmp_path)] + SERVE)
    jeng = JaxServe(s["jm"], s["jp"], n_slots=2, max_len=40)
    want = jeng.run(jax_trace(4, s["jcfg"].vocab_size, seed=0,
                              prompt_range=(6, 16), gen_range=(3, 8)))
    assert [c.tokens.tolist() for c in served["completions"]] == \
        [c.tokens.tolist() for c in want]


def test_entry_points_raise_without_a_card(monkeypatch):
    """Nothing falls back: without CUDA the jamba entry points raise
    unless ``--device cpu`` is given."""
    from repro_torch.launch import prune as pt_prune
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        pt_serve.main(["--arch", ARCH + "-reduced", "--trace", "2"])
    with pytest.raises(RuntimeError):
        pt_prune.main(["--arch", ARCH + "-reduced", "--calib-seq", "16"])
