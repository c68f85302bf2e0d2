"""The port's deepseek-v3-671b against the JAX package: MLA (the latent
prefill through the attention kernel's plain path and the absorbed decode
over the latent cache), ``apply_rope``, the shared expert beside the
routed ones, the ``first_k_dense`` layers, prefill and decode caches
(ragged too), the engine's streams and the serve CLI.

deepseek-v3-671b-reduced in fp32 on the CPU (3 layers: one dense layer of
d_ff 256, then two MoE layers of 4 experts of 128, top 2, and a shared
expert of 128; d 64, 4 heads, MLA ranks q 32 / kv 16, nope 16, rope 8, v
16), on the same numpy-made weights (``torch_parity.jax_params``). Sums
run in other orders, so values are held to rtol 1e-5 and atol 1e-5 of
each array's scale (its largest magnitude, at least 1); cache positions
and token streams must be equal. bf16 is held to 2e-2 of the output's
scale.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.ckpt import _flatten as jax_flatten  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import mlp as jax_mlp  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import attention as pt_attn  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from repro_torch.models import common as pt_common  # noqa: E402
from repro_torch.models import mlp as pt_mlp  # noqa: E402
from repro_torch.serve import Request, ServeEngine, cache_bytes  # noqa: E402
from torch_parity import jax_params, lm_cfgs  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
ARCH = "deepseek-v3-671b"
MAX_LEN = 48


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


def _mixer(s):
    """The dense layer's MLA params (numpy fp32, unstacked)."""
    return dict(s["np"]["seg0"]["l0"]["mixer"])


def _both(p, jdt=jnp.float32, tdt=torch.float32):
    """numpy params -> (JAX params, port params), weights in the given
    dtypes, 1-d leaves (norm scales, rope table) fp32."""
    return ({k: jnp.asarray(v).astype(jdt if v.ndim > 1 else jnp.float32)
             for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)).to(
                tdt if v.ndim > 1 else torch.float32) for k, v in p.items()})


def _tokens(cfg, T, seed=0, B=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


# ---------------------------------------------------------------------------
# config, parameter tree, initialisation
# ---------------------------------------------------------------------------

def test_reduced_config_keeps_the_mla_and_dense_layers(s):
    cfg = s["cfg"]
    m = cfg.mla
    assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_dim, m.qk_rope_dim,
            m.v_dim) == (32, 16, 16, 8, 16)
    assert (cfg.first_k_dense, cfg.dense_d_ff, cfg.n_layers) == (1, 256, 3)
    assert cfg.layout() == [("unroll", [0]), ("scan", 2, [1])]
    assert [cfg.layer_is_moe(i) for i in range(3)] == [False, True, True]
    assert (cfg.moe.num_shared, cfg.qk_full) == (1, 16)
    p = cfg.pruned(0.5, 0.5)
    assert (p.eff_qk, p.eff_dense_d_ff, p.eff_d_expert) == (8, 128, 64)
    assert p.mla == cfg.mla            # the logit scale stays 1/sqrt(24)


def test_param_tree_carries_mla_shared_and_dense_leaves(s):
    """interop carries every leaf under the key paths of
    ``repro.checkpoint.ckpt._flatten`` (``mixer/rope_inv``,
    ``mlp/shared/*``, the dense layer's ``dense_d_ff`` MLP); the port's own
    init makes the same tree."""
    want = jax_flatten(s["jp"])[0]
    got = interop.flatten(interop.to_numpy(s["pp"]))
    assert list(got) == sorted(want)
    shapes = {"seg0/l0/mixer/w_uq_nope": (32, 4, 16),
              "seg0/l0/mixer/w_uk_nope": (16, 4, 16),
              "seg0/l0/mixer/w_k_rope": (64, 8),
              "seg0/l0/mixer/rope_inv": (4,),
              "seg0/l0/mlp/wd": (256, 64),
              "seg1/p0/mixer/w_uv": (2, 16, 4, 16),
              "seg1/p0/mlp/wd": (2, 4, 128, 64),
              "seg1/p0/mlp/shared/wg": (2, 64, 128),
              "seg1/p0/mlp/shared/wd": (2, 128, 64)}
    assert {k: got[k].shape for k in shapes} == shapes
    own = interop.flatten(interop.to_numpy(
        s["pm"].init(torch.Generator().manual_seed(0), "cpu")))
    assert {k: v.shape for k, v in own.items()} \
        == {k: v.shape for k, v in want.items()}
    np.testing.assert_array_equal(
        own["seg0/l0/mixer/rope_inv"],
        np.asarray(jax_common.rope_freqs(8, 1e4), np.float32))


def test_pruned_template_holds_the_compensation_slots(s):
    """Pruned at 0.5/0.5: the nope blocks shrink to 8 and the MLPs to
    half; the port's template adds, zeros fp32, ``bd`` of the dense and
    the shared MLPs and ``bd_moe``, which JAX's template lacks (reference
    fault 2, ROADMAP Queue 3)."""
    pcfg, jcfg = s["cfg"].pruned(0.5, 0.5), s["jcfg"].pruned(0.5, 0.5)
    got = interop.flatten(interop.to_numpy(
        pt_build(pcfg).init(torch.Generator().manual_seed(0), "cpu")))
    want = jax_flatten(jax_build(jcfg).init(jax.random.PRNGKey(0)))[0]
    extra = {k: got.pop(k) for k in list(got) if k not in want}
    assert {k: v.shape for k, v in extra.items()} == {
        "seg0/l0/mlp/bd": (64,), "seg1/p0/mlp/bd_moe": (2, 4, 64),
        "seg1/p0/mlp/shared/bd": (2, 64)}
    assert all(v.dtype == np.float32 and not v.any()
               for v in extra.values())
    assert {k: v.shape for k, v in got.items()} \
        == {k: v.shape for k, v in want.items()}
    assert got["seg0/l0/mixer/w_uq_nope"].shape == (32, 4, 8)
    assert got["seg0/l0/mlp/wd"].shape == (128, 64)


def test_large_leaves_are_drawn_a_slice_at_a_time(monkeypatch):
    """A leaf above ``_CHUNKED_DRAW`` values is drawn one slice of its
    first axis at a time into its dtype (deepseek-v3's expert stack: 3.76 G
    values, 15 GB in fp32 at once); on the CPU the values are the
    one-shot draw's."""
    shape = (4, 32, 48)
    want = pt_common.dense_init(torch.Generator().manual_seed(3), shape,
                                torch.bfloat16)
    monkeypatch.setattr(pt_common, "_CHUNKED_DRAW", 1000)
    got = pt_common.dense_init(torch.Generator().manual_seed(3), shape,
                               torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# rope, MLA prefill and decode, the shared expert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    """Interleaved pairs, fp32 angles, the result in x's dtype, at ragged
    positions (B, T) and a shared key (H = 1)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    want = jax_common.apply_rope(jnp.asarray(x).astype(jdt),
                                 jnp.asarray(pos), 1e4)
    got = pt_common.apply_rope(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(pos), 1e4)
    assert got.dtype == tdt
    tol = RTOL if dtype == "float32" else 2e-2
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           rtol=tol, atol=tol)


def test_apply_mla_matches_jax(s):
    """The latent projections, roped blocks, the causal attention at
    1/sqrt(nope + rope) (the kernel's plain path on the CPU), the nope
    taps and the latent cache."""
    jp, tp = _both(_mixer(s))
    x = np.random.default_rng(3).standard_normal((2, 11, 64)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    jt, pt = {}, {}
    yj, cj = jax_attn._apply_mla(jp, jnp.asarray(x), s["jcfg"],
                                 positions=jnp.asarray(pos), taps=jt,
                                 return_cache=True)
    yp, cp = pt_attn._apply_mla(tp, torch.from_numpy(x), s["cfg"],
                                positions=torch.from_numpy(pos.copy()),
                                taps=pt, return_cache=True)
    _close(yp.numpy(), np.asarray(yj))
    assert sorted(pt) == sorted(jt) == ["k", "q"]
    assert pt["q"].shape == (2, 11, 4, 16)
    for k in jt:
        _close(pt[k].numpy(), np.asarray(jt[k]), k)
    _close_tree(cp, cj)


def test_pruned_mla_keeps_the_dense_logit_scale(s):
    """A pruned MLA (nope 8, so dq 16) scales its logits by 1/sqrt(24), the
    dense model's, as the reference does: the port's default of the kernel
    (1/sqrt(dq)) would differ."""
    jcfg, pcfg = s["jcfg"].pruned(0.0, 0.5), s["cfg"].pruned(0.0, 0.5)
    p = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(2)))
    p = {k: v + 0.05 for k, v in p["seg0"]["l0"]["mixer"].items()}
    jp, tp = _both(p)
    x = np.random.default_rng(4).standard_normal((2, 9, 64)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    yj, _ = jax_attn._apply_mla(jp, jnp.asarray(x), jcfg,
                                positions=jnp.asarray(pos))
    yp, _ = pt_attn._apply_mla(tp, torch.from_numpy(x), pcfg,
                               positions=torch.from_numpy(pos.copy()))
    assert pt_attn._mla_scale(pcfg) == pytest.approx(24 ** -0.5)
    _close(yp.numpy(), np.asarray(yj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_mla_matches_jax(s, dtype):
    """Four absorbed decode steps over a latent cache filled by a ragged
    prefill: fp32 logits over ``ckv`` and ``k_rope``, the new rows written
    at ``pos`` in place; fp32 to 1e-5, bf16 within 2e-2 of the JAX CPU
    path."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    jcfg, pcfg = s["jcfg"].replace(dtype=dtype), s["cfg"].replace(
        dtype=dtype)
    jp, tp = _both(_mixer(s), jdt, tdt)
    rng = np.random.default_rng(5)
    S = 16
    ckv = rng.standard_normal((2, S, 16)).astype(np.float32)
    kr = rng.standard_normal((2, S, 8)).astype(np.float32)
    pos = np.array([5, 9], np.int32)
    jc = {"ckv": jnp.asarray(ckv).astype(jdt),
          "k_rope": jnp.asarray(kr).astype(jdt), "pos": jnp.asarray(pos)}
    tc = {"ckv": torch.from_numpy(ckv).to(tdt),
          "k_rope": torch.from_numpy(kr).to(tdt),
          "pos": torch.from_numpy(pos.copy())}
    ckv_buf = tc["ckv"]
    tol = RTOL if dtype == "float32" else 2e-2
    for step in range(4):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        yj, jc = jax_attn._decode_mla(jp, jnp.asarray(x).astype(jdt), jc,
                                      jcfg)
        yp, tc = pt_attn._decode_mla(tp, torch.from_numpy(x).to(tdt), tc,
                                     pcfg)
        assert yp.dtype == tdt
        _close(yp.float().numpy(), np.asarray(yj.astype(jnp.float32)),
               f"step {step}", rtol=tol, atol=tol)
    assert tc["ckv"] is ckv_buf                      # updated in place
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _close(tc["ckv"].float().numpy(),
           np.asarray(jc["ckv"].astype(jnp.float32)), rtol=tol, atol=tol)


def test_apply_moe_with_the_shared_expert_matches_jax(s):
    """Routed experts plus the shared expert's dense GLU on the ungrouped
    x; the shared expert's ``h`` tap lands beside ``moe_h``."""
    p = {k: v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in
                                                   v.items()}
         for k, v in s["np"]["seg1"]["p0"]["mlp"].items()}
    x = np.random.default_rng(6).standard_normal((2, 10, 64)) \
        .astype(np.float32)
    jt, pt = {}, {}
    yj, _ = jax_mlp.apply_moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              s["jcfg"], taps=jt)
    yp = pt_mlp.apply_moe(interop.from_numpy(p, device="cpu"),
                          torch.from_numpy(x), s["cfg"], taps=pt)
    _close(yp.numpy(), np.asarray(yj))
    assert pt["h"].shape == (2, 10, 128)
    for k in ("h", "moe_h", "moe_mask"):
        _close(pt[k].numpy(), np.asarray(jt[k]), k)
    without = pt_mlp.apply_moe(
        {k: v for k, v in interop.from_numpy(p, device="cpu").items()
         if k != "shared"}, torch.from_numpy(x), s["cfg"])
    assert not torch.allclose(without, yp)


# ---------------------------------------------------------------------------
# the LM: forward, prefill, decode
# ---------------------------------------------------------------------------

def test_apply_lm_logits_and_taps_match_jax(s):
    toks = _tokens(s["cfg"], 14)
    jt, pt = {}, {}
    want, _ = s["jm"].apply(s["jp"], {"tokens": jnp.asarray(toks)}, taps=jt)
    got, _ = s["pm"].apply(s["pp"], {"tokens": torch.from_numpy(toks)},
                           taps=pt)
    _close(got.numpy(), np.asarray(want))
    assert sorted(pt) == sorted(k for k in jt
                                if not k.endswith(("moe_x", "moe_yc")))
    assert {"seg0/l0/h", "seg0/l0/q", "seg1/p0/h", "seg1/p0/moe_h"} \
        <= set(pt)
    for k in pt:
        _close(pt[k].numpy(), np.asarray(jt[k]), k)


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_then_decode_match_jax(s, ragged):
    """A 12-token prefill (ragged: lengths 12 and 7, the cache ``pos`` set
    per row) and 8 decode steps: the logits of every step and the final
    latent cache (``ckv``, ``k_rope``, ``pos`` of every layer) equal JAX's."""
    toks = _tokens(s["cfg"], 12, seed=1)
    lengths = np.array([12, 7], np.int32) if ragged else None
    jl, jc = s["jm"].prefill(
        s["jp"], {"tokens": jnp.asarray(toks)}, MAX_LEN,
        lengths=None if lengths is None else jnp.asarray(lengths))
    pl, pc = s["pm"].prefill(
        s["pp"], {"tokens": torch.from_numpy(toks)}, MAX_LEN,
        lengths=None if lengths is None else torch.from_numpy(lengths))
    _close(pl.numpy(), np.asarray(jl))
    leaves = interop.flatten(pc)
    assert leaves["seg0/l0/ckv"].shape == (2, MAX_LEN, 16)
    assert leaves["seg1/p0/k_rope"].shape == (2, 2, MAX_LEN, 8)
    for step in range(8):
        nxt = np.asarray(jnp.argmax(jl[:, -1, :s["cfg"].vocab_size], -1),
                         np.int32)[:, None]
        jl, jc = s["jm"].decode_step(s["jp"], jnp.asarray(nxt), jc)
        pl, pc = s["pm"].decode_step(s["pp"], torch.from_numpy(nxt), pc)
        _close(pl.numpy(), np.asarray(jl), f"step {step}")
    _close_tree(pc, jc)


def test_empty_cache_is_the_latent_cache(s):
    """``init_cache`` holds (kv_lora_rank + qk_rope_dim) values a token and
    layer, as JAX's; at full width that is 1,152 bytes in bf16, where a
    128-head cache of 192 + 128 dims would take 71 times more."""
    got = s["pm"].init_cache(2, MAX_LEN, "cpu")
    want = s["jm"].init_cache(2, MAX_LEN)
    _close_tree(got, want)
    m = s["cfg"].mla
    assert cache_bytes(got) == 2 * 4 * (3 * MAX_LEN * (m.kv_lora_rank
                                                       + m.qk_rope_dim)
                                        + 3) + 4 * 2
    from repro_torch.configs import get_config
    full = get_config(ARCH).replace(n_layers=1, first_k_dense=1)
    slot = cache_bytes(pt_build(full).init_cache(1, 2048, "meta"))
    assert slot == 2048 * (512 + 64) * 2 + 2 * 4
    assert 128 * (192 + 128) * 2 / ((512 + 64) * 2) > 71


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

SPECS = [(5, 7), (13, 3), (9, 10), (3, 1), (11, 6)]


@pytest.fixture(scope="module")
def served(s):
    """The JAX engine's streams on the module's weights, whole-prompt and
    chunked: ragged bucketed prefills into the latent slot cache and
    shared decode steps over all 3 slots."""
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
    assert eng.ragged_ok and eng.contract == "kv"
    axes = eng.slotcache.batch_axes
    assert (axes["seg0/l0/ckv"], axes["seg1/p0/ckv"]) == (0, 1)
    comps = eng.run(served["trace"], prefill_chunk=chunk)
    assert [c.tokens.tolist() for c in comps] == served["streams"][chunk]
    assert [len(c.tokens) for c in comps] == [g for _, g in SPECS]
    if chunk is not None:
        assert eng.stats["chunk_steps"] > 0


def test_serve_cli_on_the_cpu():
    """``launch.serve --arch deepseek-v3-671b-reduced``: every request of
    the trace served, from the latent cache."""
    res = pt_serve.main(["--arch", "deepseek-v3-671b-reduced", "--trace",
                         "4", "--slots", "2", "--max-len", "40",
                         "--prompt-range", "6,16", "--gen-range", "3,8",
                         "--device", "cpu"])
    assert len(res["completions"]) == 4
    assert res["stats"]["decode_steps"] > 0
    assert all(len(c.tokens) >= 3 for c in res["completions"])
