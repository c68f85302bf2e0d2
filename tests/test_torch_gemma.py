"""The port's gemma3-1b against the JAX package: qk-norm, the 5:1
sliding-window stack with its ring-buffer decode, and serving.

gemma3-1b-reduced in fp32 on the CPU (window 8, 4 query heads over 1 kv
head of 16), on the same numpy-made weights (``torch_parity.jax_params``),
at 6 layers (one scanned segment of 5 ``swa`` + 1 ``attn``, as JAX's
reduced config) and at 8 (that segment plus 2 unrolled layers, the shape
of the full model's 4 x 6 + 2). Matmuls sum in different orders, so
logits and cache leaves are held to rtol 1e-4, atol 1e-5 (as
``tests/test_torch_lm.py``); integer leaves (``pos``, ``abs_pos``) and
token streams must be equal. The pruned config (qk 16 -> 8) runs the JAX
decode twice: on its jnp path and with ``REPRO_DECODE_IMPL=interpret``, so
the Pallas kernel itself is the reference.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.models.common import rms_head_norm as jax_head_norm  # noqa: E402
from repro.models.lm import _window_cache as jax_window_cache  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from repro_torch.models.common import rms_head_norm  # noqa: E402
from repro_torch.models.lm import _window_cache  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from torch_parity import greedy_chain_ok, jax_params, lm_cfgs  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ARCH = "gemma3-1b"
MAX_LEN = 64
PREFILL = 20              # > the reduced window of 8
STEPS = 26                # > 3 windows of decode
SETUPS = [(6, False), (8, False), (8, True)]       # (layers, pruned)
_SETUPS = {}


def _setup(n_layers, pruned):
    """(JAX model, JAX params, port model, port params), once per module
    for each config."""
    key = (n_layers, pruned)
    if key not in _SETUPS:
        jcfg, pcfg = lm_cfgs(pruned, arch=ARCH, n_layers=n_layers)
        params = jax_params(jcfg, seed=3 if pruned else 0)
        _SETUPS[key] = (jax_build(jcfg), jax.tree.map(jnp.asarray, params),
                        pt_build(pcfg),
                        interop.from_numpy(params, device="cpu"))
    return _SETUPS[key]


def _tokens(cfg, T, seed=0, B=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _close_tree(got, want):
    g = interop.flatten(interop.to_numpy(got))
    w = interop.flatten(jax.tree.map(np.asarray, want))
    assert list(g) == list(w)
    for k in w:
        assert (g[k].shape, g[k].dtype) == (w[k].shape, w[k].dtype), k
        if w[k].dtype.kind == "i":
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_config_keeps_the_pattern_qk_norm_and_local_theta():
    jcfg, pcfg = lm_cfgs(arch=ARCH)
    assert pcfg.qk_norm and pcfg.rope_theta_local == 1e4 \
        and pcfg.rope_theta == 1e6 and pcfg.sliding_window == 8
    assert pcfg.pattern == ("swa",) * 5 + ("attn",)
    assert pcfg.layout() == jcfg.layout() == [("scan", 1, list(range(6)))]
    _, p8 = lm_cfgs(arch=ARCH, n_layers=8)
    assert p8.layout() == [("scan", 1, list(range(6))), ("unroll", [6, 7])]


@pytest.mark.parametrize("n_layers,pruned", SETUPS)
def test_init_tree_has_the_jax_key_paths(n_layers, pruned):
    """The JAX package's key paths, shapes and dtypes (rope tables of the
    local theta on ``swa`` layers). A pruned template differs from JAX's
    on purpose: it adds ``mlp/bd`` and holds the qk-norm scales per head,
    ``(H, qk_kept)`` / ``(Hkv, qk_kept)``, the shapes the class-3 fold
    writes (JAX's template keeps ``(qk_kept,)`` and cannot restore them)."""
    _, jp, pm, _ = _setup(n_layers, pruned)
    cfg = pm.cfg
    want = interop.flatten(jax.tree.map(np.asarray, jp))
    got = interop.flatten(interop.to_numpy(
        pm.init(torch.Generator().manual_seed(0), "cpu")))
    bd = [k for k in got if k.endswith("mlp/bd")]
    positions = sum(len(seg[-1]) for seg in cfg.layout())   # p<j>, l<j>
    assert len(bd) == (positions if pruned else 0)
    for k in bd:
        assert not got.pop(k).any()
    assert list(got) == list(want)
    H, Hkv, n = cfg.n_heads, cfg.n_kv_heads, cfg.eff_qk
    for k in want:
        shape = want[k].shape
        if pruned and k.endswith("mixer/q_scale"):
            shape = shape[:-1] + (H, n)
        elif pruned and k.endswith("mixer/k_scale"):
            shape = shape[:-1] + (Hkv, n)
        assert (got[k].shape, got[k].dtype) == (shape, want[k].dtype), k
    theta = {0: cfg.rope_theta_local, 5: cfg.rope_theta}
    for j, th in theta.items():
        inv = (1.0 / th ** (np.arange(0, n, 2) / n)).astype(np.float32)
        np.testing.assert_allclose(
            got[f"seg0/p{j}/mixer/rope_inv_k"], np.tile(inv, (1, Hkv, 1)),
            rtol=1e-6)


@pytest.mark.parametrize("n_layers,pruned", SETUPS)
def test_apply_lm_logits_match_jax(n_layers, pruned):
    jm, jp, pm, pp = _setup(n_layers, pruned)
    toks = _tokens(pm.cfg, PREFILL)
    want, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    got, _ = pm.apply(pp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n_layers,pruned,impl", [
    (6, False, None), (8, False, None), (8, True, None),
    (8, True, "interpret")])
def test_prefill_and_ring_decode_past_the_window_match_jax(
        n_layers, pruned, impl, monkeypatch):
    """A 20-token prefill fills and wraps every ring (window 8), then 26
    decode steps wrap it three more times; the logits of each step and the
    final cache (rings, ``abs_pos``, the global layers' rows) equal JAX's."""
    if impl:
        monkeypatch.setenv("REPRO_DECODE_IMPL", impl)
    jm, jp, pm, pp = _setup(n_layers, pruned)
    V = pm.cfg.vocab_size
    toks = _tokens(pm.cfg, PREFILL, seed=1)
    prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, MAX_LEN))
    decode = jax.jit(jm.decode_step)
    wl, wc = prefill(jp, jnp.asarray(toks))
    gl, gc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=RTOL,
                               atol=ATOL)
    _close_tree(gc, wc)
    ring = gc["seg0"]["p0"]
    assert ring["k"].shape[2] == pm.cfg.sliding_window
    assert gc["seg0"]["p5"]["k"].shape[2] == MAX_LEN
    tok = np.asarray(jnp.argmax(wl[:, -1, :V], -1))[:, None].astype(np.int32)
    for step in range(STEPS):
        wl, wc = decode(jp, jnp.asarray(tok), wc)
        gl, gc = pm.decode_step(pp, torch.from_numpy(tok), gc)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {step}")
        tok = np.asarray(jnp.argmax(wl[:, -1, :V], -1))[:, None] \
            .astype(np.int32)
    _close_tree(gc, wc)
    last = PREFILL + STEPS
    np.testing.assert_array_equal(
        np.sort(gc["seg0"]["p0"]["abs_pos"][0, 0].numpy()),
        np.arange(last - 8, last))


@pytest.mark.parametrize("n_layers", [6, 8])
def test_empty_cache_holds_minus_one_abs_pos_and_decodes_as_jax(n_layers):
    """``init_lm_cache`` repeats one layer's empty cache over a scanned
    segment's reps (JAX broadcasts it): every ring's ``abs_pos`` is -1, so
    a decode from the empty cache attends to its own token only."""
    jm, jp, pm, pp = _setup(n_layers, False)
    want = jm.init_cache(2, MAX_LEN)
    got = pm.init_cache(2, MAX_LEN, "cpu")
    _close_tree(got, want)
    flat = interop.flatten(got)
    rings = [k for k in flat if k.endswith("abs_pos")]
    assert len(rings) == (5 if n_layers == 6 else 7)   # layers 6, 7: swa
    assert all((flat[k] == -1).all() for k in rings)
    assert flat["seg0/p0/abs_pos"].shape == (1, 2, 8)
    tok = _tokens(pm.cfg, 1, seed=4)
    decode = jax.jit(jm.decode_step)
    for _ in range(3):
        wl, want = decode(jp, jnp.asarray(tok), want)
        gl, got = pm.decode_step(pp, torch.from_numpy(tok), got)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=RTOL,
                                   atol=ATOL)
        tok = np.asarray(jnp.argmax(wl[:, -1], -1))[:, None].astype(np.int32)
    _close_tree(got, want)


def test_ring_decode_writes_slot_pos_mod_window_in_place():
    jm, jp, pm, pp = _setup(6, False)
    _, cache = pm.prefill(pp, {"tokens": torch.from_numpy(
        _tokens(pm.cfg, 11, seed=2))}, MAX_LEN)
    ring = cache["seg0"]["p0"]
    ptrs = (ring["k"].data_ptr(), ring["abs_pos"].data_ptr())
    before = ring["k"].clone()
    _, out = pm.decode_step(pp, torch.zeros((2, 1), dtype=torch.int32),
                            cache)
    assert out is cache
    assert (ring["k"].data_ptr(), ring["abs_pos"].data_ptr()) == ptrs
    changed = (ring["k"] != before).any(dim=(0, 3, 4))     # (B, S) slots
    assert changed.nonzero().tolist() == [[0, 11 % 8], [1, 11 % 8]]
    assert ring["abs_pos"][0, :, 11 % 8].tolist() == [11, 11]


@pytest.mark.parametrize("T,max_len", [(5, 64), (8, 64), (21, 64), (21, 6)])
def test_window_cache_equals_jax(T, max_len):
    """Fewer, as many and more tokens than the window, and a max_len below
    it (the ring is then max_len long)."""
    jcfg, pcfg = lm_cfgs(arch=ARCH)
    rng = np.random.default_rng(T)
    c = {"k": rng.standard_normal((2, T, 1, 16)).astype(np.float32),
         "v": rng.standard_normal((2, T, 1, 16)).astype(np.float32),
         "pos": np.full((2,), T, np.int32)}
    want = jax_window_cache({k: jnp.asarray(v) for k, v in c.items()}, jcfg,
                            max_len)
    got = _window_cache({k: torch.from_numpy(v) for k, v in c.items()}, pcfg,
                        max_len)
    _close_tree(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_head", [False, True])
def test_rms_head_norm_matches_jax(dtype, per_head):
    """fp32 math, the result in the input's dtype; the scale shared by the
    heads (d,) or per head (H, d), as a pruned class-3 layer holds it."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal((4, 16) if per_head else (16,))) \
        .astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = jax_head_norm(jx, jnp.asarray(scale), 1e-5)
    got = rms_head_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(scale), 1e-5)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# serving: the engine takes exact-length prefills (not a pure-attn stack)
# ---------------------------------------------------------------------------

# (prompt, gen): prompts shorter and longer than the window of 8, decode
# that wraps the rings
SPECS = [(5, 12), (19, 3), (9, 20), (14, 1), (23, 9), (7, 15)]


@pytest.fixture(scope="module")
def served():
    jm, jp, pm, pp = _setup(8, False)
    rng = np.random.RandomState(5)
    toks = [rng.randint(0, pm.cfg.vocab_size, size=p).astype(np.int32)
            for p, _ in SPECS]
    jeng = JaxEngine(jm, jp, n_slots=3, max_len=MAX_LEN)
    streams = [c.tokens.tolist() for c in jeng.run(
        [JaxRequest(rid=i, tokens=t, gen=g)
         for i, (t, (_, g)) in enumerate(zip(toks, SPECS))])]
    return {"model": pm, "params": pp, "streams": streams,
            "trace": [Request(rid=i, tokens=t, gen=g)
                      for i, (t, (_, g)) in enumerate(zip(toks, SPECS))]}


@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_streams_equal_the_jax_engine(served, chunk):
    eng = ServeEngine(served["model"], served["params"], n_slots=3,
                      max_len=MAX_LEN)
    assert not eng.ragged_ok
    comps = eng.run(served["trace"], prefill_chunk=chunk)
    assert [c.tokens.tolist() for c in comps] == served["streams"]
    buckets = [k for k in eng.stats if k.startswith("prefill_b")]
    assert buckets and eng.stats["admits"] == len(SPECS)
    if chunk is None:
        assert eng.stats["walk_steps"] == 0       # whole-prompt prefills
    else:
        assert eng.stats["chunk_steps"] > 0


def test_streams_pass_the_greedy_chain_check(served):
    for req, out in zip(served["trace"], served["streams"]):
        assert greedy_chain_ok(served["model"], served["params"], req, out), \
            req.rid
