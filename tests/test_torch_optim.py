"""The port's optimizer, schedule, gradient compression, data streams,
fault-tolerant loops and plain attention gradient against the JAX package,
on identical numpy inputs (CPU), and torch versions of
``test_substrate.py``'s optimizer and fault tests."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import lm_stream as jax_lm_stream  # noqa: E402
from repro.data import vit_stream as jax_vit_stream  # noqa: E402
from repro.kernels.flash_attention import ref as jax_flash_ref  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import compress as jax_compress  # noqa: E402
from repro.optim import schedule as jax_schedule  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.data import lm_stream, vit_stream  # noqa: E402
from repro_torch.distrib.fault import (TolerantAccumulator,  # noqa: E402
                                       run_with_restarts)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    backward as flash_bwd)
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, compress_grads, ef_init,
                               ef_round_trip, warmup_cosine)

BF16 = jnp.bfloat16


def _np_tree(rng, scale=1.0):
    """Params with the mask's cases: embed/pos/cls (not decayed), a frozen
    rope_inv, 1-D leaves, a stacked norm scale (reps, D) (decayed), a bf16
    matrix and a bf16 vector."""
    def r(*s):
        return (scale * rng.standard_normal(s)).astype(np.float32)
    return {"embed": r(11, 6), "pos": r(1, 5, 6), "cls": r(1, 1, 6),
            "seg0": {"p0": {"ln1": {"scale": r(3, 6)},
                            "mixer": {"wq": r(3, 6, 8), "bq": r(3, 8),
                                      "rope_inv_q": r(3, 2, 4)},
                            "mlp": {"wd": r(3, 8, 6)}}},
            "head": r(6, 11), "head_bias": r(11),
            "wb": r(6, 6).astype(jnp.bfloat16), "bb": r(6).astype(BF16)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree):
    """numpy (bf16 leaves too) -> torch on the CPU."""
    def one(a):
        if a.dtype == BF16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return interop.map_tree(one, tree)


def _flat_np(tree):
    return {k: np.asarray(v.float() if v.dtype == torch.bfloat16 else v)
            for k, v in interop.flatten(tree).items()}


def _flat_jax(tree):
    out = {}
    for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", k)) for k in kp)] = \
            np.asarray(jnp.asarray(v, jnp.float32))
    return out


def _close(got, want, tol=1e-6):
    assert set(got) == set(want)
    for k, w in want.items():
        m = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got[k] - w).max()) <= tol * m, k


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 10, 100),
                                               (1.0, 10, 100), (0.5, 1, 6),
                                               (2e-3, 50, 60)])
def test_warmup_cosine_matches_jax(peak, warmup, total):
    for step in (0, 1, warmup - 1, warmup, warmup + 1, (warmup + total) // 2,
                 total - 1, total, total + 5):
        want = float(jax_schedule.warmup_cosine(
            jnp.asarray(step, jnp.int32), peak=peak, warmup=warmup,
            total=total))
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32),
                            peak=peak, warmup=warmup, total=total)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-30)


@pytest.mark.parametrize("m_dtype,grad_scale", [("float32", 10.0),
                                                ("float32", 1e-3),
                                                ("bfloat16", 10.0)])
def test_adamw_update_matches_jax(m_dtype, grad_scale):
    """Three steps on identical params and gradients: clipping active (a
    gnorm far above 1) or not, m in fp32 or bf16; params, m, v, the int32
    step and gnorm within 1e-6 of each leaf's max |x|."""
    rng = np.random.default_rng(0)
    params = _np_tree(rng)
    cfg_j = jax_adamw.AdamWConfig(m_dtype=m_dtype)
    cfg_p = AdamWConfig(m_dtype=m_dtype)
    pj, pp = _jax(params), _port(params)
    oj, op = jax_adamw.adamw_init(pj, cfg_j), adamw_init(pp, cfg_p)
    for step in range(3):
        grads = _np_tree(rng, grad_scale)
        lr = float(jax_schedule.warmup_cosine(step, peak=3e-2, warmup=1,
                                              total=5))
        pj, oj, mj = jax_adamw.adamw_update(pj, _jax(grads), oj,
                                            jnp.float32(lr), cfg_j)
        pp, op, mp = adamw_update(pp, _port(grads), op,
                                  torch.tensor(lr, dtype=torch.float32),
                                  cfg_p)
        jgn, pgn = float(mj["grad_norm"]), float(mp["grad_norm"])
        assert abs(pgn - jgn) <= 1e-6 * jgn
        _close(_flat_np(pp), _flat_jax(pj))
        _close(_flat_np(op["m"]), _flat_jax(oj["m"]))
        _close(_flat_np(op["v"]), _flat_jax(oj["v"]))
        assert op["step"].dtype == torch.int32
        assert int(op["step"]) == int(oj["step"]) == step + 1
    for k, v in interop.flatten(pp).items():
        assert str(v.dtype)[6:] == str(_flat_jax_dtype(pj)[k])
    assert op["m"]["wb"].dtype == (torch.bfloat16 if m_dtype == "bfloat16"
                                   else torch.float32)
    # the frozen leaf is untouched, a stacked norm scale is decayed
    np.testing.assert_array_equal(
        pp["seg0"]["p0"]["mixer"]["rope_inv_q"].numpy(),
        params["seg0"]["p0"]["mixer"]["rope_inv_q"])


def _flat_jax_dtype(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): v.dtype
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_adamw_masks_follow_jax_paths():
    """Zero gradients: only weight decay moves a leaf, so the decayed set is
    exactly the leaves that moved, in both packages."""
    rng = np.random.default_rng(1)
    params = _np_tree(rng)
    zeros = jax.tree.map(np.zeros_like, params)
    cfg = AdamWConfig(weight_decay=0.5, clip_norm=0.0)
    pp, _, _ = adamw_update(_port(params), _port(zeros),
                            adamw_init(_port(params), cfg), 0.1, cfg)
    pj, _, _ = jax_adamw.adamw_update(
        _jax(params), _jax(zeros),
        jax_adamw.adamw_init(_jax(params)), 0.1,
        jax_adamw.AdamWConfig(weight_decay=0.5, clip_norm=0.0))
    before = _flat_np(_port(params))
    moved_p = {k for k, v in _flat_np(pp).items()
               if not np.array_equal(v, before[k])}
    moved_j = {k for k, v in _flat_jax(pj).items()
               if not np.array_equal(v, before[k])}
    assert moved_p == moved_j
    # a stacked (reps, D) norm scale or bias is decayed; 1-D leaves,
    # embed/pos/cls and the frozen rope table are not
    assert {"seg0/p0/ln1/scale", "seg0/p0/mixer/bq", "wb"} <= moved_p
    assert not moved_p & {"embed", "pos", "cls", "head_bias", "bb",
                          "seg0/p0/mixer/rope_inv_q"}


def test_compress_grads_matches_jax():
    """int8 codes bitwise, scales and residuals within 1e-6, over three
    steps with the residual carried; ties of x / scale round half to
    even in both."""
    rng = np.random.default_rng(2)
    grads0 = _np_tree(rng)
    grads0 = {k: v for k, v in grads0.items() if k not in ("wb", "bb")}
    ej, ep = jax_compress.ef_init(_jax(grads0)), ef_init(_port(grads0))
    for i in range(3):
        grads = jax.tree.map(lambda a: a * (i + 1),
                             _np_tree(rng))
        grads = {k: v for k, v in grads.items() if k not in ("wb", "bb")}
        if i == 0:     # scale 127 / 127 = 1: x / scale ties at .5
            grads["head_bias"] = np.asarray(
                [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 4.5, 5.5, -126.5],
                np.float32)
        (qj, sj), ej2 = jax_compress.compress_grads(_jax(grads), ej)
        (qp, sp), ep2 = compress_grads(_port(grads), ep)
        for k, q in interop.flatten(qp).items():
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), _flat_jax(qj)[k])
        _close(_flat_np(sp), _flat_jax(sj))
        _close(_flat_np(ep2), _flat_jax(ej2))
        dj, ej = jax_compress.ef_round_trip(_jax(grads), ej)
        dp, ep = ef_round_trip(_port(grads), ep)
        _close(_flat_np(dp), _flat_jax(dj))
        _close(_flat_np(ep), _flat_jax(ej))


def test_streams_are_bit_identical_to_jax():
    a = lm_stream(batch=4, seq=12, vocab=37, seed=3, start_step=5,
                  device="cpu")
    b = jax_lm_stream(batch=4, seq=12, vocab=37, seed=3, start_step=5)
    for _ in range(3):
        (sa, ba), (sb, bb) = next(a), next(b)
        assert sa == sb
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(ba[k].numpy(), np.asarray(bb[k]))
    a = vit_stream(batch=3, img=16, n_classes=5, seed=1, start_step=2,
                   device="cpu")
    b = jax_vit_stream(batch=3, img=16, n_classes=5, seed=1, start_step=2)
    for _ in range(2):
        (sa, ba), (sb, bb) = next(a), next(b)
        assert sa == sb
        for k in ("images", "labels"):
            np.testing.assert_array_equal(ba[k].numpy(), np.asarray(bb[k]))


@pytest.mark.parametrize("B,T,S,H,Hkv,dq,dv,causal,window", [
    (2, 9, 9, 4, 2, 8, 8, True, None),       # causal GQA
    (1, 12, 12, 2, 1, 8, 8, True, 4),        # causal window
    (2, 5, 11, 4, 4, 8, 8, True, None),      # T < S, right-aligned
    (1, 7, 13, 4, 2, 12, 6, True, 5),        # dq != dv, window, T < S
    (2, 6, 10, 2, 2, 8, 8, False, None)])    # cross attention
def test_attention_bwd_matches_jax_vjp(B, T, S, H, Hkv, dq, dv, causal,
                                       window):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, H, dq), (B, S, Hkv, dq), (B, S, Hkv, dv)))
    do = rng.standard_normal((B, T, H, dv)).astype(np.float32)
    scale = 0.37
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_ref.attention(
        a, b, c, causal=causal, window=window, scale=scale), q, k, v)
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o = flash_ref.attention(qt, kt, vt, causal=causal, window=window,
                            scale=scale)
    lse = flash_ref.logsumexp(qt, kt, causal=causal, window=window,
                              scale=scale)
    got = flash_bwd.attention_bwd(qt, kt, vt, o, lse, dot, causal=causal,
                                  window=window, scale=scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# torch versions of test_substrate.py's optimizer and fault tests
# ---------------------------------------------------------------------------

def _quadratic_grad(p):
    return {"w": 2.0 * (p["w"] - 1.0), "rope_inv_q": torch.zeros(2)}


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([4.0, -3.0]), "rope_inv_q": torch.ones(2)}
    ocfg = AdamWConfig(weight_decay=0.0, clip_norm=0.0)
    opt = adamw_init(params, ocfg)
    for _ in range(300):
        params, opt, _ = adamw_update(params, _quadratic_grad(params), opt,
                                      0.05, ocfg)
    np.testing.assert_allclose(params["w"].numpy(), 1.0, atol=1e-2)
    np.testing.assert_array_equal(params["rope_inv_q"].numpy(), np.ones(2))


def test_adamw_clipping_and_schedule():
    s = [float(warmup_cosine(t, peak=1.0, warmup=10, total=100))
         for t in [0, 5, 10, 50, 100]]
    assert s[0] == 0.0 and s[1] == pytest.approx(0.5)
    assert s[2] == pytest.approx(1.0)
    assert s[2] > s[3] > s[4] >= 0.1 - 1e-6
    params = {"w": torch.zeros(3)}
    ocfg = AdamWConfig(clip_norm=1.0)
    opt = adamw_init(params, ocfg)
    _, _, m = adamw_update(params, {"w": torch.full((3,), 100.0)}, opt,
                           1e-3, ocfg)
    assert float(m["grad_norm"]) > 100.0   # raw norm reported


def test_adamw_bf16_m_state():
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    ocfg = AdamWConfig(m_dtype="bfloat16")
    opt = adamw_init(params, ocfg)
    assert opt["m"]["w"].dtype == torch.bfloat16
    g = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    p2, o2, _ = adamw_update(params, g, opt, 1e-2, ocfg)
    assert o2["m"]["w"].dtype == torch.bfloat16
    assert o2["v"]["w"].dtype == torch.float32
    assert p2["w"].dtype == torch.bfloat16


def test_tolerant_accumulator_reweights():
    """Dropping batches yields an unbiased mean after n-reweighting."""
    def step(params, batch):
        x = batch["x"]
        return {"n": torch.tensor(float(x.shape[0])), "s1": x.sum(0)}

    rng = np.random.RandomState(0)
    batches = [{"x": torch.from_numpy(rng.randn(16, 4).astype(np.float32)
                                      + 2.0)} for _ in range(20)]

    def fail_some(i):
        if i in (3, 7, 11):
            raise RuntimeError("simulated host loss")

    acc = TolerantAccumulator(step, None, fail_hook=fail_some)
    tot = acc.run(batches)
    assert acc.n_failed == 3 and acc.n_ok == 17
    mean = tot["s1"].numpy() / float(tot["n"])
    np.testing.assert_allclose(mean, 2.0, atol=0.2)
    def fail_all(i):
        raise RuntimeError("simulated host loss")
    with pytest.raises(RuntimeError, match="every calibration batch"):
        TolerantAccumulator(step, None, fail_hook=fail_all).run(batches)


def test_restart_loop_resumes(tmp_path):
    calls = {"fails": 0}

    def make_state():
        return {"x": torch.zeros(())}

    def step_fn(state, step):
        if step == 5 and calls["fails"] == 0:
            calls["fails"] += 1
            raise RuntimeError("simulated crash")
        return {"x": state["x"] + 1.0}

    final = run_with_restarts(make_state, step_fn, ckpt_dir=str(tmp_path),
                              total_steps=10, save_every=2)
    # crash at step 5 -> restart from the step-4 checkpoint -> x ends at 10
    assert float(final["x"]) == 10.0
    assert calls["fails"] == 1

    def always(state, step):
        raise RuntimeError("down")
    with pytest.raises(RuntimeError, match="down"):
        run_with_restarts(make_state, always, ckpt_dir=str(tmp_path / "b"),
                          total_steps=3, save_every=1, max_restarts=2)


def test_ef_int8_compression_converges():
    params = {"w": torch.tensor([4.0, -3.0, 2.0])}
    ocfg = AdamWConfig(weight_decay=0.0, clip_norm=0.0)
    opt = adamw_init(params, ocfg)
    ef = ef_init(params)
    for _ in range(400):
        g, ef = ef_round_trip({"w": 2.0 * (params["w"] - 1.0)}, ef)
        params, opt, _ = adamw_update(params, g, opt, 0.05, ocfg)
    np.testing.assert_allclose(params["w"].numpy(), 1.0, atol=3e-2)


def test_ef_int8_unbiased_over_time():
    """Sum of dequantized grads + final residual == sum of true grads."""
    rng = np.random.RandomState(0)
    ef = ef_init({"a": torch.zeros(32)})
    total_true = np.zeros(32)
    total_sent = np.zeros(32)
    for _ in range(50):
        g = {"a": torch.from_numpy(rng.randn(32).astype(np.float32))}
        total_true += g["a"].numpy()
        sent, ef = ef_round_trip(g, ef)
        total_sent += sent["a"].numpy()
    np.testing.assert_allclose(total_sent + ef["a"].numpy(), total_true,
                               atol=1e-3)
