"""The port's RWKV-6 path against the JAX package: time mix, channel mix,
LM logits, prefill + decode states, and the recurrent serving contract.

rwkv6-3b-reduced (d_model 64, 4 heads of 16, 2 layers, vocab 503) in fp32
on the CPU, on the same numpy-made weights (``torch_parity.jax_params``
carried across by ``interop.from_numpy``). Matmuls and the two exact scans
sum in different orders, so float outputs and state leaves are held to
rtol 1e-4, atol 1e-5; integer leaves (``pos``) must be equal. Greedy token
streams must be byte-identical to the JAX engine's.
"""
from __future__ import annotations

import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import resolve_config  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serve import (RecurrentSlotCache, Request,  # noqa: E402
                               ServeEngine, errors, run_static_trace)
from torch_parity import greedy_chain_ok, jax_params  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
SLOTS, MAX_LEN = 3, 96
# (prompt, gen): the first chunk is 8 * ((P - 1) // 8) (at least 1), so
# these walk 1..7 batch-1 steps; 72 and 64 are first chunks of 75 and 70
SPECS = [(7, 5), (8, 1), (9, 6), (15, 3), (17, 8), (31, 4), (75, 6),
         (70, 2), (12, 1), (5, 9)]


def _cfgs():
    jcfg = reduced(get_config("rwkv6-3b"))
    pcfg = resolve_config("rwkv6-3b-reduced")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def lm():
    jcfg, pcfg = _cfgs()
    params = jax_params(jcfg, seed=13)
    return {"jcfg": jcfg, "cfg": pcfg, "np": params,
            "jmodel": jax_build(jcfg),
            "jparams": jax.tree.map(jnp.asarray, params),
            "model": pt_build(pcfg),
            "params": interop.from_numpy(params, device="cpu")}


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=err_msg)


def _close_tree(got, want):
    g = interop.flatten(interop.to_numpy(got))
    w = interop.flatten(jax.tree.map(np.asarray, want))
    assert list(g) == list(w)
    for k in w:
        assert (g[k].shape, g[k].dtype) == (w[k].shape, w[k].dtype), k
        if w[k].dtype.kind == "i":
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            _close(g[k], w[k], err_msg=k)


def _layer(params, sub, rep=0):
    """One layer's ``sub`` params of the stacked segment, as numpy."""
    return jax.tree.map(lambda a: np.asarray(a)[rep],
                        params["seg0"]["p0"][sub])


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def test_init_tree_has_the_jax_key_paths(lm):
    want = interop.flatten(jax.tree.map(np.asarray, lm["jparams"]))
    got = interop.flatten(interop.to_numpy(
        lm["model"].init(torch.Generator().manual_seed(0), "cpu")))
    assert list(got) == list(want)
    assert "seg0/p0/mixer/w_lora_a" in got and "seg0/p0/mlp/wv" in got
    for k in want:
        assert (got[k].shape, got[k].dtype) == (want[k].shape, want[k].dtype)


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_rwkv_time_matches_jax(lm, with_state):
    cfg = lm["cfg"]
    p = _layer(lm["np"], "mixer", rep=1)
    rng = np.random.default_rng(3)
    B, T, D, H, N = 2, 20, cfg.d_model, cfg.n_heads, cfg.rwkv.head_dim
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    state = {"shift": rng.standard_normal((B, D)).astype(np.float32),
             "wkv": rng.standard_normal((B, H, N, N)).astype(np.float32)} \
        if with_state else None
    wy, ws = jax_ssm.apply_rwkv_time(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), lm["jcfg"],
        state=None if state is None else jax.tree.map(jnp.asarray, state))
    pstate = None if state is None else interop.from_numpy(state, "cpu")
    gy, gs = ssm.apply_rwkv_time(interop.from_numpy(p, "cpu"),
                                 torch.from_numpy(x), cfg, state=pstate)
    _close(gy, wy)
    _close_tree(gs, ws)
    if with_state:          # the given state is updated in place
        assert gs is pstate


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_rwkv_channel_with_bv_comp_matches_jax(lm, with_state):
    cfg = lm["cfg"]
    rng = np.random.default_rng(4)
    p = dict(_layer(lm["np"], "mlp"),
             bv_comp=rng.standard_normal(cfg.d_model).astype(np.float32))
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    state = {"shift": rng.standard_normal((2, cfg.d_model))
             .astype(np.float32)} if with_state else None
    wy, ws = jax_ssm.apply_rwkv_channel(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), lm["jcfg"],
        state=None if state is None else jax.tree.map(jnp.asarray, state))
    pstate = None if state is None else interop.from_numpy(state, "cpu")
    gy, gs = ssm.apply_rwkv_channel(interop.from_numpy(p, "cpu"),
                                    torch.from_numpy(x), cfg, state=pstate)
    _close(gy, wy)
    _close_tree(gs, ws)
    # the bias is really applied: without it the output moves
    del p["bv_comp"]
    gy0, _ = ssm.apply_rwkv_channel(interop.from_numpy(p, "cpu"),
                                    torch.from_numpy(x), cfg)
    assert float((gy0 - gy).abs().max()) > 1e-3


@pytest.mark.parametrize("T", [20, 192])
def test_apply_lm_logits_match_jax(lm, T):
    """T = 192 sends the JAX recurrence down its chunked path on the CPU;
    the port runs its exact scan on both."""
    toks = _tokens(lm["cfg"], 2, T, seed=T)
    want, _ = lm["jmodel"].apply(lm["jparams"], {"tokens": jnp.asarray(toks)})
    got, aux = lm["model"].apply(lm["params"],
                                 {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape == (2, T, lm["cfg"].padded_vocab)
    _close(got, want)
    assert float(aux) == 0.0


def test_prefill_and_decode_match_jax(lm):
    """Prefill then 8 greedy decode steps: logits at every step and every
    state leaf after the prefill and after the last step."""
    V = lm["cfg"].vocab_size
    toks = _tokens(lm["cfg"], 2, 13, seed=1)
    jm, pm = lm["jmodel"], lm["model"]
    decode = jax.jit(jm.decode_step)
    wl, wc = jm.prefill(lm["jparams"], {"tokens": jnp.asarray(toks)}, 32)
    gl, gc = pm.prefill(lm["params"], {"tokens": torch.from_numpy(toks)}, 32)
    _close(gl, wl)
    _close_tree(gc, wc)
    assert set(gc["seg0"]["p0"]) == {"time", "channel"}
    tok = np.asarray(jnp.argmax(wl[:, -1, :V], -1))[:, None].astype(np.int32)
    for step in range(8):
        wl, wc = decode(lm["jparams"], jnp.asarray(tok), wc)
        gl, out = pm.decode_step(lm["params"], torch.from_numpy(tok), gc)
        assert out is gc
        _close(gl, wl, err_msg=f"step {step}")
        tok = np.asarray(jnp.argmax(wl[:, -1, :V], -1))[:, None] \
            .astype(np.int32)
    _close_tree(gc, wc)
    np.testing.assert_array_equal(gc["pos"].numpy(), [21, 21])


def test_ragged_prefill_raises_for_rwkv(lm):
    toks = torch.from_numpy(_tokens(lm["cfg"], 2, 8, seed=2))
    with pytest.raises(ValueError, match="global-attention"):
        lm["model"].prefill(lm["params"], {"tokens": toks}, 16,
                            lengths=torch.tensor([5, 8]))


@pytest.fixture(scope="module")
def served(lm):
    rng = np.random.RandomState(5)
    toks = [rng.randint(0, lm["cfg"].vocab_size, size=p).astype(np.int32)
            for p, _ in SPECS]
    jtrace = [JaxRequest(rid=i, tokens=t, gen=g)
              for i, (t, (_, g)) in enumerate(zip(toks, SPECS))]
    jeng = JaxEngine(lm["jmodel"], lm["jparams"], n_slots=SLOTS,
                     max_len=MAX_LEN)
    return {"streams": [c.tokens.tolist() for c in jeng.run(jtrace)],
            "stats": dict(jeng.stats),
            "trace": [Request(rid=i, tokens=t, gen=g)
                      for i, (t, (_, g)) in enumerate(zip(toks, SPECS))]}


def _engine(lm, n_slots=SLOTS, max_len=MAX_LEN):
    return ServeEngine(lm["model"], lm["params"], n_slots=n_slots,
                       max_len=max_len)


@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_streams_equal_the_jax_engine(lm, served, chunk):
    eng = _engine(lm)
    assert eng.contract == "recurrent" and not eng.ragged_ok
    assert isinstance(eng.slotcache, RecurrentSlotCache)
    comps = eng.run(served["trace"], prefill_chunk=chunk)
    assert [c.tokens.tolist() for c in comps] == served["streams"]
    assert [len(c.tokens) for c in comps] == [g for _, g in SPECS]
    st = eng.stats
    if chunk is None:
        for key in ("admits", "refills", "decode_steps", "decode_lanes",
                    "max_concurrent", "prefill_b8", "prefill_b16",
                    "prefill_b32", "prefill_b64", "prefill_b96"):
            assert st[key] == served["stats"][key], key
        # every prompt walks P - 8 * ((P - 1) // 8) tokens (at least 1
        # token goes to the first chunk)
        assert st["walk_steps"] == sum(
            p - max(1, 8 * ((p - 1) // 8)) for p, _ in SPECS)
    else:
        assert st["chunk_steps"] > 0


def test_streams_pass_the_greedy_chain_check(lm, served):
    for req, out in zip(served["trace"], served["streams"]):
        assert greedy_chain_ok(lm["model"], lm["params"], req, out), req.rid


def _lane_is_zero(eng, slot):
    axes = eng.slotcache.batch_axes
    return all(bool((t.select(axes[path], slot) == 0).all())
               for path, t in interop.flatten(eng.slotcache.cache).items())


def test_retire_and_cancel_leave_the_slot_lanes_zero(lm, served):
    eng = _engine(lm, n_slots=2)
    eng.begin()
    a, b, c = (served["trace"][i] for i in (4, 2, 6))
    eng.admit(a, 0)
    eng.admit(b, 1)
    assert not _lane_is_zero(eng, 0) and not _lane_is_zero(eng, 1)
    eng.decode_step()
    eng.decode_step()
    assert eng.cancel(0) == served["streams"][4][:3]
    assert _lane_is_zero(eng, 0) and not _lane_is_zero(eng, 1)
    eng.admit(c, 0)
    done = {}
    while eng.active_count():
        for slot in eng.decode_step():
            comp = eng.retire(slot)
            done[comp.rid] = comp.tokens.tolist()
            assert _lane_is_zero(eng, slot)
    assert done == {c.rid: served["streams"][6], b.rid: served["streams"][2]}


def test_slot_bytes_do_not_depend_on_max_len(lm):
    cfg = lm["cfg"]
    D, H, N = cfg.d_model, cfg.n_heads, cfg.rwkv.head_dim
    want = 4 + cfg.n_layers * 4 * (2 * D + H * N * N)   # pos, shifts, wkv
    for max_len in (32, 96, 1024):
        assert _engine(lm, max_len=max_len).slotcache.slot_bytes == want


def test_static_baseline_refuses_a_recurrent_stack(lm, served):
    msg = re.escape(errors.msg("static_trace_ineligible"))
    with pytest.raises(ValueError, match=msg):
        run_static_trace(lm["model"], lm["params"], served["trace"],
                         n_slots=SLOTS, max_len=MAX_LEN)
    with pytest.raises(ValueError, match=msg):
        pt_serve.main(["--arch", "rwkv6-3b-reduced", "--device", "cpu",
                       "--trace", "2", "--compare-static"])


def test_serve_cli_fixed_batch_loop_and_trace():
    res = pt_serve.main(["--arch", "rwkv6-3b-reduced", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "8", "--gen", "5"])
    assert tuple(res["tokens"].shape) == (2, 5)
    res = pt_serve.main(["--arch", "rwkv6-3b-reduced", "--device", "cpu",
                         "--trace", "4", "--slots", "2", "--max-len", "48",
                         "--prompt-range", "6,20", "--gen-range", "1,8"])
    assert len(res["completions"]) == 4 and res["stats"]["walk_steps"] > 0


@pytest.mark.parametrize("compensate", [True, False])
def test_serve_cli_serves_a_pruned_rwkv_checkpoint_with_its_bv_comp(
        lm, tmp_path, compensate):
    """CORP pruning of an RWKV channel mix adds ``bv_comp``. The JAX CLI's
    template has no such leaf and drops it; the port's pruned template has
    the slot, so a JAX-written checkpoint serves with its bias: the served
    params' logits equal the in-memory pruned params'. A
    ``--no-compensate`` checkpoint has no ``bv_comp`` and serves it as
    zeros, which is the model it pruned."""
    from repro.checkpoint import restore_checkpoint as jax_restore
    from repro.checkpoint import save_checkpoint as jax_save
    from repro.core import PruneConfig, corp_prune
    from repro.data import calib_stream as jax_calib_stream
    jcfg = lm["jcfg"]
    new_params, new_cfg, _ = corp_prune(
        lm["jmodel"], lm["jparams"],
        jax_calib_stream(jcfg, n_samples=16, batch=8, seq=32),
        PruneConfig(0.5, 0.5, compensate=compensate))
    assert ("bv_comp" in new_params["seg0"]["p0"]["mlp"]) == compensate
    jax_save(str(tmp_path), 0, new_params, extra={"config": new_cfg.name})
    res = pt_serve.main(["--arch", "rwkv6-3b-reduced", "--sparsity", "0.5",
                         "--ckpt-in", str(tmp_path), "--device", "cpu",
                         "--trace", "2", "--slots", "2", "--max-len", "40",
                         "--prompt-range", "6,16", "--gen-range", "2,5"])
    assert len(res["completions"]) == 2
    bv = res["params"]["seg0"]["p0"]["mlp"]["bv_comp"]
    if compensate:
        np.testing.assert_array_equal(
            bv.numpy(), np.asarray(new_params["seg0"]["p0"]["mlp"]
                                   ["bv_comp"]))
        assert bv.abs().max() > 0
    else:
        assert not bv.any()
    toks = torch.from_numpy(_tokens(jcfg, 2, 12, seed=5))
    mem = interop.from_numpy(jax.tree.map(np.asarray, new_params),
                             device="cpu")
    want = res["model"].apply(mem, {"tokens": toks})[0]
    got = res["model"].apply(res["params"], {"tokens": toks})[0]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the JAX CLI's template drops the bias: another model when compensated
    jtmpl = jax_build(new_cfg).init(jax.random.PRNGKey(0))
    dropped, _ = jax_restore(str(tmp_path), 0, jtmpl)
    assert "bv_comp" not in dropped["seg0"]["p0"]["mlp"]
    jgot = np.asarray(jax_build(new_cfg).apply(
        dropped, {"tokens": jnp.asarray(toks.numpy())})[0])
    err = float(np.abs(jgot - want.numpy()).max())
    assert (err > 1e-3) if compensate else (err <= 1e-4)
