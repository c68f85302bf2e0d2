"""The port's continuous-batching engine against the JAX package's engine.

qwen2-1.5b-reduced in fp32 on the CPU, on the same numpy-made weights
(the stream, greedy-chain and static-trace parity checks also on
granite-8b-reduced and deepseek-7b-reduced). The
trace has 10 requests over 3 slots at max_len 64, prompts on both sides of
the bucket edges 8/16/32 and three ``gen=1`` requests, so slots retire and
refill mid-flight. Greedy token streams must be byte-identical to the JAX
engine's, with and without chunked prefill; the refusals of unported layers
are built from ``repro_torch.serve.errors`` or name the JAX module.
"""
from __future__ import annotations

import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import greedy_chain_ok as jax_greedy_chain_ok  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import run_static_trace as jax_static  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from repro_torch.serve import (PrefixCache, Request,  # noqa: E402
                               ServeEngine, errors, run_static_trace)
from torch_parity import greedy_chain_ok, jax_params, lm_cfgs  # noqa: E402

SLOTS, MAX_LEN = 3, 64
# (prompt, gen): prompts at and across the bucket edges 8, 16, 32
SPECS = [(7, 5), (8, 1), (9, 6), (15, 3), (16, 1), (17, 8), (31, 4),
         (33, 2), (5, 9), (12, 1)]


ARCHS = ("qwen2-1.5b", "granite-8b", "deepseek-7b")
_LMS = {}


def _lm(arch):
    """The JAX engine's run of the trace and both packages' models, once
    per module for each config."""
    if arch not in _LMS:
        _LMS[arch] = _make_lm(arch)
    return _LMS[arch]


@pytest.fixture(scope="module")
def lm():
    return _lm("qwen2-1.5b")


@pytest.fixture(scope="module", params=ARCHS)
def zoo_lm(request):
    return _lm(request.param)


def _make_lm(arch):
    jcfg, pcfg = lm_cfgs(arch=arch)
    params = jax_params(jcfg, seed=11)
    rng = np.random.RandomState(5)
    toks = [rng.randint(0, jcfg.vocab_size, size=p).astype(np.int32)
            for p, _ in SPECS]
    jmodel, jp = jax_build(jcfg), jax.tree.map(jnp.asarray, params)
    jtrace = [JaxRequest(rid=i, tokens=t, gen=g)
              for i, (t, (_, g)) in enumerate(zip(toks, SPECS))]
    jeng = JaxEngine(jmodel, jp, n_slots=SLOTS, max_len=MAX_LEN)
    streams = [c.tokens.tolist() for c in jeng.run(jtrace)]
    return {
        "jmodel": jmodel, "jparams": jp, "stats": dict(jeng.stats),
        "streams": streams, "jtrace": jtrace,
        "model": pt_build(pcfg),
        "params": interop.from_numpy(params, device="cpu"),
        "trace": [Request(rid=i, tokens=t, gen=g)
                  for i, (t, (_, g)) in enumerate(zip(toks, SPECS))],
    }


def _engine(lm, n_slots=SLOTS):
    return ServeEngine(lm["model"], lm["params"], n_slots=n_slots,
                       max_len=MAX_LEN)


@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_streams_equal_the_jax_engine(zoo_lm, chunk):
    lm = zoo_lm
    eng = _engine(lm)
    comps = eng.run(lm["trace"], prefill_chunk=chunk)
    assert [c.rid for c in comps] == list(range(len(SPECS)))
    assert [c.tokens.tolist() for c in comps] == lm["streams"]
    assert [len(c.tokens) for c in comps] == [g for _, g in SPECS]
    st = eng.stats
    assert st["admits"] == len(SPECS) and st["refills"] >= len(SPECS) - SLOTS
    if chunk is None:
        for key in ("admits", "refills", "decode_steps", "decode_lanes",
                    "max_concurrent"):
            assert st[key] == lm["stats"][key], key
    else:
        assert st["chunk_steps"] > 0        # prompts > 8 took several chunks
    assert st["decode_s"] > 0 and st["prefill_s"] > 0


def test_streams_pass_the_greedy_chain_check(zoo_lm):
    """Every stream equals a greedy rollout of ONE full forward of the
    port's model (``tests/helpers.py::greedy_chain_ok`` on the port)."""
    lm = zoo_lm
    for req, out in zip(lm["trace"], lm["streams"]):
        assert greedy_chain_ok(lm["model"], lm["params"], req, out), req.rid


def test_cancel_frees_a_slot_that_is_then_refilled(lm):
    eng = _engine(lm, n_slots=2)
    eng.begin()
    a, b, c = (lm["trace"][i] for i in (5, 2, 8))
    eng.admit(a, 0)
    eng.admit(b, 1)
    eng.decode_step()
    eng.decode_step()
    partial = eng.cancel(0)
    assert partial == lm["streams"][5][:3]
    assert eng.free_slots() == [0] and eng.stats["cancels"] == 1
    eng.admit(c, 0)
    assert eng.stats["refills"] == 1
    done = {}
    while eng.active_count():
        for slot in eng.decode_step():
            comp = eng.retire(slot)
            done[comp.rid] = comp.tokens.tolist()
    assert done == {c.rid: lm["streams"][8], b.rid: lm["streams"][2]}
    with pytest.raises(ValueError, match=errors.msg("cancel_free_slot",
                                                    slot=0)):
        eng.cancel(0)


def test_a_free_slot_decodes_past_max_len(lm):
    """Slot 1 stays free while slot 0 serves two requests back to back:
    its lane decodes more than max_len steps, its ``pos`` walks past the
    cache, and the out-of-bounds rows are dropped without raising."""
    eng = _engine(lm, n_slots=2)
    eng.begin()
    rng = np.random.RandomState(9)
    reqs = [Request(rid=i, tokens=rng.randint(0, lm["model"].cfg.vocab_size,
                                              size=4).astype(np.int32),
                    gen=40) for i in range(2)]
    outs = []
    for req in reqs:
        eng.admit(req, 0)
        while not eng.slots[0].free:
            if eng.decode_step():
                outs.append(eng.retire(0).tokens.tolist())
    assert eng.stats["decode_steps"] == 78 > MAX_LEN
    assert int(eng.slotcache.cache["pos"][1]) == 78
    assert int(eng.slotcache.cache["seg0"]["p0"]["pos"].max()) == 78
    for req, out in zip(reqs, outs):
        jreq = JaxRequest(rid=req.rid, tokens=req.tokens, gen=req.gen)
        assert jax_greedy_chain_ok(lm["jmodel"], lm["jparams"], jreq, out)


def test_run_static_trace_equals_jax(zoo_lm):
    lm = zoo_lm
    want = jax_static(lm["jmodel"], lm["jparams"], lm["jtrace"],
                      n_slots=SLOTS, max_len=MAX_LEN)
    got = run_static_trace(lm["model"], lm["params"], lm["trace"],
                           n_slots=SLOTS, max_len=MAX_LEN)
    assert [c.tokens.tolist() for c in got] == \
        [c.tokens.tolist() for c in want] == lm["streams"]


def test_serve_cli_runs_a_pruned_jax_checkpoint(tmp_path):
    """``--sparsity 0.5 --ckpt-in`` serves a checkpoint the JAX package
    wrote: qk 16 -> 8 while dv stays 16, so the slot cache's K rows shrink;
    streams equal the JAX engine's on the same weights."""
    from repro.checkpoint import save_checkpoint as jax_save
    jcfg, _ = lm_cfgs(pruned=True)
    params = jax_params(jcfg, seed=2)
    jax_save(str(tmp_path), 0, params, extra={"config": jcfg.name})
    res = pt_serve.main(["--arch", "qwen2-1.5b-reduced", "--sparsity", "0.5",
                         "--ckpt-in", str(tmp_path), "--device", "cpu",
                         "--trace", "4", "--slots", "2", "--max-len", "48",
                         "--prompt-range", "6,20", "--gen-range", "1,8"])
    cfg = res["model"].cfg
    assert (cfg.eff_qk, cfg.d_head) == (8, 16)
    cache = res["model"].init_cache(2, 48, "meta")["seg0"]["p0"]
    assert cache["k"].shape[-1] == 8 and cache["v"].shape[-1] == 16
    k = res["params"]["seg0"]["p0"]["mixer"]["wk"]
    np.testing.assert_array_equal(
        k.numpy(), params["seg0"]["p0"]["mixer"]["wk"])
    from repro.serve import synthetic_trace as jax_trace
    jeng = JaxEngine(jax_build(jcfg), jax.tree.map(jnp.asarray, params),
                     n_slots=2, max_len=48)
    want = jeng.run(jax_trace(4, jcfg.vocab_size, seed=0,
                              prompt_range=(6, 20), gen_range=(1, 8)))
    assert [c.tokens.tolist() for c in res["completions"]] == \
        [c.tokens.tolist() for c in want]


def test_serve_cli_fixed_batch_loop():
    res = pt_serve.main(["--arch", "qwen2-1.5b-reduced", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "8", "--gen", "5"])
    assert tuple(res["tokens"].shape) == (2, 5)
    assert res["prefill_s"] > 0 and res["decode_s"] > 0


@pytest.mark.parametrize("flag", [["--serve-sharded", "--mesh-shape", "1x2",
                                   "--trace", "2", "--prefix-cache", "2"]])
def test_unported_serve_flags_raise(flag):
    """A prefix cache beside --serve-sharded is not ported (ROADMAP Queue 1
    item 2b-ii): refused by name before any rank starts."""
    with pytest.raises(NotImplementedError, match="--prefix-cache"):
        pt_serve.main(["--arch", "qwen2-1.5b-reduced", "--device", "cpu",
                       *flag])


def test_unported_engine_options_raise(lm, tmp_path):
    """A sharded engine (here on a one-rank mesh) refuses a prefix cache by
    name; an unsharded one takes it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.sharding import ServeSharding
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        sharded = ServeEngine(lm["model"], lm["params"], n_slots=2,
                              max_len=MAX_LEN, sharding=ServeSharding(
                                  make_mesh((1, 1), device_type="cpu")))
        sharded.begin()
        with pytest.raises(NotImplementedError, match="mesh-sharded engine"):
            sharded.admit(lm["trace"][5], 0, prefix_cache=PrefixCache(cap=2))
    finally:
        dist.destroy_process_group()
    eng = _engine(lm)
    pc = PrefixCache(cap=2)
    eng.begin()
    eng.admit(lm["trace"][5], 0, prefix_cache=pc)
    eng.admit(lm["trace"][5], 1, prefix_cache=pc)
    assert pc.stats()["hits"] == eng.stats["prefix_hits"] == 1
    assert eng.stats["prefix_reused_tokens"] == 16 and len(pc) == 1
    outs = {}
    while eng.active_count():
        for slot in eng.decode_step():
            outs[slot] = eng.retire(slot).tokens.tolist()
    assert outs == {0: lm["streams"][5], 1: lm["streams"][5]}
    too_long = Request(rid=7, tokens=np.zeros(60, np.int32), gen=8)
    with pytest.raises(ValueError, match=re.escape(errors.msg(
            "request_exceeds_max_len", rid=7, prompt=60, gen=8,
            max_len=MAX_LEN))):
        eng.admit(too_long, 1)
