"""The port's serving front-end and prefix cache against the JAX package's.

On the reduced qwen2-1.5b (``kv`` contract: a hit rewinds the entry),
rwkv6-3b and jamba-1.5-large-398b (``recurrent`` contract: whole-entry
state snapshots), fp32 on the CPU, on the same numpy-made weights
(``torch_parity.jax_params``), both packages' ``ServeFrontend`` over their
engines serve the same ``synthetic_trace``: Poisson arrivals, a shared
12-token prefix, a deadline mix, a queue of depth 2, FIFO and
shortest-prompt-first, atomic and chunked admits, all under a manual
clock that advances 0.1 s a step. Per-request status and tokens must be
identical, and so must the prefix-cache counters. The port's engine
updates its cache in place, so every entry is also held bitwise to its
state at insertion (the copy rule of ``repro_torch.serve.prefix``).
"""
from __future__ import annotations

import asyncio
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import PrefixCache as JaxPrefixCache  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import ServeFrontend as JaxFrontend  # noqa: E402
from repro.serve import errors as jax_errors  # noqa: E402
from repro.serve import synthetic_trace as jax_trace  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from repro_torch.serve import (AsyncServeFrontend, PrefixCache,  # noqa: E402
                               Request, ServeEngine, ServeFrontend, errors,
                               synthetic_trace)
from torch_parity import jax_params, lm_cfgs  # noqa: E402
from torch_serve_parity import (MAX_LEN, SnapshotCache,  # noqa: E402
                                check_frontend_parity, _models)


@pytest.mark.parametrize("spf,chunk", [(False, None), (True, None),
                                       (False, 4)])
def test_frontend_matches_the_jax_frontend(spf, chunk):
    check_frontend_parity("qwen2-1.5b", spf, chunk)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b"])
def test_a_prefix_hit_leaves_its_entry_bit_unchanged(arch):
    """A, then B sharing A's whole prompt and more, then A's prompt again:
    B walks its suffix on a copy, so the entry A inserted is bitwise what
    A's prefill left, and the third request (an exact repeat of A, a hit
    on A's entry) streams what A streamed and what a cold engine streams.
    Under ``recurrent`` A also inserts its first-chunk snapshot, which the
    walk past it must not reach either."""
    m = _models(arch)
    rng = np.random.RandomState(2)
    a = rng.randint(0, m["cfg"].vocab_size, size=19).astype(np.int32)
    b = np.concatenate([a, rng.randint(0, m["cfg"].vocab_size, size=5)
                        .astype(np.int32)])
    reqs = [Request(rid=i, tokens=t, gen=6) for i, t in enumerate((a, b, a))]
    eng = ServeEngine(m["pm"], m["pp"], n_slots=1, max_len=MAX_LEN)
    pc = SnapshotCache(cap=4)
    outs = []
    eng.begin()
    for req in reqs:
        eng.admit(req, 0, prefix_cache=pc)
        while not eng.decode_step():
            pass
        outs.append(eng.retire(0).tokens.tolist())
        assert pc.changed() == []
    assert eng.stats["prefix_hits"] == 2
    assert len(pc) == (3 if arch == "rwkv6-3b" else 2)
    cold = ServeEngine(m["pm"], m["pp"], n_slots=1, max_len=MAX_LEN)
    assert outs == [c.tokens.tolist() for c in cold.run(reqs)]
    assert outs[0] == outs[2]


@pytest.mark.parametrize("arch", ["gemma3-1b", "seamless-m4t-large-v2"])
def test_prefix_cache_refused_on_an_ineligible_stack(arch):
    """A window ring (gemma3) and an encoder memory (seamless) are not
    replayable: both packages refuse a prefix cache with one message."""
    jcfg, pcfg = lm_cfgs(arch=arch)
    mem = 8 if pcfg.family == "encdec" else None
    params = jax_params(jcfg, seed=1)
    eng = ServeEngine(pt_build(pcfg), interop.from_numpy(params, "cpu"),
                      n_slots=1, max_len=32, mem_len=mem)
    jeng = JaxEngine(jax_build(jcfg), params, n_slots=1, max_len=32,
                     mem_len=mem)
    assert not eng.prefix_eligible() and not jeng.prefix_eligible()
    refusal = errors.msg("prefix_ineligible", name=pcfg.name)
    assert refusal == jax_errors.msg("prefix_ineligible", name=jcfg.name)
    with pytest.raises(ValueError, match=re.escape(refusal)):
        ServeFrontend(eng, prefix_cache=PrefixCache())
    with pytest.raises(ValueError, match=re.escape(refusal)):
        JaxFrontend(jeng, prefix_cache=JaxPrefixCache())
    with pytest.raises(ValueError, match=re.escape(refusal)):
        eng.warmup(prompt_lens=[8], prefix=True)


def test_async_frontend_interleaves_and_its_stepping_task_ends_when_idle():
    m = _models("qwen2-1.5b")
    eng = ServeEngine(m["pm"], m["pp"], n_slots=2, max_len=MAX_LEN)
    afe = AsyncServeFrontend(ServeFrontend(eng, queue_depth=4))
    order = []

    def req(rid, plen):
        return Request(rid=rid, tokens=(np.arange(plen) % 7 + 1 + rid)
                       .astype(np.int32), gen=4)

    async def consume(r, tag):
        h = await afe.submit(r)
        toks = []
        async for t in afe.stream(h):
            order.append(tag)
            toks.append(t)
        return toks

    async def main():
        out = await asyncio.gather(consume(req(0, 4), "A"),
                                   consume(req(1, 5), "B"))
        for _ in range(8):                  # let the task observe idle
            await asyncio.sleep(0)
        assert afe._task is not None and afe._task.done()
        return out

    ta, tb = asyncio.run(main())
    assert len(ta) == len(tb) == 4
    last_a = len(order) - 1 - order[::-1].index("A")
    assert order.index("B") < last_a, order
    cold = ServeEngine(m["pm"], m["pp"], n_slots=2, max_len=MAX_LEN)
    assert [ta, tb] == [c.tokens.tolist()
                        for c in cold.run([req(0, 4), req(1, 5)])]


@pytest.mark.parametrize("kw", [
    {}, {"rate": 3.0},
    {"prefix_len": 9, "rate": 3.0},
    {"deadline_range": (0.5, 2.0), "deadline_frac": 0.4},
    {"prefix_len": 5, "deadline_range": (1.0, 3.0), "rate": 2.0},
    {"mem_len": 4, "d_model": 6, "prefix_len": 3,
     "deadline_range": (1.0, 2.0)}])
def test_synthetic_trace_equals_jax_field_by_field(kw):
    base = dict(seed=7, prompt_range=(3, 9), gen_range=(1, 5))
    got = synthetic_trace(10, 50, **base, **kw)
    want = jax_trace(10, 50, **base, **kw)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        assert gd.keys() == wd.keys()
        for k in gd:
            if isinstance(wd[k], np.ndarray):
                np.testing.assert_array_equal(gd[k], wd[k])
            else:
                assert gd[k] == wd[k], k
    if "prefix_len" in kw:
        shared = {g.tokens[:kw["prefix_len"]].tobytes() for g in got}
        assert len(shared) == 1
    plain = synthetic_trace(10, 50, **base)
    if "prefix_len" not in kw:      # deadlines move no other draw
        assert [g.tokens.tolist() for g in got] == \
            [p.tokens.tolist() for p in plain]
