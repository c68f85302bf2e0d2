"""Differential property test of the port's front-end and router against
the JAX package's, over both packages' pure-Python fake engines.

A seeded random program of submits (random prompts, generation lengths and
deadlines), caller cancels, clock advances, front-end steps, replica kills
and injected admit or decode failures drives one ``ServeFrontend`` of each
package, over one fake engine or a ``ReplicaRouter`` of several, under a
manual clock; then both are stepped until idle, and whatever still waits
(a queue behind a fleet with no live replica) is cancelled. Every request
must end in exactly one terminal status, and each request's status and
tokens must be the same in both packages. The recurrent fake's state
contract is checked after every operation.
"""
from __future__ import annotations

import random
import types

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.serve.frontend as jax_frontend  # noqa: E402
import repro.serve.router as jax_router  # noqa: E402
import repro.serve.testing as jax_testing  # noqa: E402
import repro_torch.serve.frontend as pt_frontend  # noqa: E402
import repro_torch.serve.router as pt_router  # noqa: E402
import repro_torch.serve.testing as pt_testing  # noqa: E402
from hypothesis_shim import given, settings, st  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402
from repro_torch.serve.queue import TERMINAL  # noqa: E402

PACKAGES = {
    "jax": types.SimpleNamespace(fe=jax_frontend, router=jax_router,
                                 testing=jax_testing, Request=JaxRequest),
    "torch": types.SimpleNamespace(fe=pt_frontend, router=pt_router,
                                   testing=pt_testing, Request=Request),
}


def _program(seed, n_replicas, n_ops=60):
    """The random operations, as data both packages replay."""
    rng = random.Random(seed)
    ops, rid = [], 0
    for _ in range(n_ops):
        kind = rng.choices(
            ["submit", "cancel", "advance", "step", "kill", "fail_decode",
             "fail_admit"],
            weights=[5, 1, 2, 5] + ([1, 1, 1] if n_replicas > 1
                                    else [0, 0, 0]))[0]
        if kind == "submit":
            deadline = rng.uniform(0.5, 6.0) if rng.random() < 0.4 else None
            ops.append((kind, rid, rng.randint(1, 7), rng.randint(1, 8),
                        deadline))
            rid += 1
        elif kind == "cancel":
            ops.append((kind, rng.randrange(max(rid, 1))))
        elif kind == "advance":
            ops.append((kind, rng.choice([0.5, 1.0, 2.0])))
        elif kind in ("kill", "fail_decode", "fail_admit"):
            ops.append((kind, rng.randrange(n_replicas)))
        else:
            ops.append((kind,))
    return ops


def _replay(pkg, ops, n_replicas, slots, depth, policy, chunk, recurrent):
    fake = pkg.testing.RecurrentFleetFakeEngine if recurrent \
        else pkg.testing.FleetFakeEngine
    engines = [fake(slots) for _ in range(n_replicas)]
    eng = pkg.router.ReplicaRouter(engines) if n_replicas > 1 \
        else engines[0]
    clk = pkg.testing.ManualClock()
    fe = pkg.fe.ServeFrontend(eng, queue_depth=depth, policy=policy,
                              clock=clk, prefill_chunk=chunk)

    def check():
        if recurrent:
            for e in engines:
                e.check_state()

    for op in ops:
        kind = op[0]
        if kind == "submit":
            _, rid, plen, gen, deadline = op
            toks = (np.arange(plen) % 5 + 1 + rid % 3).astype(np.int32)
            fe.submit(pkg.Request(rid=rid, tokens=toks, gen=gen,
                                  deadline=deadline))
        elif kind == "cancel":
            fe.cancel(op[1])
        elif kind == "advance":
            clk.advance(op[1])
        elif kind == "step":
            fe.step()
        elif kind == "kill":
            eng.kill(op[1])
        elif kind == "fail_decode":
            engines[op[1]].fail_next_decode = True
        else:
            engines[op[1]].fail_next_admit = True
        check()
    for _ in range(500):
        if not fe.step():
            break
        check()
    # a queue behind a fleet with no replica left never drains: the
    # caller gives up on what is still waiting
    for rid in sorted(fe.handles):
        fe.cancel(rid)
    check()
    return fe


@settings(max_examples=100, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       n_replicas=st.sampled_from([1, 2, 3]),
       slots=st.integers(1, 3), depth=st.integers(0, 4),
       policy=st.sampled_from(["fifo", "spf"]),
       chunk=st.sampled_from([None, 2]), recurrent=st.booleans())
def test_both_packages_agree_request_by_request(seed, n_replicas, slots,
                                                depth, policy, chunk,
                                                recurrent):
    ops = _program(seed, n_replicas)
    out = {}
    for name, pkg in PACKAGES.items():
        fe = _replay(pkg, ops, n_replicas, slots, depth, policy, chunk,
                     recurrent)
        hs = [fe.handles[r] for r in sorted(fe.handles)]
        assert all(h.status.value in {s.value for s in TERMINAL}
                   for h in hs), name
        out[name] = [(h.rid, h.status.value, [int(t) for t in h.tokens])
                     for h in hs]
        if n_replicas > 1:
            out[name + " rstats"] = dict(fe.engine.rstats)
    assert out["torch"] == out["jax"]
    assert out.get("torch rstats") == out.get("jax rstats")
    assert len(out["torch"]) == sum(op[0] == "submit" for op in ops)


def test_the_programs_reach_every_terminal_status():
    """Across the examples' seeds the programs end requests in each of the
    five terminal states, so the comparison above covers them all."""
    seen = set()
    for seed in range(40):
        fe = _replay(PACKAGES["torch"], _program(seed, 2), 2, 1, 1, "fifo",
                     None, False)
        seen |= {h.status.value for h in fe.handles.values()}
    assert seen == {s.value for s in TERMINAL}
