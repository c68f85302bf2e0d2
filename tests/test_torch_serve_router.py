"""The port's replica router: the fault-injection cases of the JAX
package's router tests over the port's pure-Python fakes
(``repro_torch.serve.testing``), and a real two-replica fleet of the port
killed mid-trace, token-identical to the JAX package's fleet on the same
numpy-made weights (reduced qwen2-1.5b, fp32, on the CPU)."""
from __future__ import annotations

import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import ReplicaRouter as JaxRouter  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import ServeFrontend as JaxFrontend  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from repro_torch.serve import (ReplicaRouter, ReplicaState,  # noqa: E402
                               Request, ServeEngine, ServeFrontend, Status,
                               errors, frontend_table, synthetic_trace)
from repro_torch.serve.router import ROUTES  # noqa: E402
from repro_torch.serve.testing import (FleetFakeEngine,  # noqa: E402
                                       ManualClock, fleet_token)
from torch_parity import jax_params, lm_cfgs  # noqa: E402


def _req(rid, plen=3, gen=4, deadline=None):
    return Request(rid=rid, tokens=np.arange(1, plen + 1, dtype=np.int32),
                   gen=gen, deadline=deadline)


def _fleet(n_replicas, slots, **kw):
    engines = [FleetFakeEngine(slots, **kw) for _ in range(n_replicas)]
    return engines, ReplicaRouter(engines)


def _stream(rid, n):
    return [fleet_token(rid, i) for i in range(n)]


def _run(fe, hs, steps=128):
    for _ in range(steps):
        if all(h.finished for h in hs):
            return
        fe.step()


def test_router_validation():
    with pytest.raises(ValueError, match=re.escape(
            errors.msg("router_needs_engines"))):
        ReplicaRouter([])
    with pytest.raises(ValueError, match=re.escape(
            errors.msg("unknown_route", route="round-robin",
                       routes=ROUTES))):
        ReplicaRouter([FleetFakeEngine(1)], route="round-robin")
    with pytest.raises(ValueError, match=re.escape(
            errors.msg("affinity_ineligible",
                       name=FleetFakeEngine(1).cfg.name))):
        ReplicaRouter([FleetFakeEngine(1)], route="prefix-affinity")
    r = ReplicaRouter([FleetFakeEngine(1, prefix_ok=True)],
                      route="prefix-affinity")
    assert r.prefix_eligible()


def test_death_mid_decode_no_token_loss():
    engines, router = _fleet(2, 1)
    fe = ServeFrontend(router, queue_depth=8, clock=ManualClock())
    h0, h1 = fe.submit(_req(0, gen=6)), fe.submit(_req(1, gen=3))
    fe.step()
    engines[0].fail_next_decode = True
    _run(fe, [h0, h1])
    assert (h0.status, h1.status) == (Status.DONE, Status.DONE)
    assert h0.tokens == _stream(0, 6) and h1.tokens == _stream(1, 3)
    assert router.rstats["redispatches"] == router.rstats["orphaned"] == 1
    assert router.states == [ReplicaState.DOWN, ReplicaState.UP]


def test_death_during_prefill_retries_on_survivor():
    engines, router = _fleet(2, 1)
    engines[0].fail_next_admit = True
    fe = ServeFrontend(router, queue_depth=8, clock=ManualClock())
    h = fe.submit(_req(0, gen=3))
    _run(fe, [h])
    assert h.status is Status.DONE and h.tokens == _stream(0, 3)
    assert router.states == [ReplicaState.DOWN, ReplicaState.UP]
    assert engines[1].stats["admits"] == 1
    assert router.rstats["replicas_down"] == 1


@pytest.mark.parametrize("fault", ["admit", "decode", "kill"])
def test_a_downed_replica_keeps_the_exception_that_downed_it(fault):
    """The router absorbs a replica's exception and re-dispatches; the
    exception stays on ``replicas[i].error`` for the caller to report (a
    ``kill`` raised nothing)."""
    engines, router = _fleet(2, 1)
    fe = ServeFrontend(router, queue_depth=8, clock=ManualClock())
    engines[0].fail_next_admit = fault == "admit"
    h = fe.submit(_req(0, gen=5))
    fe.step()
    if fault == "decode":
        engines[0].fail_next_decode = True
    elif fault == "kill":
        router.kill(0)
    _run(fe, [h])
    assert h.status is Status.DONE and h.tokens == _stream(0, 5)
    assert router.states == [ReplicaState.DOWN, ReplicaState.UP]
    err = router.replicas[0].error
    if fault == "kill":
        assert err is None
    else:
        assert isinstance(err, RuntimeError)
        assert str(err) == f"injected {fault} failure"
    assert router.replicas[1].error is None


def test_double_kill_is_idempotent():
    engines, router = _fleet(2, 1)
    fe = ServeFrontend(router, queue_depth=8, clock=ManualClock())
    h = fe.submit(_req(0, gen=5))
    fe.step()
    router.kill(0)
    router.kill(0)
    _run(fe, [h])
    assert h.status is Status.DONE and h.tokens == _stream(0, 5)
    assert router.rstats["replicas_down"] == router.rstats["orphaned"] \
        == router.rstats["redispatches"] == 1


def test_drain_then_kill_redispatches_in_flight():
    engines, router = _fleet(2, 2)
    fe = ServeFrontend(router, queue_depth=8, clock=ManualClock())
    hs = [fe.submit(_req(i, gen=5)) for i in range(3)]
    fe.step()
    router.drain(0)
    router.kill(0)
    _run(fe, hs)
    for h in hs:
        assert h.status is Status.DONE and h.tokens == _stream(h.rid, 5)
    assert router.states[0] is ReplicaState.DOWN and not router.drained(0)
    assert router.rstats["orphaned"] == 2


def test_drained_replica_takes_no_admits_and_reports_removable():
    engines, router = _fleet(2, 1)
    fe = ServeFrontend(router, queue_depth=8, clock=ManualClock())
    h0 = fe.submit(_req(0, gen=3))
    router.drain(0)
    h1 = fe.submit(_req(1, gen=2))
    h2 = fe.submit(_req(2, gen=2))
    _run(fe, [h0, h1, h2])
    assert [h.status for h in (h0, h1, h2)] == [Status.DONE] * 3
    assert engines[0].stats["admits"] == 1 and router.drained(0)
    assert router.states == [ReplicaState.DRAINING, ReplicaState.UP]


def test_deadline_expiry_of_orphaned_request():
    engines, router = _fleet(2, 1)
    clk = ManualClock()
    fe = ServeFrontend(router, queue_depth=8, clock=clk)
    h0 = fe.submit(_req(0, gen=20, deadline=5.0))
    h1 = fe.submit(_req(1, gen=20))
    fe.step()
    router.kill(0)
    fe.step()
    assert not h0.finished
    clk.advance(10.0)
    fe.step()
    assert h0.status is Status.EXPIRED and h0.tokens == _stream(0, 2)
    _run(fe, [h1])
    assert h1.status is Status.DONE and h1.tokens == _stream(1, 20)
    assert router.rstats["redispatches"] == 0


def test_all_replicas_dead_fails_exactly_once():
    engines, router = _fleet(2, 1)
    fe = ServeFrontend(router, queue_depth=8, clock=ManualClock())
    h0, h1 = fe.submit(_req(0, gen=6)), fe.submit(_req(1, gen=6))
    fe.step()
    engines[0].fail_next_decode = engines[1].fail_next_decode = True
    for _ in range(4):
        fe.step()
    assert h0.status is Status.FAILED and h1.status is Status.FAILED
    assert h0.tokens == _stream(0, 2) and h1.tokens == _stream(1, 2)
    assert router.take_failed() == []
    tab = frontend_table([h0, h1], wall=1.0)
    assert tab["failed"] == 2 and tab["done"] == 0


def test_cancel_of_pending_orphan_frees_capacity():
    engines, router = _fleet(2, 1)
    router.begin(0.0)
    gid = router.free_slots()[0]
    router.admit(_req(0, gen=6), gid)
    router.kill(0)
    assert router.free_slots() == []
    assert router.cancel(gid) == _stream(0, 1)
    assert len(router.free_slots()) == 1
    router.decode_step()
    assert router.active_count() == 0


def test_queued_requests_flow_to_survivors():
    engines, router = _fleet(2, 1)
    fe = ServeFrontend(router, queue_depth=8, clock=ManualClock())
    hs = [fe.submit(_req(i, gen=3)) for i in range(5)]
    fe.step()
    engines[0].fail_next_decode = True
    _run(fe, hs)
    for h in hs:
        assert h.status is Status.DONE and h.tokens == _stream(h.rid, 3)
    assert engines[0].stats["admits"] == 1


def test_prefix_affinity_overrides_least_loaded():
    engines, _ = _fleet(2, 2, prefix_ok=True)
    router = ReplicaRouter(engines, route="prefix-affinity")
    shared = np.arange(1, 9, dtype=np.int32)
    router._caches[1].insert(shared, cache="kv", nbytes=8)
    router.admit(_req(5, gen=4), router.free_slots()[0])
    assert engines[0].stats["admits"] == 1
    hit = Request(rid=6, tokens=np.concatenate(
        [shared, np.array([99], np.int32)]), gen=4)
    router.admit(hit, router.free_slots()[0])
    assert engines[1].stats["admits"] == 1
    assert router.rstats["affinity_hits"] == 1
    router.admit(_req(7, plen=2, gen=4), router.free_slots()[0])
    assert engines[0].stats["admits"] == 2


def test_chunked_fleet_matches_atomic_streams():
    engines, router = _fleet(2, 2)
    fe = ServeFrontend(router, queue_depth=8, clock=ManualClock(),
                       prefill_chunk=2)
    hs = [fe.submit(_req(i, plen=3 + 2 * i, gen=3 + i)) for i in range(4)]
    _run(fe, hs)
    for i, h in enumerate(hs):
        assert h.status is Status.DONE and h.tokens == _stream(i, 3 + i)
    assert all(v.free for v in router.vslots)
    assert sum(e.stats["chunk_steps"] for e in engines) > 0


def test_replica_death_mid_chunked_prefill_reprefills_from_prompt():
    engines, router = _fleet(2, 1)
    fe = ServeFrontend(router, queue_depth=8, clock=ManualClock(),
                       prefill_chunk=2)
    h0 = fe.submit(_req(0, plen=9, gen=4))
    h1 = fe.submit(_req(1, plen=2, gen=6))
    assert h0.status is Status.RUNNING and h0.tokens == []
    router.kill(0)
    _run(fe, [h0, h1])
    assert h0.status is Status.DONE and h0.tokens == _stream(0, 4)
    assert h1.status is Status.DONE and h1.tokens == _stream(1, 6)
    assert router.rstats["orphaned"] == router.rstats["redispatches"] == 1
    assert engines[1].stats["admits"] == 2
    assert all(v.free for v in router.vslots)


# ---------------------------------------------------------------------------
# real engines: the port's fleet against the JAX package's, through a kill
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    jcfg, pcfg = lm_cfgs()
    params = jax_params(jcfg, seed=12)
    return {"jm": jax_build(jcfg), "jp": jax.tree.map(jnp.asarray, params),
            "pm": pt_build(pcfg),
            "pp": interop.from_numpy(params, device="cpu"),
            "vocab": pcfg.vocab_size}


def _killed_fleet(router_cls, fe_cls, engines, trace, chunk, route, cap):
    """Two replicas; replica 1 dies after its 2nd decode step."""
    router = router_cls(engines, route=route, prefix_cap=cap)
    fe = fe_cls(router, queue_depth=8, prefill_chunk=chunk)
    handles = [fe.submit(r) for r in trace]
    killed = False
    for _ in range(512):
        if not fe.step():
            break
        if not killed and engines[1].stats["decode_steps"] >= 2:
            router.kill(1)
            killed = True
    assert killed
    return handles, router


@pytest.mark.parametrize("chunk,route", [(None, "least-loaded"),
                                         (3, "least-loaded"),
                                         (None, "prefix-affinity")])
def test_real_fleet_kill_matches_the_jax_fleet(lm, chunk, route):
    """Every stream of the port's fleet equals the JAX fleet's and a single
    port engine's; the survivor re-prefills ``prompt + out[:-1]`` (through
    its prefix cache under prefix-affinity) and the router's determinism
    check holds on the real argmax."""
    kw = dict(prompt_range=(4, 8), gen_range=(3, 8), seed=7,
              prefix_len=6 if route == "prefix-affinity" else 0)
    trace = synthetic_trace(6, lm["vocab"], **kw)
    cap = 4 if route == "prefix-affinity" else 0
    ref = ServeEngine(lm["pm"], lm["pp"], n_slots=2, max_len=48).run(trace)
    engines = [ServeEngine(lm["pm"], lm["pp"], n_slots=2, max_len=48)
               for _ in range(2)]
    got, router = _killed_fleet(ReplicaRouter, ServeFrontend, engines,
                                trace, chunk, route, cap)
    jengines = [JaxEngine(lm["jm"], lm["jp"], n_slots=2, max_len=48)
                for _ in range(2)]
    want, jrouter = _killed_fleet(JaxRouter, JaxFrontend, jengines, trace,
                                  chunk, route, cap)
    assert [(h.status.value, list(h.tokens)) for h in got] == \
        [(h.status.value, [int(t) for t in h.tokens]) for h in want]
    for h in got:
        assert h.status is Status.DONE
        assert h.tokens == ref[h.rid].tokens.tolist(), h.rid
    assert router.states[1] is ReplicaState.DOWN
    assert router.rstats["orphaned"] == router.rstats["redispatches"] > 0
    assert router.rstats["failed"] == 0
    assert dict(router.rstats) == dict(jrouter.rstats)
    if route == "prefix-affinity":
        assert router.prefix_stats() == jrouter.prefix_stats()
