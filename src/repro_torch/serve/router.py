"""Multi-replica routed serving (``repro.serve.router``, copied; pure
Python): N engines behind one slot surface.

A single ``ServeEngine`` is one host's worth of slots. CORP's serving
claim is fleet-level: pruned models shrink the per-slot KV cache
(``eff_qk``), so a host holds more slots and a fleet holds more replicas —
but that win only materializes if the serving tier can spread traffic
across engines. ``ReplicaRouter`` does that routing while *speaking the
same engine-agnostic slot surface the front-end already consumes*
(``free_slots`` / ``admit`` / ``decode_step`` / ``retire`` / ``cancel`` /
``begin`` / ``slots`` / ``active_count``, plus the non-atomic
``begin_admit`` / ``continue_admit`` / ``decoding_count`` split the
scheduler's chunked-prefill policy drives), so ``ServeFrontend`` and
``AsyncServeFrontend`` layer on top of a fleet exactly as they layer on
one engine. A replica dying
mid-chunked-prefill re-dispatches like any other orphan: its virtual slot
has delivered zero tokens, so the survivor re-prefills from the prompt —
greedy determinism keeps the stream exact.

Design: **virtual slots**. The router exposes ``sum(n_slots)`` virtual
slot ids. The front-end admits into a virtual id; the router *binds* it to
a concrete ``(replica, physical slot)`` chosen by the routing policy at
admit time:

- ``least-loaded`` — the UP replica with the fewest occupied physical
  slots (deterministic tie-break: lowest replica index, then lowest local
  slot — the fleet property suite pins this argmin against an oracle).
- ``prefix-affinity`` — the UP replica whose per-replica ``PrefixCache``
  holds the longest prefix of the request's prompt (ties and misses fall
  back to least-loaded). Affinity is self-reinforcing: the admit inserts
  the new prefill into the chosen replica's cache.

One router ``decode_step`` steps every live replica **concurrently**
(one thread per replica; the kernels' wrappers release the GIL in their
launch calls and count their launches under a lock). Replicas built on
one card share its default stream, so one replica's device-to-host copy
of its next tokens also waits for the other's queued work: each engine's
``decode_s`` then includes the other replica's step.

Health: a replica whose ``decode_step``/``admit`` raises is marked DOWN
and keeps the exception on its ``error``. Its in-flight requests keep
every token produced before the failing step (the router mirrors tokens
into the virtual slot after each successful step) and are **re-dispatched** to survivors: greedy decode is
deterministic, so re-prefilling ``prompt + tokens[:-1]`` on a survivor
reproduces the stream exactly from the failure point — no token loss, no
duplicates. With no survivors the request is finished ``FAILED``
exactly-once (the front-end reaps ``take_failed()``). On the card a
prefill and a decode step reach a logit by different arithmetic, so a
near-tie can flip the re-prefill's argmax; ``_sync_vslot`` then asserts
rather than deliver a stream that silently changed.

``drain(replica)`` stops new admissions (including re-dispatches) to a
replica while its in-flight requests run to completion; ``drained()``
reports when it is removable.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from repro_torch.serve import errors
from repro_torch.serve.engine import Completion, Request
from repro_torch.serve.prefix import PrefixCache, usable_prefix_len

ROUTES = ("least-loaded", "prefix-affinity")


class ReplicaState(enum.Enum):
    UP = "up"
    DRAINING = "draining"
    DOWN = "down"


class _VState(enum.Enum):
    FREE = "free"          # admittable
    BOUND = "bound"        # live on a (replica, pslot)
    PENDING = "pending"    # replica died; awaiting re-dispatch
    FAILED = "failed"      # no survivor; awaiting take_failed()


@dataclasses.dataclass
class _VSlot:
    """Router-side view of one request: the canonical token stream and
    the current physical binding (if any). ``base`` is the global token
    index of the bound replica's ``out[0]`` — 0 on first admit, and the
    re-dispatch overlap offset afterwards (the survivor's re-prefill
    token duplicates the last token already delivered)."""
    state: _VState = _VState.FREE
    rid: int = -1
    req: Optional[Request] = None
    out: list = dataclasses.field(default_factory=list)
    remaining: int = 0
    replica: int = -1
    pslot: int = -1
    base: int = 0
    t_admit: float = 0.0

    @property
    def free(self) -> bool:
        return self.state is _VState.FREE


class _Replica:
    def __init__(self, engine):
        self.engine = engine
        self.state = ReplicaState.UP
        self.error = None      # the exception that marked it DOWN, if any

    @property
    def up(self) -> bool:
        return self.state is ReplicaState.UP

    @property
    def live(self) -> bool:
        return self.state is not ReplicaState.DOWN


class ReplicaRouter:
    """Load-balance N engine instances behind one engine-shaped surface.

    Parameters
    ----------
    engines    : list of ``ServeEngine``-surface objects (same model).
    route      : "least-loaded" | "prefix-affinity".
    prefix_cap : per-replica prefix-cache capacity for prefix-affinity
                 routing (defaults to 8 when the route needs caches;
                 ignored for least-loaded).
    min_hit    : smallest prefix overlap that counts as affinity.
    """

    def __init__(self, engines: List, *, route: str = "least-loaded",
                 prefix_cap: int = 0, min_hit: int = 4):
        if not engines:
            raise ValueError(errors.msg("router_needs_engines"))
        if route not in ROUTES:
            raise ValueError(errors.msg("unknown_route", route=route,
                                        routes=ROUTES))
        self.route = route
        self.replicas = [_Replica(e) for e in engines]
        # recurrent replicas hold state snapshots, reusable whole-entry
        # only (serve/prefix.py) — affinity must score them the same way
        self._whole_entry = getattr(engines[0], "contract",
                                    "kv") == "recurrent"
        self._caches: Optional[List[PrefixCache]] = None
        if route == "prefix-affinity":
            if not engines[0].prefix_eligible():
                raise ValueError(errors.msg("affinity_ineligible",
                                            name=engines[0].cfg.name))
            self._caches = [PrefixCache(cap=prefix_cap or 8,
                                        min_hit=min_hit)
                            for _ in engines]
        # virtual slot table: gid -> (replica, local slot) bindings happen
        # at admit time; gids themselves are stable across re-dispatch
        self.vslots = [_VSlot()
                       for _ in range(sum(e.n_slots for e in engines))]
        self._pending: collections.deque = collections.deque()  # gids
        self._failed: list = []             # (gid, tokens) for take_failed
        self._prefilling: set = set()       # gids mid-chunked-prefill
        self._pool = ThreadPoolExecutor(
            max_workers=len(engines),
            thread_name_prefix="replica-decode")
        self.rstats = collections.Counter()
        self._t0 = None

    # -- engine-agnostic slot surface (what the front-end consumes) --------

    @property
    def cfg(self):
        return self.replicas[0].engine.cfg

    @property
    def n_slots(self) -> int:
        return len(self.vslots)

    @property
    def slots(self) -> List[_VSlot]:
        return self.vslots

    def prefix_eligible(self) -> bool:
        return self.replicas[0].engine.prefix_eligible()

    def begin(self, t0: Optional[float] = None):
        self._t0 = time.perf_counter() if t0 is None else t0
        for r in self.replicas:
            r.engine.begin(self._t0)

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _capacity(self) -> int:
        """Free physical slots on UP replicas, minus the seats reserved
        for orphans awaiting re-dispatch (orphans have priority)."""
        free = sum(len(r.engine.free_slots())
                   for r in self.replicas if r.up)
        return max(0, free - len(self._pending))

    def free_slots(self) -> List[int]:
        """Admittable virtual ids, capacity-limited to the fleet's free
        physical slots (the binding itself happens at admit time)."""
        cap = self._capacity()
        if cap <= 0:
            return []
        return [g for g, v in enumerate(self.vslots) if v.free][:cap]

    def active_count(self) -> int:
        return sum(v.state in (_VState.BOUND, _VState.PENDING)
                   for v in self.vslots)

    def decoding_count(self) -> int:
        """Virtual slots a decode step can serve: BOUND slots past their
        prefill, plus orphans awaiting re-dispatch (stepping the fleet is
        what re-dispatches them). PREFILLING slots are excluded — they
        advance via ``continue_admit``, not decode lanes."""
        return sum(1 for g, v in enumerate(self.vslots)
                   if (v.state is _VState.BOUND
                       and g not in self._prefilling)
                   or v.state is _VState.PENDING)

    # -- routing policy -----------------------------------------------------

    def _candidates(self) -> List[int]:
        """UP replicas with at least one free physical slot, least-loaded
        first (tie-break: replica index — the oracle-pinned argmin)."""
        cand = [i for i, r in enumerate(self.replicas)
                if r.up and r.engine.free_slots()]
        return sorted(cand,
                      key=lambda i: (self.replicas[i].engine.active_count(),
                                     i))

    def _choose(self, req: Request) -> Optional[int]:
        cand = self._candidates()
        if not cand:
            return None
        if self._caches is not None:
            # longest cached prefix wins; peek without counting a miss so
            # the fallback path doesn't skew per-replica hit stats
            toks = np.asarray(req.tokens, np.int32)
            best, best_len = None, 0
            for i in cand:
                for e in self._caches[i]._entries.values():
                    L = usable_prefix_len(e.tokens, toks,
                                          self._whole_entry)
                    if L >= self._caches[i].min_hit and L > best_len:
                        best, best_len = i, L
            if best is not None:
                self.rstats["affinity_hits"] += 1
                return best
        return cand[0]

    # -- admission ----------------------------------------------------------

    def admit(self, req: Request, slot: int, prefix_cache=None):
        """Route ``req`` to a replica chosen by policy and bind it to
        virtual id ``slot``. A replica that raises during prefill is
        marked DOWN and the admit retries on the next survivor; with no
        survivors the request is registered FAILED (reaped via
        ``take_failed`` — this method never raises on replica death)."""
        v = self.vslots[slot]
        assert v.free, f"admit into non-free virtual slot {slot}"
        v.state, v.rid, v.req = _VState.BOUND, req.rid, req
        v.out, v.remaining, v.base = [], req.gen, 0
        v.t_admit = self._now() if self._t0 is not None else 0.0
        if not self._bind(slot, req, prefix_cache=prefix_cache):
            # every replica died under us: FAILED, exactly-once, no raise
            v.state = _VState.FAILED
            self._failed.append(slot)
            self.rstats["failed"] += 1
        self.rstats["routed_admits"] += 1

    def begin_admit(self, req: Request, slot: int, prefix_cache=None):
        """Non-atomic admit surface (serve/scheduler.py chunked prefill):
        bind virtual id ``slot`` and ``begin_admit`` on a policy-chosen
        replica — no prefill work yet. Death handling matches ``admit``:
        retries on survivors, FAILED with none left, never raises."""
        v = self.vslots[slot]
        assert v.free, f"admit into non-free virtual slot {slot}"
        v.state, v.rid, v.req = _VState.BOUND, req.rid, req
        v.out, v.remaining, v.base = [], req.gen, 0
        v.t_admit = self._now() if self._t0 is not None else 0.0
        if self._bind(slot, req, prefix_cache=prefix_cache, begin=True):
            self._prefilling.add(slot)
        else:
            v.state = _VState.FAILED
            self._failed.append(slot)
            self.rstats["failed"] += 1
        self.rstats["routed_admits"] += 1

    def continue_admit(self, slot: int,
                       budget: Optional[int] = None) -> bool:
        """One chunk of prefill for virtual slot ``slot`` on its bound
        replica; True once its prompt is consumed (first token mirrored
        into the virtual stream). A replica dying mid-prefill orphans the
        slot with zero delivered tokens, so re-dispatch re-prefills from
        the prompt on a survivor — atomically, and greedy determinism
        keeps the stream byte-identical."""
        v = self.vslots[slot]
        if v.state is _VState.FAILED:
            return False                   # reaped via take_failed()
        if slot not in self._prefilling:
            return True    # already completed by an atomic re-dispatch
        if v.state is _VState.BOUND:
            try:
                done = self.replicas[v.replica].engine.continue_admit(
                    v.pslot, budget)
            except Exception as e:  # noqa: BLE001 - replica death
                self._fail_replica(v.replica, e)
                done = None
            if done is not None:
                if not done:
                    return False
                self._prefilling.discard(slot)
                self._sync_vslot(slot)
                return True
        # PENDING (possibly just orphaned above): try a re-dispatch now —
        # decode lanes may all be prefilling, so waiting for decode_step's
        # re-dispatch could livelock. A successful re-dispatch prefills
        # the whole prompt atomically and clears the prefilling mark.
        self._redispatch()
        return slot not in self._prefilling and v.state is _VState.BOUND

    def _bind(self, gid: int, req: Request, prefix_cache=None,
              begin: bool = False) -> bool:
        """Admit ``req`` on a policy-chosen replica; retries across
        replica deaths. True on success (vslot bound + tokens synced).
        ``begin=True`` binds via the replica's ``begin_admit`` (no prefill
        work, nothing to sync yet)."""
        v = self.vslots[gid]
        while True:
            i = self._choose(req)
            if i is None:
                return False
            r = self.replicas[i]
            pslot = r.engine.free_slots()[0]
            cache = prefix_cache if prefix_cache is not None else (
                self._caches[i] if self._caches is not None else None)
            try:
                if begin:
                    r.engine.begin_admit(req, pslot, prefix_cache=cache)
                else:
                    r.engine.admit(req, pslot, prefix_cache=cache)
            except Exception as e:  # noqa: BLE001 - replica death
                self._fail_replica(i, e)
                continue
            v.replica, v.pslot = i, pslot
            # physical out[0] is the re-prefill token, which duplicates
            # the last token already delivered (greedy determinism) — so
            # it maps to global index len(out)-1 on re-dispatch, 0 cold
            v.base = max(0, len(v.out) - 1)
            if not begin:
                self._sync_vslot(gid)
            return True

    # -- the shared decode step ---------------------------------------------

    def decode_step(self) -> List[int]:
        """Re-dispatch orphans, then step every live replica with active
        slots concurrently; returns completed *virtual* ids. A replica
        that raises is marked DOWN and its requests are orphaned with
        every token produced before the failing step."""
        self._redispatch()
        stepping = [i for i, r in enumerate(self.replicas)
                    if r.live and getattr(r.engine, "decoding_count",
                                          r.engine.active_count)()]
        if len(stepping) == 1:
            results = {stepping[0]: self._step_one(stepping[0])}
        else:
            futs = {i: self._pool.submit(self._step_one, i)
                    for i in stepping}
            results = {i: f.result() for i, f in futs.items()}
        for i in stepping:
            if isinstance(results[i], Exception):
                self._fail_replica(i, results[i])
        retired = []
        for gid, v in enumerate(self.vslots):
            if v.state is not _VState.BOUND or v.replica not in stepping:
                continue
            if self.replicas[v.replica].state is ReplicaState.DOWN:
                continue                    # orphaned by _fail_replica
            if gid in self._prefilling:
                continue                    # no tokens until install
            self._sync_vslot(gid)
            if v.remaining == 0:
                retired.append(gid)
        self.rstats["router_steps"] += 1
        return retired

    def _step_one(self, i: int):
        try:
            return self.replicas[i].engine.decode_step()
        except Exception as e:  # noqa: BLE001 - health boundary
            return e

    def _sync_vslot(self, gid: int):
        """Mirror the bound replica's newly produced tokens into the
        virtual slot's canonical stream (skipping the re-dispatch
        overlap) and recompute remaining."""
        v = self.vslots[gid]
        phys = self.replicas[v.replica].engine.slots[v.pslot].out
        have = len(v.out) - v.base          # phys tokens already mirrored
        if have >= 1 and phys:
            # the re-prefill token must reproduce the stream (greedy
            # determinism); a mismatch would be silent corruption
            assert int(phys[0]) == int(v.out[v.base]), (
                f"rid {v.rid}: re-dispatch token {int(phys[0])} != "
                f"delivered {int(v.out[v.base])}")
        v.out.extend(int(t) for t in phys[have:])
        v.remaining = v.req.gen - len(v.out)

    # -- health: death, orphaning, re-dispatch ------------------------------

    def _fail_replica(self, i: int, error: Optional[Exception] = None):
        """Mark replica ``i`` DOWN, keeping the exception that did it on
        ``replicas[i].error`` (None for a ``kill``), and orphan its
        in-flight requests."""
        r = self.replicas[i]
        if r.state is ReplicaState.DOWN:
            return
        r.state, r.error = ReplicaState.DOWN, error
        self.rstats["replicas_down"] += 1
        for gid, v in enumerate(self.vslots):
            if v.state is _VState.BOUND and v.replica == i:
                v.state = _VState.PENDING
                v.replica = v.pslot = -1
                self._pending.append(gid)
                self.rstats["orphaned"] += 1

    def kill(self, i: int):
        """Fault injection / ops: mark replica ``i`` DOWN now and orphan
        its in-flight requests (idempotent)."""
        self._fail_replica(i)

    def _redispatch(self):
        """Re-admit every orphan on a survivor, FIFO. Greedy decode is
        deterministic, so prefilling ``prompt + out[:-1]`` reproduces
        ``out[-1]`` and the stream continues exactly — no token loss, no
        duplicates. Orphans with no UP survivor are finished FAILED."""
        while self._pending:
            gid = self._pending[0]
            v = self.vslots[gid]
            if v.state is not _VState.PENDING:   # cancelled meanwhile
                self._pending.popleft()
                continue
            if not any(r.up for r in self.replicas):
                # nobody left to absorb it: FAILED, exactly-once
                self._pending.popleft()
                v.state = _VState.FAILED
                self._failed.append(gid)
                self.rstats["failed"] += 1
                continue
            if not self._candidates():
                break            # survivors busy; retry after a retire
            k = len(v.out)
            if k == 0:                            # died during prefill
                cont = v.req
            else:
                toks = np.concatenate([
                    np.asarray(v.req.tokens, np.int32),
                    np.asarray(v.out[:k - 1], np.int32)])
                cont = dataclasses.replace(v.req, tokens=toks,
                                           gen=v.req.gen - (k - 1))
            v.state = _VState.BOUND
            if self._bind(gid, cont):
                self._pending.popleft()
                # a mid-prefill orphan re-prefills its whole prompt here
                # (atomic admit), so it is no longer PREFILLING
                self._prefilling.discard(gid)
                self.rstats["redispatches"] += 1
            else:                # chosen survivors died mid-bind: loop
                v.state = _VState.PENDING

    def take_failed(self) -> List:
        """Drain requests that could not be re-dispatched (no surviving
        replica): returns ``[(virtual slot, partial tokens), ...]``
        exactly once per failure; the slots are freed. The front-end
        calls this each step and finishes the handles FAILED."""
        out = []
        for gid in self._failed:
            v = self.vslots[gid]
            out.append((gid, list(v.out)))
            self._release(gid)
        self._failed = []
        return out

    # -- retire / cancel ----------------------------------------------------

    def retire(self, slot: int) -> Completion:
        v = self.vslots[slot]
        assert v.state is _VState.BOUND and v.remaining == 0, \
            f"retire of virtual slot {slot} in {v.state}"
        self.replicas[v.replica].engine.retire(v.pslot)
        now = self._now() if self._t0 is not None else 0.0
        comp = Completion(
            rid=v.rid, tokens=np.asarray(v.out, np.int32),
            prompt_len=len(v.req.tokens), arrival=v.req.arrival,
            t_admit=v.t_admit, t_first=v.t_admit, t_done=now)
        self._release(slot)
        return comp

    def cancel(self, slot: int) -> List[int]:
        """Drop virtual slot ``slot`` mid-generation (deadline expiry /
        caller cancel) and return its partial tokens — works whether the
        request is live on a replica, orphaned awaiting re-dispatch, or
        already failed."""
        v = self.vslots[slot]
        if v.free:
            raise ValueError(f"cancel on free virtual slot {slot}")
        if v.state is _VState.BOUND:
            self.replicas[v.replica].engine.cancel(v.pslot)
        elif v.state is _VState.PENDING:
            # stale deque entries would under-report free_slots capacity
            self._pending.remove(slot)
        elif v.state is _VState.FAILED:
            self._failed.remove(slot)
        partial = list(v.out)
        self._release(slot)
        self.rstats["cancels"] += 1
        return partial

    def _release(self, gid: int):
        self._prefilling.discard(gid)
        self.vslots[gid] = _VSlot()

    # -- drain / health surface ---------------------------------------------

    def drain(self, i: int):
        """No new admissions (or re-dispatches) to replica ``i``; its
        in-flight requests run to completion. ``drained(i)`` turns True
        once the last one retires — the replica is then removable."""
        if self.replicas[i].state is ReplicaState.UP:
            self.replicas[i].state = ReplicaState.DRAINING
            self.rstats["drains"] += 1

    def drained(self, i: int) -> bool:
        r = self.replicas[i]
        return (r.state is ReplicaState.DRAINING
                and r.engine.active_count() == 0)

    @property
    def states(self) -> List[ReplicaState]:
        return [r.state for r in self.replicas]

    # -- reporting ----------------------------------------------------------

    @property
    def stats(self) -> collections.Counter:
        """Fleet-aggregated engine counters + router-level counters
        (``routed_admits``, ``redispatches``, ``replicas_down``,
        ``failed``, ``drains``, ``affinity_hits``, ``router_steps``)."""
        agg = collections.Counter()
        for r in self.replicas:
            agg.update(r.engine.stats)
        agg.update(self.rstats)
        return agg

    @property
    def cache_bytes(self) -> int:
        return sum(r.engine.cache_bytes for r in self.replicas)

    def prefix_stats(self) -> Optional[List[dict]]:
        return None if self._caches is None else \
            [c.stats() for c in self._caches]
