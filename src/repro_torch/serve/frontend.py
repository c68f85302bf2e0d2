"""Serving front-end over ``ServeEngine`` (``repro.serve.frontend``,
copied; pure Python): streaming, deadlines, backpressure, prefix reuse.

``ServeEngine`` turns a static request list into completions; production
traffic instead arrives, at its own rate, with callers that hang up. This
layer adds the request dynamics:

- **streaming**: every submitted request returns a handle whose token
  iterator yields each token as the shared decode step produces it
  (``ServeFrontend.stream`` / ``AsyncServeFrontend``).
- **admission control and backpressure**: free slots admit at once;
  otherwise requests wait in a bounded ``AdmissionQueue`` (FIFO, or
  shortest-prompt-first) and beyond ``queue_depth`` are rejected with a
  typed ``Overloaded`` result. Overload degrades into fast rejection,
  never into an unbounded backlog.
- **deadlines and cancellation**: a request whose deadline passes while
  queued is dropped before any engine work; one that passes
  mid-generation is cancelled through the engine's retire hook, its slot
  refilled on the next iteration, and its partial tokens are kept.
- **prefix cache**: admits consult an LRU of recent prefill caches
  (``serve/prefix.py``) and skip recomputing a shared prompt prefix.

The front-end's loop is synchronous and engine-agnostic, and hands the
admit/prefill/decode interleaving to a ``Scheduler``
(``serve/scheduler.py``). With ``prefill_chunk`` set, a cold admit
consumes at most that many prompt tokens per ``step()``; token streams are
identical to atomic admits. Both layers use only the engine's slot surface
(``free_slots`` / ``admit`` or its ``begin_admit``/``continue_admit``
split / ``decode_step`` / ``retire`` / ``cancel`` / ``slots``), so the
same code drives one engine, a ``ReplicaRouter`` fleet
(``serve/router.py``) or the pure-Python fakes of ``serve/testing.py``.
``AsyncServeFrontend`` is the thin asyncio skin: one stepping task steps the
shared engine, any number of per-request streams multiplex over it.

Timing: the front-end owns a monotonic clock (injectable: every deadline
decision goes through ``clock()``, so expiry is deterministic under a
manual clock even with a real engine underneath). Tie-breaks: a request
that produces its final token on the step its deadline passes
**completes**, while a deadline that passes at the admit boundary
**expires** before prefill.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.serve import errors
from repro_torch.serve.engine import Request
from repro_torch.serve.queue import Overloaded, Status, TERMINAL
from repro_torch.serve.scheduler import Scheduler


@dataclasses.dataclass
class Handle:
    """Caller-facing view of one submitted request.

    ``tokens`` grows as the shared decode step produces tokens (streamed via
    ``ServeFrontend.stream`` or read directly); ``status`` moves through
    QUEUED/RUNNING into exactly one terminal state; ``result`` carries the
    typed ``Overloaded`` on rejection. Times are front-end clock seconds.
    """
    req: Request
    status: Status = Status.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    result: Optional[Overloaded] = None
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def prompt_len(self) -> int:
        return len(self.req.tokens)

    @property
    def deadline(self) -> Optional[float]:
        return self.req.deadline

    @property
    def finished(self) -> bool:
        return self.status in TERMINAL

    @property
    def ttft(self) -> Optional[float]:
        """Submit -> first token (queue wait + prefill)."""
        return None if self.t_first is None else \
            self.t_first - self.t_submit

    @property
    def latency(self) -> Optional[float]:
        """Submit -> last token."""
        return None if self.t_done is None or self.t_first is None else \
            self.t_done - self.t_submit


class ServeFrontend:
    """Deterministic stepping core: one ``step()`` = one engine iteration
    (expire -> resume chunked prefills -> admit -> decode -> retire).

    Parameters
    ----------
    engine       : a ``ServeEngine`` (or any object with its slot surface).
    queue_depth  : bounded waiting room beyond the slots; 0 disables
                   queueing entirely (admit-or-reject).
    policy       : "fifo" | "spf" (shortest-prompt-first admission).
    prefix_cache : optional ``PrefixCache`` consulted on every admit.
    prefill_chunk: max prompt tokens one admit consumes per ``step()``
                   (serve/scheduler.py); None = atomic whole-prompt admits.
    clock        : zero-arg callable returning seconds; defaults to a
                   monotonic clock anchored at construction.
    """

    def __init__(self, engine, *, queue_depth: int = 16,
                 policy: str = "fifo", prefix_cache=None, clock=None,
                 prefill_chunk: Optional[int] = None):
        self.engine = engine
        self.prefix_cache = prefix_cache
        if prefix_cache is not None and not engine.prefix_eligible():
            raise ValueError(errors.msg("prefix_ineligible",
                                        name=engine.cfg.name))
        self.scheduler = Scheduler(engine, prefill_chunk=prefill_chunk,
                                   queue_depth=queue_depth, policy=policy,
                                   prefix_cache=prefix_cache)
        self.queue = self.scheduler.queue
        if clock is None:
            t0 = time.perf_counter()
            clock = lambda: time.perf_counter() - t0  # noqa: E731
        self.clock = clock
        self.handles: dict = {}            # rid -> Handle
        self._by_slot: dict = {}           # engine slot -> running Handle
        engine.begin(getattr(engine, "_t0", None) or time.perf_counter())

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> Handle:
        """Register a request: admit now if a slot is free and nothing is
        waiting (FIFO fairness), queue it otherwise, reject with a typed
        ``Overloaded`` when the queue is full."""
        if req.rid in self.handles:
            raise ValueError(f"duplicate rid {req.rid}")
        h = Handle(req=req, t_submit=self.clock())
        self.handles[req.rid] = h
        if not len(self.queue) and self.engine.free_slots():
            self._admit(h, self.engine.free_slots()[0])
        elif not self.queue.push(h):
            h.result = Overloaded(rid=req.rid, queue_depth=self.queue.depth)
            self._finish(h, Status.REJECTED)
        return h

    def cancel(self, rid: int) -> bool:
        """Explicit caller cancel: drop a queued request before any engine
        work, or cancel a running one keeping its partial tokens. False if
        the request is unknown or already finished."""
        h = self.handles.get(rid)
        if h is None or h.finished:
            return False
        if h.status is Status.QUEUED:
            self.queue.remove(h)
            self._finish(h, Status.CANCELLED)
            return True
        slot = next(s for s, hh in self._by_slot.items() if hh is h)
        h.tokens = [int(t) for t in self.engine.cancel(slot)]
        self.scheduler.release(slot)
        del self._by_slot[slot]
        self._finish(h, Status.CANCELLED)
        return True

    # -- the scheduling step ------------------------------------------------

    def step(self) -> bool:
        """One engine iteration; returns True while work remains."""
        now = self.clock()
        # 0. fleet failures: a routing engine surfaces requests whose
        #    replica died with no survivor to re-dispatch to
        self._reap_failed()
        # 1. queued deadline expiry: never touches the engine
        for h in self.queue.take_expired(now):
            self._finish(h, Status.EXPIRED)
        # 2. running deadline expiry: retire hook frees the slot mid-flight.
        #    A slot expiring mid-chunked-prefill discards the partial
        #    prefill outright — zero tokens kept, slot refillable below
        for slot, h in list(self._by_slot.items()):
            if h.deadline is not None and now >= h.deadline:
                h.tokens = [int(t) for t in self.engine.cancel(slot)]
                self.scheduler.release(slot)
                del self._by_slot[slot]
                self._finish(h, Status.EXPIRED)
        # 3. resume in-flight chunked prefills: one chunk per slot per step
        #    (slots finishing their prompt join this step's decode)
        for slot in self.scheduler.advance():
            self._installed(self._by_slot[slot], slot)
        # 4. refill free slots from the queue (policy order)
        while len(self.queue):
            free = self.engine.free_slots()
            free = [s for s in free if s not in self._by_slot]
            if not free:
                break
            self._admit(self.queue.pop(), free[0])
        # 5. one shared decode step; stream tokens out, retire the finished
        if self.scheduler.should_decode():
            retired = self.engine.decode_step()
            for slot, h in self._by_slot.items():
                h.tokens = [int(t) for t in self.engine.slots[slot].out]
            for slot in retired:
                h = self._by_slot.pop(slot)
                comp = self.engine.retire(slot)
                h.tokens = [int(t) for t in comp.tokens]
                self._finish(h, Status.DONE)
            self._reap_failed()       # decode may have killed a replica
        return bool(self._by_slot) or len(self.queue) > 0

    def _reap_failed(self):
        """Finish FAILED any request a fleet engine reports as lost (its
        replica died, no survivor absorbed the re-dispatch). Partial
        tokens are kept; exactly-once like every other terminal. Engines
        without a ``take_failed`` surface (the single-engine case) are
        untouched."""
        take = getattr(self.engine, "take_failed", None)
        if take is None:
            return
        for slot, tokens in take():
            self.scheduler.release(slot)
            h = self._by_slot.pop(slot, None)
            if h is not None and not h.finished:
                h.tokens = [int(t) for t in tokens]
                self._finish(h, Status.FAILED)

    def _admit(self, h: Handle, slot: int):
        now = self.clock()
        if h.deadline is not None and now >= h.deadline:
            # expired exactly at the admit boundary: no prefill for a
            # request nobody is waiting on
            self._finish(h, Status.EXPIRED)
            return
        if not self.scheduler.start(h.req, slot):
            # chunked prefill under way: the slot is occupied (PREFILLING)
            # but no token exists yet — t_first waits for installation
            h.status = Status.RUNNING
            h.t_admit = self.clock()
            self._by_slot[slot] = h
            return
        self._installed(h, slot)

    def _installed(self, h: Handle, slot: int):
        """Prefill finished — atomically at admit, or on the last chunk —
        and the first token exists on the slot. gen==1 retires right here;
        a deadline that elapsed during prefill keeps the prefill token and
        frees the slot before it ever decodes."""
        h.status = Status.RUNNING
        t = self.clock()
        if h.t_admit is None:          # atomic admit: t_admit == t_first
            h.t_admit = t
        h.t_first = t
        h.tokens = [int(tk) for tk in self.engine.slots[slot].out]
        if self.engine.slots[slot].remaining == 0:
            self._by_slot.pop(slot, None)
            self.engine.retire(slot)         # gen==1 completes at admit
            self._finish(h, Status.DONE)
        elif h.deadline is not None and self.clock() >= h.deadline:
            h.tokens = [int(tk) for tk in self.engine.cancel(slot)]
            self._by_slot.pop(slot, None)
            self._finish(h, Status.EXPIRED)
        else:
            self._by_slot[slot] = h

    def _finish(self, h: Handle, status: Status):
        assert not h.finished, f"rid {h.rid} finalized twice"
        h.status = status
        h.t_done = self.clock()

    # -- streaming ----------------------------------------------------------

    def stream(self, h: Handle):
        """Incremental token iterator for one request: yields each token as
        soon as it exists, driving ``step()`` while waiting. Returns (ends
        the iterator) once the handle is terminal and drained — a rejected
        handle yields nothing, an expired one yields its partial tokens."""
        sent = 0
        while True:
            while sent < len(h.tokens):
                yield h.tokens[sent]
                sent += 1
            if h.finished:
                return
            self.step()

    # -- trace runner -------------------------------------------------------

    def run(self, requests: List[Request], *, log=None) -> List[Handle]:
        """Serve a trace (arrival-timed, like ``ServeEngine.run``) through
        the full front-end; returns handles in rid order."""
        t_anchor = self.clock()
        # trace deadlines are absolute *trace* seconds; rebase them onto
        # this run's clock anchor so step()'s comparisons line up
        pending = [r if r.deadline is None else
                   dataclasses.replace(r, deadline=r.deadline + t_anchor)
                   for r in sorted(requests,
                                   key=lambda r: (r.arrival, r.rid))]
        i = 0
        while i < len(pending) or any(not h.finished
                                      for h in self.handles.values()):
            now = self.clock() - t_anchor
            while i < len(pending) and pending[i].arrival <= now:
                h = self.submit(pending[i])
                if log and h.status is Status.REJECTED:
                    log(f"[frontend] rid={h.rid} rejected ({h.result})")
                i += 1
            busy = self.step()
            if not busy and i < len(pending):
                time.sleep(max(0.0, min(
                    pending[i].arrival - (self.clock() - t_anchor), 1e-3)))
        return [self.handles[r.rid] for r in
                sorted(requests, key=lambda r: r.rid)]


# ---------------------------------------------------------------------------
# asyncio layer
# ---------------------------------------------------------------------------

class AsyncServeFrontend:
    """asyncio skin over ``ServeFrontend``: one stepping task steps the shared
    engine; each request is an independent async token stream.

    >>> afe = AsyncServeFrontend(frontend)            # doctest: +SKIP
    >>> async def consume(req):
    ...     return [tok async for tok in afe.stream(await afe.submit(req))]

    Concurrent ``consume``s interleave: every step of that task wakes all
    waiting streams, so each request's tokens surface as its slot produces
    them — the decode step stays shared, only the waiting is multiplexed.
    """

    def __init__(self, frontend: ServeFrontend):
        import asyncio
        self._asyncio = asyncio
        self.frontend = frontend
        self._task = None
        self._wake = asyncio.Event()

    def _ensure_stepper(self):
        if self._task is None or self._task.done():
            # fresh, unset wake: a finished task leaves _wake permanently
            # set (its exit-path release), and Event.wait() on a set
            # event returns without yielding — a stream polling it would
            # livelock the loop and the new stepping task would never run
            self._wake = self._asyncio.Event()
            self._task = self._asyncio.ensure_future(self._drive())

    async def _drive(self):
        # terminate on `not busy` alone: once the queue is empty and no
        # slot is occupied there is nothing left to drive. Waiting for
        # every handle to finish instead would leave this task spinning
        # forever on a handle stranded outside queue and slots. A later
        # submit restarts the task (_ensure_stepper checks task.done()).
        try:
            while True:
                busy = self.frontend.step()
                self._wake.set()
                self._wake = self._asyncio.Event()
                await self._asyncio.sleep(0)
                if not busy:
                    return
        finally:
            self._wake.set()       # release any stragglers

    async def submit(self, req: Request) -> Handle:
        h = self.frontend.submit(req)
        self._ensure_stepper()
        return h

    async def stream(self, h: Handle):
        """Async token iterator; yields between engine iterations."""
        sent = 0
        while True:
            while sent < len(h.tokens):
                yield h.tokens[sent]
                sent += 1
            if h.finished:
                return
            self._ensure_stepper()
            await self._wake.wait()


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

def frontend_table(handles: List[Handle], wall: float) -> dict:
    """Outcome counts + latency percentiles over the served (DONE) subset."""
    by = {s: [h for h in handles if h.status is s] for s in Status}
    done = by[Status.DONE]
    out = {
        "requests": len(handles),
        "done": len(done),
        "rejected": len(by[Status.REJECTED]),
        "expired": len(by[Status.EXPIRED]),
        "cancelled": len(by[Status.CANCELLED]),
        "failed": len(by[Status.FAILED]),
        "tokens": int(sum(len(h.tokens) for h in handles)),
        "wall_s": wall,
        "tok_per_s": sum(len(h.tokens) for h in handles) / max(wall, 1e-9),
    }
    if done:
        lat = np.asarray([h.latency for h in done])
        ttft = np.asarray([h.ttft for h in done])
        out.update(
            lat_p50_ms=float(np.percentile(lat, 50)) * 1e3,
            lat_p99_ms=float(np.percentile(lat, 99)) * 1e3,
            ttft_p50_ms=float(np.percentile(ttft, 50)) * 1e3,
            ttft_p99_ms=float(np.percentile(ttft, 99)) * 1e3,
        )
    return out
