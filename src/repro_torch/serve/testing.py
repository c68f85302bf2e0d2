"""Pure-Python fake engines for scheduler and router tests
(``repro.serve.testing``, copied).

``FleetFakeEngine`` exposes exactly the engine-agnostic slot surface the
front-end and ``ReplicaRouter`` consume (``free_slots`` / ``admit`` /
``decode_step`` / ``retire`` / ``cancel`` / ``begin`` / ``slots`` /
``active_count``), plus the non-atomic ``begin_admit`` /
``continue_admit`` / ``decoding_count`` split that the scheduler's
chunked-prefill policy drives, with no model anywhere, so fleet-level
scheduling paths run instantly and deterministically on CI. Like the
real engine, a mid-prefill slot holds its work aside and "installs"
atomically when the prompt is consumed — the recurrent fake only
scatters its state vector at install, so the property suites can check
that chunk writes never leak into the shared state before completion.

Two properties matter for fleet tests:

- **attributable tokens** — ``fleet_token(rid, i)`` is injective in
  ``(rid, i)``, so any cross-replica or cross-request contamination is
  detectable by value. Prompts in tests must stay below
  ``FLEET_TOKEN_BASE`` so prompt tokens can never collide with generated
  ones.
- **greedy determinism, mimicked** — a real engine re-prefilled with
  ``prompt + out[:-1]`` reproduces ``out[-1]`` exactly (argmax of the
  same logits). The fake mimics that: when a prompt *ends with* one of
  the rid's own generated tokens, the "prefill" continues the stream
  from it instead of restarting at index 0. That is precisely the
  router's re-dispatch contract, so replica-death tests exercise the
  real overlap bookkeeping.

Fault injection: set ``fail_next_admit = True`` to make the next admit
raise (death during prefill), ``fail_next_decode = True`` for death
mid-decode. ``step_time`` adds a per-``decode_step`` sleep (the whole
fused step, lanes in parallel) so FakeEngine-backed throughput benches
model a fleet of fixed-cost decode steps.
"""
from __future__ import annotations

import time
from typing import List, Optional

from repro_torch.serve import errors

FLEET_TOKEN_BASE = 10_000


def fleet_token(rid: int, i: int) -> int:
    """The i-th token a FleetFakeEngine generates for request ``rid``.
    Injective in (rid, i); always >= FLEET_TOKEN_BASE."""
    return (rid + 1) * FLEET_TOKEN_BASE + i


class _FakeSlot:
    def __init__(self):
        self.rid, self.remaining, self.out, self.req = -1, 0, [], None
        self._next = 0                     # next stream index to emit
        self.pending = None                # prompt tokens left to prefill

    @property
    def free(self):
        return self.req is None


class _FakeCompletion:
    def __init__(self, rid, tokens):
        self.rid, self.tokens = rid, tokens


class _FakeCfg:
    name, family = "fleet-fake", "lm"
    vocab_size = 1 << 30


class FleetFakeEngine:
    """Engine-surface fake: one ``decode_step`` = one token per active
    slot, ``step_time`` seconds of (GIL-releasing) wall time per step."""

    cfg = _FakeCfg()
    contract = "kv"                # slot-cache contract (serve/cache.py)

    def __init__(self, n_slots: int, *, step_time: float = 0.0,
                 prefix_ok: bool = False):
        self.n_slots = n_slots
        self.step_time = step_time
        self._prefix_ok = prefix_ok
        self.slots = [_FakeSlot() for _ in range(n_slots)]
        self.stats = {"admits": 0, "decode_steps": 0, "cancels": 0,
                      "chunk_steps": 0}
        self.fail_next_admit = False
        self.fail_next_decode = False
        self.cache_bytes = 0

    def begin(self, t0: Optional[float] = None):
        self._t0 = t0

    def prefix_eligible(self) -> bool:
        return self._prefix_ok

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.free]

    def active_count(self) -> int:
        return sum(not s.free for s in self.slots)

    def _start_index(self, req) -> int:
        """Greedy-determinism mimicry: a prompt ending in one of rid's
        own generated tokens (index ``i``) is a re-dispatch
        continuation, so the 'prefill' emits stream token ``i + 1`` —
        exactly what a real engine's argmax reproduces when re-prefilled
        with ``prompt + out[:-1]``. Fresh prompts start at index 0."""
        t = int(req.tokens[-1])
        if t >= FLEET_TOKEN_BASE:
            rid, i = divmod(t, FLEET_TOKEN_BASE)
            if rid - 1 == req.rid:
                return i + 1
        return 0

    def decoding_count(self) -> int:
        """Occupied slots past their prefill (eligible for decode lanes);
        a PREFILLING slot is active but not decoding."""
        return sum((not s.free) and s.pending is None for s in self.slots)

    def begin_admit(self, req, slot: int, prefix_cache=None):
        """First half of the non-atomic admit: bind the slot, no prefill
        work yet. The slot is PREFILLING (skipped by decode) until
        ``continue_admit`` consumes the whole prompt."""
        if self.fail_next_admit:
            self.fail_next_admit = False
            raise RuntimeError("injected admit failure")
        s = self.slots[slot]
        assert s.free, f"admit into occupied slot {slot}"
        self.stats["admits"] += 1
        s.rid, s.req = req.rid, req
        s.out = []
        s._next = self._start_index(req)
        s.remaining = req.gen
        s.pending = len(req.tokens)

    def continue_admit(self, slot: int,
                       budget: Optional[int] = None) -> bool:
        """Consume up to ``budget`` prompt tokens (the whole remainder
        when None); True once the prompt is consumed and the first
        token is installed."""
        s = self.slots[slot]
        if s.pending is None:
            raise ValueError(errors.msg("continue_without_begin",
                                        slot=slot))
        take = s.pending if budget is None \
            else min(max(1, int(budget)), s.pending)
        s.pending -= take
        if s.pending:
            self.stats["chunk_steps"] += 1
            return False
        self._install(slot)
        return True

    def _install(self, slot: int):
        """Prompt fully consumed: emit the prefill token. The recurrent
        subclass also scatters its state vector here — held aside until
        completion, exactly like the real engine's slot-cache write."""
        s = self.slots[slot]
        s.out = [fleet_token(s.rid, s._next)]
        s._next += 1
        s.remaining = s.req.gen - 1
        s.pending = None

    def admit(self, req, slot: int, prefix_cache=None):
        """Atomic admit: ``begin_admit`` + ``continue_admit`` over the
        whole prompt in one call."""
        self.begin_admit(req, slot, prefix_cache=prefix_cache)
        self.continue_admit(slot)

    def decode_step(self) -> List[int]:
        if self.fail_next_decode:
            self.fail_next_decode = False
            raise RuntimeError("injected decode failure")
        if self.step_time:
            time.sleep(self.step_time)             # releases the GIL
        self.stats["decode_steps"] += 1
        retired = []
        for i, s in enumerate(self.slots):
            if s.free or s.pending is not None or s.remaining == 0:
                continue
            s.out.append(fleet_token(s.rid, s._next))
            s._next += 1
            s.remaining -= 1
            if s.remaining == 0:
                retired.append(i)
        return retired

    def retire(self, slot: int) -> _FakeCompletion:
        s = self.slots[slot]
        assert not s.free, f"retire of free slot {slot}"
        comp = _FakeCompletion(s.rid, list(s.out))
        s.rid, s.req, s.remaining, s.pending = -1, None, 0, None
        return comp

    def cancel(self, slot: int) -> List[int]:
        s = self.slots[slot]
        if s.free:
            raise ValueError(f"cancel of free slot {slot}")
        partial = list(s.out)
        s.rid, s.req, s.remaining, s.pending = -1, None, 0, None
        self.stats["cancels"] += 1
        return partial


FAKE_STATE_SIZE = 4                # fixed per-slot state width (recurrent)


class RecurrentFleetFakeEngine(FleetFakeEngine):
    """``FleetFakeEngine`` honouring the *recurrent* slot-cache contract
    (``serve/cache.py``): per-slot state is a
    fixed-size vector written wholesale at admit (the state scatter),
    advanced by ONE shared recurrent step per ``decode_step``, and zeroed
    at retire/cancel — never grown. The state encodes
    ``(rid + 1, tokens processed)`` injectively, so ``check_state`` can
    detect by value every contract violation the property suites hunt:
    state growth, a missed reset (stale state visible to the next admit),
    and cross-slot/cross-replica contamination."""

    contract = "recurrent"

    def __init__(self, n_slots: int, **kw):
        super().__init__(n_slots, **kw)
        self.state = [self._zero() for _ in range(n_slots)]

    @staticmethod
    def _zero():
        return [0] * FAKE_STATE_SIZE

    def begin_admit(self, req, slot: int, prefix_cache=None):
        assert self.state[slot] == self._zero(), \
            f"admit into slot {slot} over stale recurrent state"
        super().begin_admit(req, slot, prefix_cache=prefix_cache)

    def _install(self, slot: int):
        super()._install(slot)
        s = self.slots[slot]
        # scatter: the whole prompt + the prefill token, written at once
        # when the (possibly chunked) prefill completes — never earlier
        self.state[slot] = [s.rid + 1, len(s.req.tokens) + 1] \
            + [0] * (FAKE_STATE_SIZE - 2)

    def decode_step(self) -> List[int]:
        stepped = [i for i, s in enumerate(self.slots)
                   if not s.free and s.pending is None and s.remaining > 0]
        retired = super().decode_step()
        for i in stepped:                  # the one shared recurrent step
            self.state[i][1] += 1
        return retired

    def retire(self, slot: int):
        comp = super().retire(slot)
        self.state[slot] = self._zero()    # contract: reset, not dangle
        return comp

    def cancel(self, slot: int) -> List[int]:
        partial = super().cancel(slot)
        self.state[slot] = self._zero()
        return partial

    def check_state(self):
        """Assert the recurrent contract on the spot: constant state
        size, zeroed state on every free slot, and each occupied slot's
        state attributing exactly its own request at exactly its own
        position (prompt + emitted tokens)."""
        assert len(self.state) == self.n_slots
        for i, (s, st) in enumerate(zip(self.slots, self.state)):
            assert len(st) == FAKE_STATE_SIZE, \
                f"slot {i}: state grew to {len(st)}"
            if s.free:
                assert st == self._zero(), f"slot {i}: stale state {st}"
            elif s.pending is not None:
                # mid-chunked-prefill: work is held aside, nothing may
                # touch the shared state until install
                assert st == self._zero(), \
                    f"slot {i}: state scattered before install: {st}"
            else:
                want = [s.rid + 1, len(s.req.tokens) + len(s.out)] \
                    + [0] * (FAKE_STATE_SIZE - 2)
                assert st == want, \
                    f"slot {i}: state {st} != expected {want}"


class ManualClock:
    """Injectable front-end clock for deterministic deadline tests."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt
