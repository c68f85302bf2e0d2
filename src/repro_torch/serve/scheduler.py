"""Scheduling layer (``repro.serve.scheduler``, copied; pure Python): the
admit/prefill/decode interleaving policy over an engine's slot surface.

    caller (engine.run)
        |
        v
    Scheduler -- owns *when* admission work happens
        |   start(req, slot)  : begin_admit + first chunk
        |   advance()         : one chunk per PREFILLING slot
        |   AdmissionQueue    : who waits, and in what order
        v
    engine slot surface -- owns *what* is computed
        begin_admit / continue_admit / decode_step / retire / cancel

The first policy is **chunked prefill**: a cold admit consumes at most
``prefill_chunk`` prompt tokens per engine iteration. A slot mid-prefill is
occupied but PREFILLING — it skips decode lanes (``decoding_count``) until
its prompt is consumed, so co-resident slots take a decode step between
chunks and a long prompt never freezes their streams. Chunking changes
*when* work happens, never *what* is computed: token streams are
byte-identical to the unchunked engine.

``prefill_chunk=None`` (the default) is the atomic policy: ``start`` runs
the engine's one-shot ``admit`` to completion.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.serve import errors


class AdmissionQueue:
    """Bounded waiting room between ``submit`` and a free engine slot.

    Items must expose ``prompt_len`` and ``deadline`` attributes (the
    front-end queues its request handles). ``push`` refuses items beyond
    ``depth`` — the caller turns that into an ``Overloaded`` result
    (``repro.serve.queue``; the front-end is not ported yet). Deadlines
    are enforced here too: ``take_expired`` drops waiting items whose
    deadline passed without ever touching the engine.

    ``policy``:
      - ``"fifo"`` — strict arrival order.
      - ``"spf"`` — shortest-prompt-first: ``pop`` picks the waiting item
        with the fewest prompt tokens (ties broken by arrival order, so
        equal-length requests stay FIFO).
    """

    POLICIES = ("fifo", "spf")

    def __init__(self, depth: int, policy: str = "fifo"):
        if depth < 0:
            raise ValueError(f"queue depth must be >= 0, got {depth}")
        if policy not in self.POLICIES:
            raise ValueError(f"unknown queue policy {policy!r}; "
                             f"known: {self.POLICIES}")
        self.depth, self.policy = depth, policy
        self._items: List = []

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    @property
    def full(self) -> bool:
        return len(self._items) >= self.depth

    def push(self, item) -> bool:
        """Enqueue ``item``; False (and no side effect) when full."""
        if self.full:
            return False
        self._items.append(item)
        return True

    def pop(self):
        """Next item to admit under the configured policy."""
        if not self._items:
            raise IndexError("pop from empty AdmissionQueue")
        if self.policy == "spf":
            i = min(range(len(self._items)),
                    key=lambda j: self._items[j].prompt_len)
        else:
            i = 0
        return self._items.pop(i)

    def take_expired(self, now: float) -> List:
        """Remove and return every waiting item whose deadline has passed
        (``deadline <= now``); queue order of the survivors is preserved."""
        expired = [it for it in self._items
                   if it.deadline is not None and it.deadline <= now]
        if expired:
            self._items = [it for it in self._items
                           if not (it.deadline is not None
                                   and it.deadline <= now)]
        return expired

    def remove(self, item) -> bool:
        """Remove a specific waiting item (explicit cancel); False if the
        item is not queued."""
        try:
            self._items.remove(item)
            return True
        except ValueError:
            return False


class Scheduler:
    """Admit/prefill/decode interleaving policy over one engine.

    Parameters
    ----------
    engine        : anything exposing the slot surface. The atomic policy
                    needs only ``admit``; chunking additionally needs the
                    non-atomic ``begin_admit``/``continue_admit`` split
                    (refused up-front via ``errors.py`` otherwise).
    prefill_chunk : max prompt tokens one admit consumes per engine
                    iteration; None = atomic (whole-prompt) admits.
    queue_depth   : bounded waiting room (0 = admit-or-reject).
    policy        : admission order, ``AdmissionQueue.POLICIES``.
    prefix_cache  : optional ``PrefixCache`` handed to every admit.

    Serving loops call ``start`` for a fresh admission, ``advance`` once per
    iteration to push every PREFILLING slot one chunk forward, and
    ``should_decode`` to decide whether a shared decode step has any lane
    to serve. ``release`` forgets a PREFILLING slot freed behind the
    scheduler's back (deadline expiry, caller cancel, replica failure) —
    the partial prefill is discarded with it, zero tokens kept.
    """

    def __init__(self, engine, *, prefill_chunk: Optional[int] = None,
                 queue_depth: int = 0, policy: str = "fifo",
                 prefix_cache=None):
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(errors.msg("chunk_invalid",
                                            chunk=prefill_chunk))
            if not (hasattr(engine, "begin_admit")
                    and hasattr(engine, "continue_admit")):
                name = getattr(getattr(engine, "cfg", None), "name",
                               type(engine).__name__)
                raise ValueError(errors.msg("chunk_unsupported", name=name))
        self.engine = engine
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = prefix_cache
        self.queue = AdmissionQueue(queue_depth, policy=policy)
        self._prefilling: set = set()

    @property
    def chunked(self) -> bool:
        return self.prefill_chunk is not None

    def prefilling(self) -> List[int]:
        """Slots whose admit is in flight (occupied, not yet decoding)."""
        return sorted(self._prefilling)

    def start(self, req, slot: int) -> bool:
        """Admit ``req`` into ``slot``; True once its prefill is complete
        (the first token exists on the slot). False marks the slot
        PREFILLING: later ``advance`` calls consume the rest of the
        prompt, one chunk per call."""
        if not self.chunked:
            self.engine.admit(req, slot, prefix_cache=self.prefix_cache)
            return True
        self.engine.begin_admit(req, slot, prefix_cache=self.prefix_cache)
        if self.engine.continue_admit(slot, self.prefill_chunk):
            return True
        self._prefilling.add(slot)
        return False

    def advance(self) -> List[int]:
        """One chunk of prefill for every PREFILLING slot; returns the
        slots whose prompt is now fully consumed (decode-eligible, first
        token on the slot). Call once per engine iteration — the per-slot
        budget discipline (at most ``prefill_chunk`` tokens per iteration)
        is exactly one ``continue_admit`` per slot per call."""
        done = []
        for slot in sorted(self._prefilling):
            if self.engine.continue_admit(slot, self.prefill_chunk):
                done.append(slot)
        self._prefilling.difference_update(done)
        return done

    def release(self, slot: int):
        """Forget a PREFILLING slot whose request left the engine
        (cancelled/expired/failed); no-op for non-prefilling slots."""
        self._prefilling.discard(slot)

    def should_decode(self) -> bool:
        """Whether a shared decode step has any lane to serve: occupied
        slots that are *not* mid-prefill. Engines without a
        ``decoding_count`` surface never hold a PREFILLING slot (the
        atomic policy is all they support), so occupancy is the answer."""
        dc = getattr(self.engine, "decoding_count", None)
        return (dc() if dc is not None else self.engine.active_count()) > 0
