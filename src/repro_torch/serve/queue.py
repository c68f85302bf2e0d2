"""Front-end request lifecycle types and the typed backpressure result
(``repro.serve.queue``, copied; pure Python).

The admission policies (the bounded FIFO or shortest-prompt-first waiting
room, deadline expiry in the queue) live in ``serve/scheduler.py`` beside
the interleaving policy that drives them; :class:`AdmissionQueue` is
re-exported here. This module holds the request-visible state machine:
the :class:`Status` lifecycle (exactly one terminal per request) and the
typed :class:`Overloaded` rejection the bounded queue degrades into, so
that overload surfaces as a fast failure, not as unbounded latency.
"""
from __future__ import annotations

import dataclasses
import enum


class Status(enum.Enum):
    """Lifecycle states of a front-end request.

    Exactly one terminal state is reached per request: ``DONE`` (all
    ``gen`` tokens), ``REJECTED`` (queue full at submit, typed
    ``Overloaded`` result, zero engine work), ``EXPIRED`` (deadline passed;
    partial tokens are kept), ``CANCELLED`` (explicit caller cancel;
    partial tokens are kept), or ``FAILED`` (fleet serving only: the
    request's replica died and no survivor could absorb the re-dispatch;
    partial tokens are kept; see ``serve/router.py``).
    """
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    REJECTED = "rejected"
    EXPIRED = "expired"
    CANCELLED = "cancelled"
    FAILED = "failed"


TERMINAL = frozenset((Status.DONE, Status.REJECTED, Status.EXPIRED,
                      Status.CANCELLED, Status.FAILED))


@dataclasses.dataclass(frozen=True)
class Overloaded:
    """Typed backpressure result: the bounded queue was full at submit.

    Carried on the rejected handle's ``result`` so callers can tell "shed
    under overload" (retry elsewhere or later) from a served-but-failed
    request without parsing strings.
    """
    rid: int
    queue_depth: int

    def __str__(self):
        return (f"request {self.rid} rejected: queue full "
                f"(depth {self.queue_depth})")


from repro_torch.serve.scheduler import AdmissionQueue  # noqa: E402,F401
