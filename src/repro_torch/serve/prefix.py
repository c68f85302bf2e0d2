"""LRU prefix cache (``repro.serve.prefix``): reuse the prefill cache of a
recent prompt for a later request that starts with it.

The common production case is a long shared system prompt followed by a
short user-specific suffix. A cold admit prefills the whole prompt; this
cache keeps the batch-1 prefill cache trees of recent prompts, so a later
request whose prompt starts with a cached prompt's tokens skips
recomputing that prefix.

Exactness: in a pure causal global-attention stack, cache row ``i``
depends only on tokens ``<= i``, so any prefix of a cached prompt's rows
is exactly the cache a fresh prefill of that prefix would produce. Reuse
is a ``pos`` rewind to the hit length (rows beyond it are masked by
``key_idx <= pos`` and overwritten as decode proceeds), followed by
batch-1 decode steps over the un-cached suffix. Sliding-window rings break
the row-locality premise, so the engine consults this cache only on
replayable contracts; recurrent stacks use it in *whole-entry* mode: their
entries are state snapshots, reusable as they are but never rewindable
(``usable_prefix_len``).

Entries are whole device-resident cache trees (``(1, max_len, ...)`` a
leaf), so capacity is small and LRU: ``cap`` entries, the least recently
hit evicted first.

The copy rule. The port's decode step updates its cache in place: it
advances every ``pos`` and writes the new K/V row (or the new recurrent
state) into the tensors it is given. An entry handed to the suffix walk as
it is would therefore take the walking request's rows into the entry, and
a later request matching the entry's whole prompt would read them. So the
engine never walks on an entry: a hit copies the entry's tensors into a
private cache first (``ServeEngine.begin_admit``), and an insert that more
walking follows (the recurrent contract's first-chunk snapshot) stores a
copy. An entry's tensors are written once, before insertion, and never
again.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PrefixEntry:
    tokens: np.ndarray        # (P,) int32: the prompt this cache prefilled
    cache: object             # batch-1 prefill cache tree (device tensors)
    nbytes: int


def common_prefix_len(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the longest common prefix of two 1-D token arrays."""
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


def usable_prefix_len(entry_tokens: np.ndarray, tokens: np.ndarray,
                      whole_entry: bool = False) -> int:
    """How many leading ``tokens`` an entry for ``entry_tokens`` covers.

    Capped at ``len(tokens) - 1`` so at least one prompt token always runs
    through the model (its logits produce the first generated token).

    ``whole_entry=True`` is the recurrent contract: a KV cache can be
    rewound to any row, but a recurrent state is one lossy summary of
    everything the entry consumed, reusable only when the entry's full
    prompt is a proper prefix of the new one. Partial overlaps return 0.
    """
    L = min(common_prefix_len(entry_tokens, tokens), len(tokens) - 1)
    if whole_entry and L < len(entry_tokens):
        return 0
    return L


class PrefixCache:
    """LRU over recent prefill caches, looked up by longest shared prefix.

    ``min_hit`` is the smallest reusable prefix worth taking: a 1-token hit
    saves one prefill position but costs a cache scan, so tiny overlaps are
    treated as misses.
    """

    def __init__(self, cap: int = 8, min_hit: int = 4):
        if cap <= 0:
            raise ValueError(f"prefix cache cap must be > 0, got {cap}")
        self.cap, self.min_hit = cap, min_hit
        self._entries: "collections.OrderedDict[bytes, PrefixEntry]" = \
            collections.OrderedDict()
        self.hits = self.misses = self.evictions = 0
        self.reused_tokens = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    @staticmethod
    def _key(tokens: np.ndarray) -> bytes:
        return np.asarray(tokens, np.int32).tobytes()

    def lookup(self, tokens,
               whole_entry: bool = False) -> Optional[Tuple[PrefixEntry, int]]:
        """Best reusable entry for a new prompt, or None.

        Returns ``(entry, L)`` with ``L`` the number of leading prompt
        tokens the entry covers, capped at ``len(tokens) - 1``.
        ``whole_entry=True`` restricts matches to entries the prompt covers
        whole (``usable_prefix_len``). Counts a hit or a miss and refreshes
        the hit entry's LRU position.
        """
        tokens = np.asarray(tokens, np.int32)
        best, best_key, best_len = None, None, 0
        for key, e in self._entries.items():
            L = usable_prefix_len(e.tokens, tokens, whole_entry)
            if L > best_len:
                best, best_key, best_len = e, key, L
        if best is None or best_len < self.min_hit:
            self.misses += 1
            return None
        self.hits += 1
        self.reused_tokens += best_len
        self._entries.move_to_end(best_key)
        return best, best_len

    def insert(self, tokens, cache, nbytes: int):
        """Remember ``cache`` as the prefill of ``tokens`` (LRU evict). The
        caller hands over ``cache``: nothing may write it afterwards."""
        tokens = np.asarray(tokens, np.int32)
        key = self._key(tokens)
        if key in self._entries:            # refresh, don't duplicate
            self._entries.move_to_end(key)
            return
        self._entries[key] = PrefixEntry(tokens=tokens, cache=cache,
                                         nbytes=nbytes)
        while len(self._entries) > self.cap:
            self._entries.popitem(last=False)
            self.evictions += 1

    def stats(self) -> dict:
        return {"entries": len(self), "bytes": self.bytes, "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "reused_tokens": self.reused_tokens}
