"""Slot-based continuous-batching serving engine (``repro.serve.engine``).

Lifecycle:

  submit -> [queue] -> admit (bucketed prefill, write slot) -> decode ...
            -> retire (slot freed) -> refill mid-flight from the queue

Admission is non-atomic under the hood: ``begin_admit`` binds a request to
a slot (PREFILLING — occupied, but skipping decode lanes) and
``continue_admit`` consumes prompt tokens up to a budget, installing the
slot once the prompt is done. ``admit`` is the atomic composition; the
scheduler (``serve/scheduler.py``) time-slices ``continue_admit`` to
interleave chunked prefills with decode steps. Either way the computed
tokens are identical.

One shared decode step runs over all ``n_slots`` slots per iteration;
per-slot ``pos`` valid-lengths inside the cache drive the masked decode
attention (the ``flash_decode`` kernel on the card), so slots at different
sequence positions coexist in one step. The step updates the slot cache in
place (JAX donates it). Finished requests retire and their slot is refilled
immediately — no batch barrier.

Two slot-cache contracts are served (``serve/cache.py``):

- ``kv`` (pure global-attention stacks): prompts are right-padded to the
  next power-of-two bucket and prefilled with per-sample true ``lengths``
  (causal attention keeps cache rows < length exact — see ``lm_prefill``).
- ``recurrent`` (rwkv, and any stack with a Mamba layer: the jamba
  hybrid): a state would absorb pad tokens, so prefill is exact-length,
  and the first chunk is a multiple of the smallest bucket, at most
  ``P - 1``; the rest of the prompt walks through the batch-1 decode
  step. Retire and cancel reset the slot's lanes to the empty cache (zero
  states; a hybrid's attention lanes back to ``pos`` 0).
- ``encdec`` (seamless): a slot holds the decoder's self-attention K/V up
  to ``max_len`` beside the memory K/V of ``mem_len`` rows, which every
  request's ``frames`` must match; the decoder prompt is bucketed and
  ragged as under ``kv``, and the frames go into the first prefill chunk.

Pruned models plug in transparently: a ``cfg.pruned(...)`` config shrinks
``eff_qk`` and the slot cache's K rows shrink with it.

A prefix cache (``serve/prefix.py``) handed to ``admit`` lets a prompt that
starts with a cached prompt skip the cached rows: under ``kv`` the entry
is rewound to the hit length, under ``recurrent`` a whole-prompt state
snapshot is reused as it is, and the suffix walks through the batch-1
decode step. That step writes its cache in place, so a hit walks on a
private copy of the entry, never on the entry (the copy rule,
``serve/prefix.py``).

Besides the JAX engine's counters, ``stats`` sums the host-clock seconds
of shared decode steps (``decode_s``), of first-chunk prefills
(``prefill_s``) and of batch-1 walk steps (``walk_s``); each ends in a
device-to-host copy of the next tokens, so it includes the device work.
``walk_steps`` counts the batch-1 decode steps that consume prompt tokens
after the first chunk or after a prefix hit.

Mesh sharding (``sharding=``, a ``serve.sharding.ServeSharding``): every
rank builds the engine with the same arguments and keeps its blocks of the
params (``distrib.sharding.forward_specs``) and of the slot cache
(``slot_specs``); its forward is tensor-parallel over the model axis
(``models.common.TensorParallel``). The lead (the mesh's first rank) alone
runs the scheduler, the front-end and every method above; each device
operation it makes (a prefill or a chunk of one, a batch-1 walk step, the
write of a slot, a decode step, the reset of a slot or of the cache) is
posted to every rank before it runs, and the other ranks run them in
``follow`` until the lead's ``stop``. A slot's prefill and walk run only
on the ranks of the data index that holds the slot, and their token comes
to the lead from that index' first rank; a decode step runs on every rank
over its slots, and the next tokens reach the lead with one gather over
the data axis. An enc-dec request's frames are posted with its prefill,
and the ranks of the data index that holds its slot encode them. Routed
MoE shares an expert's capacity across a routing group, so a decode step
whose slots are split over the data axis hands the forward that axis'
context (``TensorParallel.rows``): the MoE layers gather the step's rows,
route them as one device does, and keep their own. Only the lead decides
on admission and retirement. Every family is served (MLA from its latent
blocks, the Mamba hybrid over its inner channels); a config whose heads,
channels or experts do not divide the model axis is refused
(``distrib.sharding.check_forward_split``), and so is a prefix cache.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.interop import flatten, map_tree
from repro_torch.serve import errors
from repro_torch.serve.cache import (RecurrentSlotCache, SlotCache,
                                     cache_bytes, cache_contract)


def _private(cache):
    """A copy of a cache tree that later in-place writes to either side
    cannot reach (the copy rule of ``serve/prefix.py``)."""
    return map_tree(torch.clone, cache)


@dataclasses.dataclass(frozen=True)
class _Held:
    """The lead's handle of a sharded admit's batch-1 cache, which the
    ranks that hold ``slot`` keep (``ServeEngine._locals``)."""
    slot: int


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (P,) int32 prompt tokens
    gen: int                      # tokens to generate (>= 1)
    arrival: float = 0.0          # seconds relative to trace start
    frames: Optional[np.ndarray] = None   # (S, D) enc-dec memory frames
    deadline: Optional[float] = None      # absolute trace time; None = none


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray            # (gen,) generated tokens
    prompt_len: int
    arrival: float
    t_admit: float                # queue -> slot (prefill done)
    t_first: float                # first generated token available
    t_done: float                 # last token available

    @property
    def latency(self) -> float:
        return self.t_done - self.arrival

    @property
    def ttft(self) -> float:
        return self.t_first - self.arrival


@dataclasses.dataclass
class _Prefill:
    """In-flight (possibly chunked) admit for one slot: the batch-1 local
    cache being built and how much of the prompt it has absorbed. Held
    aside until the whole prompt is consumed, then installed with a single
    slot write, so the shared cache never sees a half-prefilled slot."""
    req: Request
    local: object = None           # batch-1 cache tree (None pre-chunk-1)
    consumed: int = 0              # prompt tokens absorbed into ``local``
    first: Optional[int] = None    # first generated token (set at the end)
    prefix_cache: object = None    # insert/lookup target (None if unused)


@dataclasses.dataclass
class _Slot:
    rid: int = -1
    remaining: int = 0
    out: list = dataclasses.field(default_factory=list)
    req: Optional[Request] = None
    t_admit: float = 0.0
    t_first: float = 0.0
    pending: Optional[_Prefill] = None   # set while PREFILLING

    @property
    def free(self) -> bool:
        return self.req is None


_SHARDED_PREFIX = ("a prefix cache on a mesh-sharded engine is not ported "
                   "(ROADMAP Queue 1 item 2b-ii); serve sharded without "
                   "one")


def default_buckets(max_len: int, lo: int = 8):
    """Power-of-two prompt buckets up to max_len."""
    out, b = [], lo
    while b < max_len:
        out.append(b)
        b *= 2
    return out + [max_len]


class ServeEngine:
    """Continuous-batching engine over a preallocated ``SlotCache``.

    Parameters
    ----------
    model, params : the (possibly pruned) model to serve; the engine runs
                    on the device its params are on.
    n_slots       : concurrent requests sharing the decode step.
    max_len       : per-slot sequence budget (prompt + generation).
    buckets       : prompt-length buckets (default: powers of two).
    mem_len       : enc-dec only — fixed encoder-memory length every
                    request's ``frames`` must match (cross K/V is unmasked).
    sharding      : a ``serve.sharding.ServeSharding``: serve this rank's
                    blocks of ``params`` (the whole tree on the rank's
                    device, or its ``RankParams``) and of the slot cache
                    (module docstring).
    """

    def __init__(self, model, params, *, n_slots: int, max_len: int,
                 buckets=None, mem_len: Optional[int] = None,
                 sharding=None):
        cfg = model.cfg
        if model.prefill is None or model.decode_step is None:
            raise ValueError(errors.msg("no_serving_path", name=cfg.name,
                                        family=cfg.family))
        self.sharding, self.tp = sharding, None
        self.contract = cache_contract(cfg)
        self.mem_len = mem_len
        # ragged (bucketed) prefill: sound iff every cache row < length is
        # independent of the padded tail — pure causal global attention (a
        # window ring or a recurrent state would take in the pad tokens)
        self.ragged_ok = set(cfg.layer_kinds) == {"attn"}
        self.model, self.cfg, self.params = model, cfg, params
        self.device = next(iter(flatten(params).values())).device
        self.n_slots, self.max_len = n_slots, max_len
        self.buckets = sorted(buckets) if buckets else \
            default_buckets(max_len)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.tokens = np.zeros((n_slots,), np.int32)   # next decode inputs
        cache_cls = RecurrentSlotCache if self.contract == "recurrent" \
            else SlotCache
        self.slotcache = cache_cls(self._cache_template, n_slots,
                                   device=self.device, sharding=sharding,
                                   name=cfg.name)
        if sharding is not None:
            from repro_torch.distrib.sharding import (RankParams,
                                                      check_forward_split)
            check_forward_split(cfg, sharding.model_size)
            if not isinstance(params, RankParams):
                params = sharding.take_params(params)
            self.params, self.param_specs = dict(params), params.specs
            self.tp = sharding.tp
            # the data axis' context of a decode step over split slots,
            # which routed MoE takes to route the whole step (tp.rows)
            self._rows = sharding.rows if cfg.moe is not None \
                and self.slotcache.slot_split else None
            self._locals = {}      # slot -> this rank's batch-1 cache
            # every rank's parameter bytes and its card's peak allocation
            # so far (its set-up when the caller reset the peak before
            # placing its blocks; 0 on the CPU)
            self.rank_param_bytes = sharding.gather_all(
                cache_bytes(self.params))
            self.rank_setup_peak = sharding.gather_all(
                torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        self.stats = collections.Counter()
        self._t0 = None

    # -- steps --------------------------------------------------------------

    def _cache_template(self, batch: int, device):
        if self.contract != "encdec":
            return self.model.init_cache(batch, self.max_len, device)
        if self.mem_len is None:
            raise ValueError(errors.msg("encdec_needs_mem_len"))
        return self.model.init_cache(batch, self.max_len, device,
                                     mem_len=self.mem_len)

    def _argmax(self, logits):
        last = logits[:, -1]
        if self.tp is not None and last.shape[-1] != self.cfg.padded_vocab:
            return self.tp.vocab_argmax(last, self.cfg.vocab_size) \
                .to(torch.int32)
        return last[:, : self.cfg.vocab_size].argmax(-1).to(torch.int32)

    def _tp_kw(self):
        return {} if self.tp is None else {"tp": self.tp}

    def _tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)) \
            .to(self.device)

    def _prefill(self, tokens, lengths, frames=None, slot=None):
        """One prefill; ``frames`` (S, D): an enc-dec request's memory.
        Sharded, it runs on the ranks that hold ``slot``, which keep its
        cache: the lead gets a ``_Held`` handle."""
        if self.sharding is not None:
            # the frames travel with the prefill: the ranks of the data
            # index that holds the slot encode them
            tokens = np.asarray(tokens, np.int32)
            nxt = self._post("prefill", slot, tokens.shape[1],
                             int(lengths[0]), tokens, frames)
            return nxt, _Held(slot)
        return self._prefill_here(tokens, lengths, frames)

    def _prefill_here(self, tokens, lengths, frames=None):
        batch = {"tokens": self._tensor(tokens)}
        if frames is not None:
            batch["frames"] = torch.from_numpy(
                np.asarray(frames, np.float32))[None].to(self.device)
        logits, cache = self.model.prefill(
            self.params, batch, self.max_len,
            lengths=self._tensor(lengths) if self.ragged_ok else None,
            **self._tp_kw())
        return self._argmax(logits).cpu().numpy(), cache

    def _decode(self, tokens, cache):
        """One decode step over ``cache`` (updated in place); a ``_Held``
        cache is a sharded admit's batch-1 walk step."""
        if isinstance(cache, _Held):
            return self._post("walk", cache.slot, int(tokens[0][0]))
        return self._decode_here(tokens, cache)

    def _decode_here(self, tokens, cache):
        logits, _ = self.model.decode_step(self.params, self._tensor(tokens),
                                           cache, **self._tp_kw())
        return self._argmax(logits).cpu().numpy()

    # -- sharded: the lead's posted device operations -----------------------

    def _post(self, op: str, slot: int = -1, a: int = 0, b: int = 0,
              payload=None, floats=None):
        """Lead: post a device operation to every rank, then run it here;
        returns its tokens (prefill, walk, decode)."""
        self.sharding.post(op, slot, a, b, payload, floats)
        return self._run_op(op, slot, a, b, payload, floats)

    def _run_op(self, op, slot, a, b, payload, floats=None):
        """One posted operation on this rank's blocks; every rank runs it,
        the ranks that do not hold ``slot`` enter none of its collectives
        but the control broadcast of its token."""
        sc, sh = self.slotcache, self.sharding
        if op in ("prefill", "walk"):
            nxt = None
            if sc.owns(slot):
                if op == "prefill":
                    frames = None if floats is None \
                        else floats.reshape(self.mem_len, -1)
                    nxt, self._locals[slot] = self._prefill_here(
                        payload.reshape(1, a), [b], frames)
                else:
                    nxt = self._decode_here([[a]], self._locals[slot])
            return sh.from_group(nxt, sc.owner(slot))
        if op == "decode":
            lo, hi = sc.slot_range()
            if self._rows is None:
                nxt = self._decode_here(payload[lo:hi, None], sc.cache)
            else:   # routed MoE routes the whole step over the data axis
                self.tp.rows = self._rows
                try:
                    nxt = self._decode_here(payload[lo:hi, None], sc.cache)
                finally:
                    self.tp.rows = None
            return sh.gather_data(nxt, hi - lo) if sc.slot_split else nxt
        if op == "install":
            if sc.owns(slot):
                sc.write_slot(self._locals.pop(slot), slot)
        elif op == "reset_slot":
            if sc.owns(slot):
                sc.reset_slot(slot)
            self._locals.pop(slot, None)
        elif op == "reset":
            sc.reset()
            self._locals.clear()
        return None

    def follow(self):
        """Every rank but the lead: run the lead's posted operations, in
        order, until it calls ``stop``."""
        while True:
            op, slot, a, b, payload, floats = self.sharding.receive()
            if op == "stop":
                return
            self._run_op(op, slot, a, b, payload, floats)

    def stop(self):
        """Lead: release the following ranks (their ``follow`` returns)."""
        if self.sharding is not None and self.sharding.lead:
            self.sharding.post("stop")

    def _write_slot(self, local, slot: int):
        if self.sharding is not None:
            self._post("install", slot)
        else:
            self.slotcache.write_slot(local, slot)

    def _reset_slot(self, slot: int):
        if self.sharding is not None:
            self._post("reset_slot", slot)
        else:
            self.slotcache.reset_slot(slot)

    # -- slot management ----------------------------------------------------

    def _bucket(self, n: int) -> int:
        if not self.ragged_ok:
            return n                       # exact-length prefill
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(errors.msg("prompt_exceeds_bucket", n=n,
                                    bucket=self.buckets[-1]))

    def _stat_bucket(self, L: int) -> int:
        """Key of the ``prefill_b*`` stats counters: the smallest bucket
        covering ``L``, so exact-length prefills keep the counter family
        bounded by the bucket table."""
        for b in self.buckets:
            if b >= L:
                return b
        return self.buckets[-1]

    def _first_chunk_len(self, n: int, P: int) -> int:
        """Prompt tokens the first prefill of an admit consumes, given a
        budget of ``n`` (<= ``P``), as the JAX engine does. Ragged stacks
        prefill any prefix (padded to a bucket); other KV stacks (a window
        ring) prefill the whole prompt at its exact length, or a partial
        chunk quantised to a multiple of the smallest bucket; recurrent
        stacks prefill such a multiple, at most ``P - 1`` (at least 1), and
        leave the rest to the batch-1 walk."""
        if self.ragged_ok:
            return n
        if self.contract != "recurrent" and n >= P:
            return P                   # whole-prompt exact prefill
        cap = min(n, P - 1) if self.contract == "recurrent" else n
        lo = self.buckets[0]
        return max(1, lo * (cap // lo))

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.free]

    def active_count(self) -> int:
        return sum(not s.free for s in self.slots)

    def decoding_count(self) -> int:
        """Occupied slots actually in the decode phase (a PREFILLING slot
        has no token to feed the shared decode step yet)."""
        return sum((not s.free) and s.pending is None for s in self.slots)

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def begin(self, t0: Optional[float] = None):
        """Anchor the engine clock. ``run``/``warmup`` call this; callers
        that call ``admit``/``decode_step`` directly (the front-end) call
        it once before serving."""
        self._t0 = time.perf_counter() if t0 is None else t0

    # prefix reuse needs a replayable contract: pure causal global
    # attention (any prefix of the rows is a rewind), or a recurrent state
    # reused whole (serve/prefix.py::usable_prefix_len). Enc-dec is
    # excluded because the encoder memory keys the cross attention, not the
    # prompt alone; window rings are neither rewindable nor whole snapshots
    def prefix_eligible(self) -> bool:
        return (self.ragged_ok and self.cfg.family == "lm") \
            or self.contract == "recurrent"

    def begin_admit(self, req: Request, slot: int, prefix_cache=None):
        """Bind ``req`` to ``slot`` without running any prefill work: the
        slot is PREFILLING — occupied (``free`` is False) but skipping
        decode lanes until ``continue_admit`` consumes the whole prompt.

        With a ``prefix_cache`` on a prefix-eligible stack the cache is
        consulted here. A hit adopts the cached rows up front, on a
        private copy of the entry (the walk writes its cache in place):
        the ``kv`` contract rewinds the copy to the hit length, the
        ``recurrent`` contract reuses the whole-prompt state snapshot."""
        P = len(req.tokens)
        if P + req.gen > self.max_len:
            raise ValueError(errors.msg("request_exceeds_max_len",
                                        rid=req.rid, prompt=P, gen=req.gen,
                                        max_len=self.max_len))
        if self.contract == "encdec":
            fr = np.asarray(req.frames)
            if fr.shape[0] != self.mem_len:
                raise ValueError(errors.msg(
                    "frames_mem_len_mismatch", rid=req.rid,
                    frames=fr.shape[0], mem_len=self.mem_len))
        if prefix_cache is not None and self.sharding is not None:
            raise NotImplementedError(_SHARDED_PREFIX)
        use_prefix = prefix_cache is not None and self.prefix_eligible()
        recurrent = self.contract == "recurrent"
        st = _Prefill(req=req,
                      prefix_cache=prefix_cache if use_prefix else None)
        hit = prefix_cache.lookup(req.tokens, whole_entry=recurrent) \
            if use_prefix else None
        if hit is not None:
            entry, hit_len = hit
            st.local = _private(entry.cache)
            if not recurrent:
                from repro_torch.models.lm import override_cache_pos
                st.local = override_cache_pos(st.local, torch.full(
                    (1,), hit_len, dtype=torch.int32, device=self.device))
            st.consumed = hit_len
            self.stats["prefix_hits"] += 1
            self.stats["prefix_reused_tokens"] += hit_len
            self.stats["prefix_suffix_tokens"] += P - hit_len
        s = self.slots[slot]
        if s.out:                      # slot previously served a request
            self.stats["refills"] += 1
        s.rid, s.req, s.out = req.rid, req, []
        s.remaining = req.gen
        s.pending = st
        self.stats["admits"] += 1

    def continue_admit(self, slot: int,
                       budget: Optional[int] = None) -> bool:
        """Consume up to ``budget`` prompt tokens of ``slot``'s in-flight
        admit (the whole remainder when None); True once the prompt is
        consumed and the slot is installed (first token on ``out``,
        decode-eligible).

        The first chunk is a *prefix prefill* — exact because every causal
        KV row, and a recurrent state, carries only its own history; padded
        to a bucket only on ragged stacks — and later tokens walk one at a
        time through the batch-1 decode step.
        The local cache is installed with a single slot write at the end.
        """
        s = self.slots[slot]
        st = s.pending
        if st is None:
            raise ValueError(errors.msg("continue_without_begin",
                                        slot=slot))
        req = st.req
        P = len(req.tokens)
        budget = P - st.consumed if budget is None else max(1, int(budget))
        nxt = None
        if st.local is None:           # first chunk: prefix prefill
            L0 = self._first_chunk_len(min(budget, P), P)
            toks = np.zeros((1, self._bucket(L0)), np.int32)
            toks[0, :L0] = req.tokens[:L0]
            t0 = time.perf_counter()
            nxt, st.local = self._prefill(
                toks, [L0],
                req.frames if self.contract == "encdec" else None, slot)
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats[f"prefill_b{self._stat_bucket(L0)}"] += 1
            st.consumed = L0
            budget -= L0
            if st.prefix_cache is not None and self.contract == "recurrent" \
                    and L0 >= st.prefix_cache.min_hit:
                # the chunk's state under its exact token prefix: the
                # whole-entry snapshot a later prompt extending it reuses;
                # a copy, since the walk below advances st.local in place
                st.prefix_cache.insert(req.tokens[:L0], _private(st.local),
                                       cache_bytes(st.local))
        while budget > 0 and st.consumed < P:
            t = int(req.tokens[st.consumed])
            t0 = time.perf_counter()
            nxt = self._decode([[t]], st.local)
            self.stats["walk_s"] += time.perf_counter() - t0
            self.stats["walk_steps"] += 1
            st.consumed += 1
            budget -= 1
        if st.consumed < P:
            self.stats["chunk_steps"] += 1
            return False
        st.first = int(nxt[0])
        self._install(slot, st)
        return True

    def _install(self, slot: int, st: _Prefill):
        """Prefill complete: insert the local cache into the prefix cache
        (it is the admit's own tree, which nothing writes after the slot
        copy below), write it into the slot lane and make the slot
        decode-eligible with its first generated token."""
        if st.prefix_cache is not None:
            st.prefix_cache.insert(st.req.tokens, st.local,
                                   cache_bytes(st.local))
        s = self.slots[slot]
        now = self._now()
        s.out = [st.first]
        s.remaining = st.req.gen - 1
        s.t_admit = s.t_first = now
        self.tokens[slot] = st.first
        self._write_slot(st.local, slot)
        s.pending = None

    def admit(self, req: Request, slot: int, prefix_cache=None):
        """Prefill ``req`` and install it into ``slot`` — the atomic
        composition of ``begin_admit`` + ``continue_admit`` with an
        unbounded budget. With a ``prefix_cache`` on a prefix-eligible
        stack a prompt sharing a cached prefix skips recomputing it; the
        full prefill result is inserted back into the cache either way."""
        self.begin_admit(req, slot, prefix_cache=prefix_cache)
        self.continue_admit(slot)

    def decode_step(self):
        """One shared decode step over every slot; returns retired slots."""
        t0 = time.perf_counter()
        if self.sharding is not None:
            nxt = self._post("decode", payload=self.tokens)
        else:
            nxt = self._decode(self.tokens[:, None], self.slotcache.cache)
        self.stats["decode_s"] += time.perf_counter() - t0
        active = self.decoding_count()
        self.stats["decode_steps"] += 1
        self.stats["decode_lanes"] += active
        self.stats["max_concurrent"] = max(self.stats["max_concurrent"],
                                           active)
        retired = []
        for i, s in enumerate(self.slots):
            # PREFILLING and free slots computed a discarded lane
            if s.free or s.pending is not None:
                continue
            s.out.append(int(nxt[i]))
            self.tokens[i] = nxt[i]
            s.remaining -= 1
            if s.remaining == 0:
                retired.append(i)
        return retired

    def retire(self, slot: int) -> Completion:
        """Free ``slot`` and return its finished request's Completion.
        The slot is immediately refillable (the next admit overwrites it);
        under the recurrent contract its state lanes are reset to zeros."""
        s = self.slots[slot]
        comp = Completion(
            rid=s.rid, tokens=np.asarray(s.out, np.int32),
            prompt_len=len(s.req.tokens), arrival=s.req.arrival,
            t_admit=s.t_admit, t_first=s.t_first, t_done=self._now())
        s.rid, s.req, s.remaining, s.pending = -1, None, 0, None
        if self.contract == "recurrent":
            self._reset_slot(slot)
        return comp

    def cancel(self, slot: int) -> List[int]:
        """Drop ``slot``'s request mid-generation and return the partial
        tokens produced so far. The slot is refillable on the next admit;
        its stale cache lanes are inert (masked by ``pos``, or reset under
        the recurrent contract) until overwritten. Cancelling a PREFILLING
        slot discards the partial prefill (never installed): zero tokens
        kept."""
        s = self.slots[slot]
        if s.free:
            raise ValueError(errors.msg("cancel_free_slot", slot=slot))
        partial = list(s.out)
        s.rid, s.req, s.remaining, s.pending = -1, None, 0, None
        if self.contract == "recurrent":
            self._reset_slot(slot)
        self.stats["cancels"] += 1
        return partial

    # -- serving loop -------------------------------------------------------

    def run(self, requests: List[Request], *, log=None,
            prefill_chunk: Optional[int] = None) -> List[Completion]:
        """Serve a trace to completion; returns completions in rid order.

        ``prefill_chunk`` hands the interleaving to a scheduler with that
        per-iteration token budget (serve/scheduler.py): cold admits
        prefill at most that many prompt tokens per engine iteration, so
        occupied slots take a decode step between chunks. Streams are
        byte-identical either way.
        """
        from repro_torch.serve.scheduler import Scheduler
        sched = Scheduler(self, prefill_chunk=prefill_chunk)
        queue = collections.deque(
            sorted(requests, key=lambda r: (r.arrival, r.rid)))
        done: dict = {}
        self.begin()
        while queue or self.active_count():
            now = self._now()
            for slot in sched.advance():   # resume in-flight chunked admits
                if self.slots[slot].remaining == 0:
                    comp = self.retire(slot)
                    done[comp.rid] = comp  # gen==1: prefill token only
            free = self.free_slots()
            while queue and queue[0].arrival <= now and free:
                slot = free[0]
                started = sched.start(queue.popleft(), slot)
                if started and self.slots[slot].remaining == 0:
                    comp = self.retire(slot)
                    done[comp.rid] = comp  # gen==1: prefill token only
                else:
                    free.pop(0)
            if not sched.should_decode():
                if not self.active_count() and queue:
                    # idle until the next arrival
                    time.sleep(max(0.0, min(queue[0].arrival - self._now(),
                                            1e-3)))
                continue
            for slot in self.decode_step():
                s = self.slots[slot]
                if log:
                    log(f"[serve] rid={s.rid} done "
                        f"({len(s.out)} tok, slot {slot})")
                comp = self.retire(slot)
                done[comp.rid] = comp
        return [done[r.rid] for r in sorted(requests, key=lambda r: r.rid)]

    def warmup(self, prompt_lens=(8,), gen: int = 2, prefix: bool = False,
               prefill_chunk: Optional[int] = None):
        """Run one short request per prompt bucket the trace will use (and
        the decode step) outside any timed region — the kernels' build,
        cuBLAS handles and the allocator's first blocks — then reset the
        engine. ``prefix=True`` also runs the prefix-hit path's batch-1
        suffix walk once, over an empty cache (counted in ``walk_steps``);
        ``prefill_chunk`` warms the chunked path instead.
        Exact-length (recurrent) prefills warm one prompt per bucket of the
        table, not per length: eager PyTorch builds nothing per shape.
        Returns the warmup run's stats."""
        if prefix and self.sharding is not None:
            raise NotImplementedError(_SHARDED_PREFIX)
        if prefix and not self.prefix_eligible():
            raise ValueError(errors.msg("prefix_ineligible",
                                        name=self.cfg.name))
        if prefix:
            local = self._cache_template(1, self.device)
            if self.contract != "recurrent":
                from repro_torch.models.lm import override_cache_pos
                local = override_cache_pos(local, torch.zeros(
                    (1,), dtype=torch.int32, device=self.device))
            self._decode([[0]], local)
            self.stats["walk_steps"] += 1
        key = self._bucket if self.ragged_ok else self._stat_bucket
        reqs = []
        for i, b in enumerate(sorted({key(p) for p in prompt_lens})):
            # a bucket-sized prompt can overflow the per-slot budget
            # (b == max_len); shrink it — it rounds back up to the bucket
            p = max(1, min(b, self.max_len - gen))
            frames = None
            if self.contract == "encdec":
                frames = np.zeros((self.mem_len, self.cfg.d_model),
                                  np.float32)
            reqs.append(Request(rid=-(i + 1),
                                tokens=np.zeros((p,), np.int32), gen=gen,
                                frames=frames))
        self.run(reqs, prefill_chunk=prefill_chunk)
        stats = dict(self.stats)
        self.reset()
        return stats

    def reset(self):
        if self.sharding is not None:
            self._post("reset")
        else:
            self.slotcache.reset()
        self.tokens[:] = 0
        self.slots = [_Slot() for _ in range(self.n_slots)]
        self.stats = collections.Counter()

    @property
    def cache_bytes(self) -> int:
        return self.slotcache.bytes

    @property
    def device_cache_bytes(self) -> int:
        """The largest per-device slot-cache footprint: ``cache_bytes``
        unsharded, the largest rank's under a ``sharding``."""
        return self.slotcache.device_bytes


# ---------------------------------------------------------------------------
# static fixed-batch baseline (the pre-engine serve loop, trace-shaped)
# ---------------------------------------------------------------------------

def run_static_trace(model, params, requests: List[Request], *,
                     n_slots: int, max_len: int,
                     buckets=None) -> List[Completion]:
    """Serve the trace in fixed batches of ``n_slots``: each batch pads every
    prompt to the longest and decodes until the *longest* generation in the
    batch finishes — the batch barrier continuous batching removes."""
    cfg = model.cfg
    if set(cfg.layer_kinds) != {"attn"}:
        raise ValueError(errors.msg("static_trace_ineligible"))
    buckets = sorted(buckets) if buckets else default_buckets(max_len)
    vocab = cfg.vocab_size
    device = next(iter(flatten(params).values())).device

    def as_tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    def argmax(logits):
        return logits[:, -1, :vocab].argmax(-1).to(torch.int32)

    def prefill(toks, lens):
        logits, cache = model.prefill(params, {"tokens": as_tensor(toks)},
                                      max_len, lengths=as_tensor(lens))
        return argmax(logits), cache

    def decode(tok, cache):
        return argmax(model.decode_step(params, tok[:, None], cache)[0])

    order = sorted(requests, key=lambda r: (r.arrival, r.rid))
    groups = [order[i:i + n_slots] for i in range(0, len(order), n_slots)]

    def bucket_of(group):
        Lmax = max(len(r.tokens) for r in group)
        return next((b for b in buckets if b >= Lmax), Lmax)

    # warm every prefill bucket this trace will use (and the decode step)
    # outside the timed region, matching the engine's warmup
    for L in sorted({bucket_of(g) for g in groups}):
        tok, cache = prefill(np.zeros((n_slots, L), np.int32),
                             np.ones((n_slots,), np.int32))
        decode(tok, cache)

    done = []
    t0 = time.perf_counter()
    for group in groups:
        while time.perf_counter() - t0 < max(r.arrival for r in group):
            time.sleep(1e-4)               # batch can't start early
        B = n_slots
        L = bucket_of(group)
        toks = np.zeros((B, L), np.int32)
        lens = np.ones((B,), np.int32)
        for j, r in enumerate(group):
            toks[j, :len(r.tokens)] = r.tokens
            lens[j] = len(r.tokens)
        tok, cache = prefill(toks, lens)
        steps = [tok]
        for _ in range(max(r.gen for r in group) - 1):
            tok = decode(tok, cache)
            steps.append(tok)
        outs = torch.stack(steps, 1).cpu().numpy()
        t_done = time.perf_counter() - t0
        for j, r in enumerate(group):      # everyone waits for the batch
            done.append(Completion(
                rid=r.rid, tokens=outs[j, :r.gen].astype(np.int32),
                prompt_len=len(r.tokens), arrival=r.arrival,
                t_admit=t_done, t_first=t_done, t_done=t_done))
    return sorted(done, key=lambda c: c.rid)


# ---------------------------------------------------------------------------
# synthetic ragged traces + reporting
# ---------------------------------------------------------------------------

def _substream(seed: int, salt: int) -> np.random.RandomState:
    """Independent RNG stream per trace field (seed determinism contract)."""
    return np.random.RandomState((seed * 0x9E3779B1 + salt) & 0xFFFFFFFF)


def synthetic_trace(n: int, vocab: int, *, seed: int = 0,
                    prompt_range=(8, 48), gen_range=(4, 48),
                    rate: Optional[float] = None,
                    deadline_range=None, deadline_frac: float = 1.0,
                    prefix_len: int = 0, mem_len: Optional[int] = None,
                    d_model: int = 0) -> List[Request]:
    """Ragged arrival trace: mixed prompt/gen lengths, optional Poisson
    arrivals at ``rate`` req/s (default: all available at t=0).
    ``mem_len`` (with ``d_model``) attaches per-request encoder-memory
    frames of that fixed length: the enc-dec workload
    (``ServeEngine(mem_len=...)``).

    ``deadline_range=(lo, hi)`` gives a ``deadline_frac`` fraction of
    requests an absolute deadline ``arrival + U(lo, hi)`` seconds (the rest
    run without one: the deadline mix). ``prefix_len > 0`` prepends one
    shared system prompt of that many tokens to every request
    (``prompt_range`` then sizes the per-request suffix): the prefix-cache
    workload.

    Every field draws from its own seed-derived substream, exactly as
    ``repro.serve.engine.synthetic_trace`` does (the shared prefix from the
    token stream before any request's tokens, deadlines from their own
    stream), so the same seed gives the same requests, deadlines and
    frames in both packages, and a trace without ``prefix_len`` or
    deadlines is the one earlier versions drew.
    """
    rng_arr = _substream(seed, 1)
    rng_len = _substream(seed, 2)
    rng_tok = _substream(seed, 3)
    rng_dl = _substream(seed, 4)
    rng_fr = _substream(seed, 5)
    if mem_len is not None and d_model <= 0:
        raise ValueError("synthetic_trace: mem_len= needs d_model=")
    arrivals = np.zeros(n) if rate is None else \
        np.cumsum(rng_arr.exponential(1.0 / rate, size=n))
    shared = rng_tok.randint(0, vocab, size=prefix_len).astype(np.int32) \
        if prefix_len else None
    reqs = []
    for i in range(n):
        P = int(rng_len.randint(prompt_range[0], prompt_range[1] + 1))
        G = int(rng_len.randint(gen_range[0], gen_range[1] + 1))
        toks = rng_tok.randint(0, vocab, size=P).astype(np.int32)
        if shared is not None:
            toks = np.concatenate([shared, toks])
        deadline = None
        if deadline_range is not None:
            budget = float(rng_dl.uniform(*deadline_range))
            if rng_dl.uniform() < deadline_frac:
                deadline = float(arrivals[i]) + budget
        frames = None
        if mem_len is not None:
            frames = rng_fr.randn(mem_len, d_model).astype(np.float32)
        reqs.append(Request(rid=i, tokens=toks, gen=G,
                            arrival=float(arrivals[i]), deadline=deadline,
                            frames=frames))
    return reqs


def percentile_table(completions: List[Completion], wall: float) -> dict:
    """p50/p99 latency + aggregate throughput over a served trace."""
    lat = np.asarray([c.latency for c in completions])
    ttft = np.asarray([c.ttft for c in completions])
    total = int(sum(len(c.tokens) for c in completions))
    return {
        "requests": len(completions),
        "tokens": total,
        "wall_s": wall,
        "tok_per_s": total / max(wall, 1e-9),
        "lat_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "lat_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
        "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
    }


def format_table(rows: List[dict], keys=None) -> str:
    """Markdown table from a list of same-keyed dicts."""
    keys = keys or list(rows[0])

    def fmt(v):
        return f"{v:.1f}" if isinstance(v, float) else str(v)
    out = ["| " + " | ".join(keys) + " |",
           "|" + "---|" * len(keys)]
    for r in rows:
        out.append("| " + " | ".join(fmt(r.get(k, "-")) for k in keys)
                   + " |")
    return "\n".join(out)
