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

Besides the JAX engine's counters, ``stats`` sums the host-clock seconds
of shared decode steps (``decode_s``) and of first-chunk prefills
(``prefill_s``); both end in a device-to-host copy of the next tokens, so
they include the device work. ``walk_steps`` counts the batch-1 decode
steps that consume prompt tokens after the first chunk.

Not ported yet: mesh sharding (``sharding=``) and the prefix cache
(``prefix_cache=``); they raise.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.interop import flatten
from repro_torch.serve import errors
from repro_torch.serve.cache import (RecurrentSlotCache, SlotCache,
                                     cache_contract)


def _no_prefix_cache(prefix_cache):
    if prefix_cache is not None:
        raise NotImplementedError("the prefix cache is not ported; see "
                                  "repro/serve/prefix.py")


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (P,) int32 prompt tokens
    gen: int                      # tokens to generate (>= 1)
    arrival: float = 0.0          # seconds relative to trace start
    frames: Optional[np.ndarray] = None   # (S, D) enc-dec memory frames


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
    """

    def __init__(self, model, params, *, n_slots: int, max_len: int,
                 buckets=None, mem_len: Optional[int] = None,
                 sharding=None):
        cfg = model.cfg
        if model.prefill is None or model.decode_step is None:
            raise ValueError(errors.msg("no_serving_path", name=cfg.name,
                                        family=cfg.family))
        if sharding is not None:
            raise NotImplementedError("mesh-sharded serving is not ported; "
                                      "see repro/serve/sharding.py")
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
                                   device=self.device)
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
        return logits[:, -1, : self.cfg.vocab_size].argmax(-1) \
            .to(torch.int32)

    def _tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)) \
            .to(self.device)

    def _prefill(self, tokens, lengths, frames=None):
        """One prefill; ``frames`` (S, D): an enc-dec request's memory."""
        batch = {"tokens": self._tensor(tokens)}
        if frames is not None:
            batch["frames"] = torch.from_numpy(
                np.asarray(frames, np.float32))[None].to(self.device)
        logits, cache = self.model.prefill(
            self.params, batch, self.max_len,
            lengths=self._tensor(lengths) if self.ragged_ok else None)
        return self._argmax(logits).cpu().numpy(), cache

    def _decode(self, tokens, cache):
        """One decode step over ``cache`` (updated in place)."""
        logits, _ = self.model.decode_step(self.params, self._tensor(tokens),
                                           cache)
        return self._argmax(logits).cpu().numpy()

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
        """Anchor the engine clock (``run``/``warmup`` call this)."""
        self._t0 = time.perf_counter() if t0 is None else t0

    def begin_admit(self, req: Request, slot: int, prefix_cache=None):
        """Bind ``req`` to ``slot`` without running any prefill work: the
        slot is PREFILLING — occupied (``free`` is False) but skipping
        decode lanes until ``continue_admit`` consumes the whole prompt."""
        _no_prefix_cache(prefix_cache)
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
        s = self.slots[slot]
        if s.out:                      # slot previously served a request
            self.stats["refills"] += 1
        s.rid, s.req, s.out = req.rid, req, []
        s.remaining = req.gen
        s.pending = _Prefill(req=req)
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
                req.frames if self.contract == "encdec" else None)
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats[f"prefill_b{self._stat_bucket(L0)}"] += 1
            st.consumed = L0
            budget -= L0
        while budget > 0 and st.consumed < P:
            t = int(req.tokens[st.consumed])
            nxt = self._decode([[t]], st.local)
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
        """Prefill complete: write the local cache into the slot lane and
        make the slot decode-eligible with its first generated token."""
        s = self.slots[slot]
        now = self._now()
        s.out = [st.first]
        s.remaining = st.req.gen - 1
        s.t_admit = s.t_first = now
        self.tokens[slot] = st.first
        self.slotcache.write_slot(st.local, slot)
        s.pending = None

    def admit(self, req: Request, slot: int, prefix_cache=None):
        """Prefill ``req`` and install it into ``slot`` — the atomic
        composition of ``begin_admit`` + ``continue_admit`` with an
        unbounded budget."""
        self.begin_admit(req, slot, prefix_cache=prefix_cache)
        self.continue_admit(slot)

    def decode_step(self):
        """One shared decode step over every slot; returns retired slots."""
        t0 = time.perf_counter()
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
            self.slotcache.reset_slot(slot)
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
            self.slotcache.reset_slot(slot)
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

    def warmup(self, prompt_lens=(8,), gen: int = 2,
               prefill_chunk: Optional[int] = None):
        """Run one short request per prompt bucket the trace will use (and
        the decode step) outside any timed region — the kernels' build,
        cuBLAS handles and the allocator's first blocks — then reset the
        engine. ``prefill_chunk`` warms the chunked path instead.
        Exact-length (recurrent) prefills warm one prompt per bucket of the
        table, not per length: eager PyTorch builds nothing per shape.
        Returns the warmup run's stats."""
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
        self.slotcache.reset()
        self.tokens[:] = 0
        self.slots = [_Slot() for _ in range(self.n_slots)]
        self.stats = collections.Counter()

    @property
    def cache_bytes(self) -> int:
        return self.slotcache.bytes


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
                    mem_len: Optional[int] = None,
                    d_model: int = 0) -> List[Request]:
    """Ragged arrival trace: mixed prompt/gen lengths, optional Poisson
    arrivals at ``rate`` req/s (default: all available at t=0).
    ``mem_len`` (with ``d_model``) attaches per-request encoder-memory
    frames of that fixed length: the enc-dec workload
    (``ServeEngine(mem_len=...)``).

    Every field draws from its own seed-derived substream, exactly as
    ``repro.serve.engine.synthetic_trace`` does, so the same seed gives the
    same requests and frames in both packages. (Deadlines and shared
    prefixes, the JAX trace's other fields, serve layers not ported yet.)
    """
    rng_arr = _substream(seed, 1)
    rng_len = _substream(seed, 2)
    rng_tok = _substream(seed, 3)
    rng_fr = _substream(seed, 5)
    if mem_len is not None and d_model <= 0:
        raise ValueError("synthetic_trace: mem_len= needs d_model=")
    arrivals = np.zeros(n) if rate is None else \
        np.cumsum(rng_arr.exponential(1.0 / rate, size=n))
    reqs = []
    for i in range(n):
        P = int(rng_len.randint(prompt_range[0], prompt_range[1] + 1))
        G = int(rng_len.randint(gen_range[0], gen_range[1] + 1))
        toks = rng_tok.randint(0, vocab, size=P).astype(np.int32)
        frames = None
        if mem_len is not None:
            frames = rng_fr.randn(mem_len, d_model).astype(np.float32)
        reqs.append(Request(rid=i, tokens=toks, gen=G,
                            arrival=float(arrivals[i]), frames=frames))
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
