"""Preallocated per-slot KV cache for the continuous-batching engine
(``repro.serve.cache``).

The engine runs ONE shared decode step over all ``n_slots`` slots; a
request occupies a slot for its lifetime, and admitting a new request only
overwrites that slot's rows — no reshape, no reallocation.

The global cache is the model's own decode-cache tree with the batch axis
widened to ``n_slots``. The batch axis is not uniformly the leading axis:
scanned-segment leaves are stacked ``(reps, B, max_len, ...)``, so the
per-leaf slot axis is inferred by comparing the cache's shapes at batch 1
and 2 (built on the ``meta`` device: no memory). Slot writes copy a batch-1
prefill cache into the slot in place along that axis.

Per-slot validity lives in the cache itself: every layer cache carries a
``pos`` (B,) valid-length which the decode attention turns into its key
mask (``key_idx <= pos``). Free slots keep decoding into discarded lanes;
their ``pos`` may walk past ``max_len``, where the decode scatter drops the
out-of-bounds row (as JAX does), so stale slots are inert until the next
admit overwrites them.

Under the ``recurrent`` contract (rwkv, and any stack with a Mamba layer)
a slot holds a fixed-size state instead (``RecurrentSlotCache``): there is
no mask to hide a stale lane behind, so retire resets it. A hybrid
(jamba) holds its attention layers' K/V rows and ``pos`` beside the
states.

Under the ``encdec`` contract (seamless) a ``SlotCache`` slot holds the
decoder's self-attention K/V rows up to ``max_len`` with their ``pos``,
and the memory K/V (``dec/cross/k_mem``, ``v_mem``) of ``mem_len`` rows
that the admit's prefill computed from the request's frames; every
memory row is valid, and a stale slot is inert under its ``pos`` mask as
under ``kv``.

With a ``sharding`` (``serve.sharding.ServeSharding``) a rank holds its
block of every leaf by ``slot_specs`` (``specs``): its data index' slots
when the slot dim divides the data axis, its share of the payload dim of
the model axis. A rank's prefill caches are its blocks of the batch-1
template (``local_specs``, data-replicated), which ``write_slot`` copies
into the rank's lane of a slot it owns. The blocks are allocated at their
own shapes (from the rank's block of one empty slot, cut on the host), so
the whole cache is never built. ``bytes`` and ``slot_bytes`` count
the whole cache; ``device_bytes`` is the largest rank's, measured from the
ranks' own tensors.
"""
from __future__ import annotations

import torch

from repro_torch.interop import flatten, map_tree

RECURRENT_KINDS = frozenset({"mamba", "rwkv"})


def cache_contract(cfg) -> str:
    """Classify a config's slot-cache contract (``repro.serve.cache``):
    ``"kv"`` (per-token KV rows up to ``max_len``, freed slots inert under
    the ``pos`` mask), ``"recurrent"`` (fixed-size state that retire must
    reset) or ``"encdec"`` (decoder KV plus a fixed cross-attn memory)."""
    if cfg.family == "encdec":
        return "encdec"
    if set(cfg.layer_kinds) & RECURRENT_KINDS:
        return "recurrent"
    return "kv"


def _infer_batch_axes(tree1, tree2):
    """Per-leaf batch axis: the first dim that differs between the two
    trees (built at batch 1 and batch 2)."""
    def axis_of(a, b):
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return i
        raise ValueError(f"no batch axis found in cache leaf "
                         f"{tuple(a.shape)}")
    return {k: _infer_batch_axes(v, tree2[k]) if isinstance(v, dict)
            else axis_of(v, tree2[k]) for k, v in tree1.items()}


def _fill(blank, blocks):
    """Each leaf of ``blank`` (one slot) repeated along its slot axis to
    the shape of ``blocks``' leaf (``meta`` tensors), in new tensors (a
    copy also where a rank holds one slot)."""
    return {k: _fill(v, blocks[k]) if isinstance(v, dict)
            else v.expand(blocks[k].shape).clone(
                memory_format=torch.contiguous_format)
            for k, v in blank.items()}


def cache_bytes(tree) -> int:
    """Total bytes held by a cache tree."""
    return int(sum(t.numel() * t.element_size()
                   for t in flatten(tree).values()))


class SlotCache:
    """n_slots-wide preallocated decode cache with per-slot writes.

    ``template_fn(batch, device)`` returns the decode-cache tree at that
    batch size (time axis ``max_len``), zero-filled. ``sharding``: hold
    this rank's blocks (module docstring); ``name`` is the config's, for
    ``slot_specs``' refusal.
    """

    def __init__(self, template_fn, n_slots: int, *, device, sharding=None,
                 name: str = "slot-cache"):
        meta = torch.device("meta")
        one = template_fn(1, meta)
        self.batch_axes = flatten(_infer_batch_axes(one,
                                                    template_fn(2, meta)))
        self.n_slots = n_slots
        self._meta, self._meta1 = template_fn(n_slots, meta), one
        self.sharding = sharding
        self.specs = self.local_specs = None
        self.slot_split, self.data_index = False, 0
        if sharding is None:
            self.cache = template_fn(n_slots, device)
            return
        from repro_torch.serve.sharding import slot_specs
        kw = dict(data_axis=sharding.data_axis,
                  model_axis=sharding.model_axis, name=name)
        self.specs = slot_specs(self._meta, self.batch_axes, sharding, **kw)
        self.local_specs = slot_specs(one, self.batch_axes, sharding, **kw)
        self.slot_split = sharding.data_size > 1 \
            and n_slots % sharding.data_size == 0
        self.data_index = sharding.data_index
        # the rank's blocks of one empty slot, cut on the host; each cache
        # leaf is allocated at its block's shape and filled from that slot
        # along its slot axis, so only the rank's blocks reach the device
        self._blank = map_tree(lambda t: t.to(device), sharding.block(
            template_fn(1, torch.device("cpu")), self.local_specs))
        self.cache = _fill(self._blank, sharding.block(self._meta,
                                                       self.specs))
        self.rank_bytes = sharding.gather_all(cache_bytes(self.cache))

    def owner(self, slot: int) -> int:
        """The data index whose ranks hold ``slot`` (0 when every data
        index holds every slot)."""
        return slot // (self.n_slots // self.sharding.data_size) \
            if self.slot_split else 0

    def owns(self, slot: int) -> bool:
        """Whether this rank holds ``slot``'s lane."""
        return not self.slot_split or self.owner(slot) == self.data_index

    def slot_range(self):
        """The slots [lo, hi) whose lanes this rank holds."""
        if not self.slot_split:
            return 0, self.n_slots
        per = self.n_slots // self.sharding.data_size
        return self.data_index * per, (self.data_index + 1) * per

    def reset(self):
        """Drop all slot contents (e.g. after warmup), in place."""
        for t in flatten(self.cache).values():
            t.zero_()

    def write_slot(self, local_cache, slot: int):
        """Admit: copy a batch-1 prefill cache (this rank's block of it,
        when sharded) into slot ``slot`` (a slot this rank holds)."""
        lane = slot - self.slot_range()[0]
        dst = flatten(self.cache)
        for path, src in flatten(local_cache).items():
            ax = self.batch_axes[path]
            dst[path].select(ax, lane).copy_(src.select(ax, 0))

    @property
    def bytes(self) -> int:
        """Bytes of the whole cache (over every rank when sharded)."""
        return cache_bytes(self._meta)

    @property
    def device_bytes(self) -> int:
        """The largest rank's bytes of the cache (``bytes`` unsharded), as
        the ranks' own tensors hold them."""
        if self.sharding is None:
            return cache_bytes(self.cache)
        return max(self.rank_bytes)

    @property
    def slot_bytes(self) -> int:
        """Bytes one slot occupies (the per-request cache cost)."""
        return self.bytes // self.n_slots

    @property
    def slot_parts(self) -> dict:
        """Bytes one slot occupies, split into ``self`` (the decoder's
        K/V rows and positions) and ``memory`` (an enc-dec's memory K/V,
        ``dec/cross``; 0 for any other contract)."""
        parts = {"self": 0, "memory": 0}
        for path, t in flatten(self._meta).items():
            kind = "memory" if path.startswith("dec/cross/") else "self"
            parts[kind] += t.numel() * t.element_size() // self.n_slots
        return parts


# leaves of an attention layer's cache (its K/V rows or latents, and the
# positions that mask them); every other leaf is a recurrent state
_KV_LEAVES = frozenset({"k", "v", "ckv", "k_rope", "pos", "abs_pos"})


class RecurrentSlotCache(SlotCache):
    """Slot cache for the *recurrent* contract: each slot holds a fixed-size
    recurrent state (wkv6 and token-shift rows, or Mamba's conv rows and
    SSM state) instead of growing KV rows. A pure recurrent stack's
    ``slot_bytes`` is constant in ``max_len``; a hybrid's attention layers
    (jamba) add K/V rows that grow with it (``slot_parts`` splits the two).

    Admit and decode are those of ``SlotCache`` (the admit copy replaces the
    whole lane: a state has no time axis, and the K/V rows of an
    exact-length prefill are padded to ``max_len``). Retire differs: a
    state is a lossy summary of the whole history with no mask to hide
    behind, so ``reset_slot`` writes the empty-history batch-1 cache back
    into the lane, in place: zero states, and the attention lanes inert
    (``pos`` 0, zero K/V).
    """

    def __init__(self, template_fn, n_slots: int, *, device, sharding=None,
                 name: str = "slot-cache"):
        super().__init__(template_fn, n_slots, device=device,
                         sharding=sharding, name=name)
        if sharding is None:
            self._blank = template_fn(1, device)

    def reset_slot(self, slot: int):
        """Retire/cancel: return ``slot``'s lane to the empty-history
        state."""
        self.write_slot(self._blank, slot)

    @property
    def slot_parts(self) -> dict:
        """Bytes one slot occupies, split into ``state`` (the recurrent
        states, constant in ``max_len``) and ``kv`` (attention K/V rows
        and positions, with the top-level ``pos``)."""
        parts = {"state": 0, "kv": 0}
        for path, t in flatten(self._meta1).items():
            kind = "kv" if path.rsplit("/", 1)[-1] in _KV_LEAVES \
                else "state"
            parts[kind] += t.numel() * t.element_size()
        return parts
