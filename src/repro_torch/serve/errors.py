"""Single source of truth for serving-stack rejection messages.

Every ``ValueError`` the serving tier raises on a *refused configuration or
request* formats its message from this table. Tests that assert on refusal
wording (the ``test_serve_zoo`` xfail matrix, ``pytest.raises(match=...)``
checks) build their expectations from the same entries, so the engine and
the tests cannot drift apart: renaming a message here updates both sides,
and ``tests/test_serve_errors.py`` fails if any test file re-inlines a
message as a string literal.

Keys name the *refusal*, not the call site — several call sites share one
entry (e.g. the engine's warmup and the front-end both refuse an ineligible
prefix cache with ``prefix_ineligible``).
"""
from __future__ import annotations

ERRORS = {
    # engine construction / admission
    "no_serving_path":
        "{name}: family {family!r} has no serving path",
    "encdec_needs_mem_len":
        "encdec serving needs mem_len= (fixed encoder memory length)",
    "prompt_exceeds_bucket":
        "prompt length {n} exceeds largest bucket {bucket}",
    "request_exceeds_max_len":
        "request {rid}: prompt {prompt} + gen {gen} exceeds max_len "
        "{max_len}",
    "frames_mem_len_mismatch":
        "request {rid}: frames length {frames} != mem_len {mem_len}",
    "cancel_free_slot":
        "cancel on free slot {slot}",
    # prefix reuse: sound only under a replayable slot-cache contract
    # (docs/serving.md "Slot-cache contracts")
    "prefix_ineligible":
        "{name}: prefix cache needs a replayable slot-cache contract "
        "(pure global-attention KV rewind, or whole-prefix recurrent "
        "state snapshots); serve without one",
    "static_trace_ineligible":
        "static ragged baseline needs a pure global-attention stack "
        "(batched ragged prefill)",
    # mesh-sharded serving: every payload leaf of the slot cache must
    # split evenly over the model axis (never padded — docs/serving.md
    # "Mesh-sharded serving")
    "shard_ineligible":
        "{name}: slot-cache leaf {leaf!r} has no model-axis dim divisible "
        "by the {m}-way model axis; serve unsharded or re-mesh",
    # scheduler: chunked-prefill policy (serve/scheduler.py)
    "chunk_invalid":
        "prefill chunk must be a positive token budget, got {chunk}",
    "chunk_unsupported":
        "{name}: chunked prefill needs the non-atomic begin_admit/"
        "continue_admit slot surface; serve with prefill_chunk=None",
    "continue_without_begin":
        "continue_admit on slot {slot}: no admit in progress "
        "(begin_admit first)",
    # fleet routing
    "router_needs_engines":
        "ReplicaRouter needs at least one engine",
    "unknown_route":
        "unknown route {route!r}; known: {routes}",
    "affinity_ineligible":
        "{name}: prefix-affinity routing needs a replayable slot-cache "
        "contract (pure global-attention KV rewind, or whole-prefix "
        "recurrent state snapshots); route least-loaded instead",
}


def msg(key: str, **kw) -> str:
    """Format the rejection message for ``key`` (raises KeyError on an
    unknown key and on a stale placeholder, so call sites can't silently
    diverge from the table)."""
    return ERRORS[key].format(**kw)
