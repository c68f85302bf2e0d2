"""Decoder-only language model (``repro.models.lm``): forward, prefill and
one-token decode, for attention stacks, RWKV-6 stacks and Mamba hybrids.

Depth follows ``cfg.layout()`` exactly as the JAX package lays out its
params: a scanned segment stores its layers stacked under ``seg<i>/p<j>``
with the repetition axis first, unrolled layers sit under ``seg<i>/l<j>``.
So ``interop.from_numpy`` carries JAX params across unchanged. Where JAX
scans, the port loops over the stacked axis (views, no copies). The decode
cache has the same tree as JAX's: a top-level ``pos`` (B,) and per layer
either ``k``, ``v``, ``pos`` (attention) or the recurrent state
``{"time": {"shift", "wkv"}, "channel": {"shift"}}`` (rwkv, no per-layer
``pos``) or ``{"conv", "ssm"}`` (mamba: the last d_conv - 1 inputs of
the causal conv and the (di, d_state) fp32 SSM state, no ``pos``) or
MLA's latent ``ckv``, ``k_rope``, ``pos``, scanned leaves stacked (reps,
B, ...); every ``pos`` is int32. ``lm_decode_step`` updates the cache in
place (new K/V rows, or the wkv, SSM, conv and shift rows overwritten).

A ``swa`` layer's decode cache is a ring of ``min(max_len,
sliding_window)`` slots with ``abs_pos`` (``_window_cache``); an empty
cache holds ``abs_pos`` -1 in every layer, stacked or not.

The VLM stub frontend (``frontend="patch_stub"``, internvl2-26b) passes
precomputed ``patch_embeds`` (B, P, D), which ``apply_lm`` and
``lm_prefill`` put before the token embeddings; positions then run over
P + T. Blocks take a dense or a routed-MoE MLP (``blocks.ffn``).

Not ported yet: ``lm_loss``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.interop import map_tree
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (apply_norm, dtype_of, embed_init,
                                       init_norm, init_stacked, layer_slice,
                                       stack_layers)


def _seg_name(si: int) -> str:
    return f"seg{si}"


def _each_layer(cfg):
    """(segment, position key, repetition or None, kind, is_moe) of every
    layer in depth order."""
    for si, seg in enumerate(cfg.layout()):
        name = _seg_name(si)
        if seg[0] == "unroll":
            for j, li in enumerate(seg[1]):
                yield (name, f"l{j}", None) + cfg.layer_spec(li)
        else:
            _, reps, idxs = seg
            for r in range(reps):
                for j, li in enumerate(idxs):
                    yield (name, f"p{j}", r) + cfg.layer_spec(li)


def _at(tree, name, key, rep):
    sub = tree[name][key]
    return sub if rep is None else layer_slice(sub, rep)


def _head(params):
    head = params.get("head")
    return params["embed"].T if head is None else head


def init_lm(gen: torch.Generator, cfg):
    """Parameters on the CPU, drawn from ``gen``."""
    dt = dtype_of(cfg)
    params = {"embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt),
              "final_norm": init_norm(cfg)}
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, (cfg.d_model, cfg.padded_vocab), dt)
    for si, seg in enumerate(cfg.layout()):
        if seg[0] == "unroll":
            # a MoE config's dense layers (first_k_dense) take dense_d_ff
            params[_seg_name(si)] = {
                f"l{j}": blk.init_block(
                    gen, cfg, *cfg.layer_spec(li),
                    dense_ff=cfg.eff_dense_d_ff
                    if cfg.moe is not None and not cfg.layer_is_moe(li)
                    else None)
                for j, li in enumerate(seg[1])}
        else:
            _, reps, idxs = seg
            params[_seg_name(si)] = {
                f"p{j}": init_stacked(
                    lambda li=li: blk.init_block(gen, cfg,
                                                 *cfg.layer_spec(li)), reps)
                for j, li in enumerate(idxs)}
    return params


def _positions(B: int, T: int, device):
    return torch.arange(T, dtype=torch.int32, device=device)[None] \
        .expand(B, T)


def _embed(params, tokens, patch_embeds):
    """Token embeddings, after the patch embeddings when given."""
    x = params["embed"][tokens]
    if patch_embeds is None:
        return x
    return torch.cat([patch_embeds.to(x.dtype), x], dim=1)


def apply_lm(params, tokens, cfg, taps=None, patch_embeds=None):
    """tokens: (B, T) int; patch_embeds: (B, P, D) or None -> (logits (B,
    P + T, padded_vocab), aux loss 0).

    ``taps`` (a dict) collects each block's activation taps under the JAX
    package's keys (``_run_segments``): ``seg<i>/l<j>/<k>`` for an unrolled
    layer, ``seg<i>/p<j>/<k>`` stacked ``(reps, ...)`` for a scanned one.
    A stacked tap is written into one buffer as the layers run, so it is
    never held twice."""
    x = _embed(params, tokens, patch_embeds)
    B, T = x.shape[:2]
    positions = _positions(B, T, x.device)
    reps_of = {_seg_name(si): seg[1] for si, seg in enumerate(cfg.layout())
               if seg[0] == "scan"}
    for name, key, rep, kind, moe in _each_layer(cfg):
        t = {} if taps is not None else None
        x = blk.apply_block(_at(params, name, key, rep), x, cfg, kind, moe,
                            positions=positions, taps=t)
        if taps is None:
            continue
        for k, v in t.items():
            path = f"{name}/{key}/{k}"
            if rep is None:
                taps[path] = v
                continue
            if rep == 0:
                taps[path] = v.new_empty((reps_of[name],) + tuple(v.shape))
            taps[path][rep].copy_(v)
    x = apply_norm(params["final_norm"], x, cfg)
    return x @ _head(params), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def init_lm_cache(cfg, batch: int, max_len: int, device):
    """An empty decode cache (``device="meta"`` gives its shapes only). A
    scanned segment's leaves repeat one layer's empty cache ``reps`` times,
    as JAX broadcasts it, so a ring's ``abs_pos`` stays -1."""
    caches = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    for si, seg in enumerate(cfg.layout()):
        if seg[0] == "unroll":
            caches[_seg_name(si)] = {
                f"l{j}": blk.init_block_cache(cfg, cfg.layer_spec(li)[0],
                                              batch, max_len, device)
                for j, li in enumerate(seg[1])}
        else:
            _, reps, idxs = seg
            caches[_seg_name(si)] = {
                f"p{j}": map_tree(
                    lambda a: torch.stack([a] * reps),
                    blk.init_block_cache(cfg, cfg.layer_spec(li)[0], batch,
                                         max_len, device))
                for j, li in enumerate(idxs)}
    return caches


def lm_decode_step(params, token, cache, cfg):
    """token: (B, 1) int. Returns (logits (B, 1, V), cache); the cache is
    updated in place (new K/V rows or recurrent states, every ``pos`` +
    1)."""
    x = params["embed"][token]
    cache["pos"].add_(1)
    for name, key, rep, kind, moe in _each_layer(cfg):
        x, _ = blk.decode_block(_at(params, name, key, rep), x,
                                _at(cache, name, key, rep), cfg, kind, moe)
    x = apply_norm(params["final_norm"], x, cfg)
    return x @ _head(params), cache


def lm_prefill(params, tokens, cfg, max_len: int, lengths=None,
               patch_embeds=None):
    """Prefill: full forward returning (last-token logits, populated cache).
    ``patch_embeds`` (B, P, D) go before the tokens; the cache ``pos`` is
    then P + T.

    ``lengths`` (B,) enables *ragged* prefill on right-padded token batches:
    logits are gathered at position ``lengths-1`` per sample and every cache
    ``pos`` is set to ``lengths``, so padded tail positions are never read
    back (causality keeps rows < lengths exact). Only valid for pure
    global-attention stacks: a recurrent state or a window ring would
    absorb the pad tokens.
    """
    if lengths is not None and set(cfg.layer_kinds) != {"attn"}:
        raise ValueError("ragged prefill (lengths=) requires a pure "
                         f"global-attention stack, got {set(cfg.layer_kinds)}")
    if lengths is not None and patch_embeds is not None:
        # the reference gathers the logits at lengths - 1 of the combined
        # sequence, a patch position, and sets pos = lengths
        # (repro.models.lm.lm_prefill); no serving path sends both
        raise ValueError("ragged prefill (lengths=) with patch_embeds: "
                         "lengths would index the patch positions; not "
                         "supported")
    x = _embed(params, tokens, patch_embeds)
    B, T = x.shape[:2]
    positions = _positions(B, T, x.device)

    def run_layer(p, x, kind, moe):
        blk._check(kind)
        if kind == "rwkv":
            return blk.rwkv_block(p, x, cfg)
        h = apply_norm(p["ln1"], x, cfg)
        if kind == "mamba":
            y, c = ssm_mod.apply_mamba(p["mixer"], h, cfg)
        else:
            y, c = attn_mod.apply_attn(p["mixer"], h, cfg, kind,
                                       positions=positions,
                                       return_cache=True)
            c = _window_cache(c, cfg, max_len) if kind == "swa" \
                else _pad_cache(c, max_len)
        x = x + y
        h = apply_norm(p["ln2"], x, cfg)
        return x + blk.ffn(p["mlp"], h, cfg, moe), c

    cache = {"pos": torch.full((B,), T, dtype=torch.int32, device=x.device)}
    per_key = {}
    for name, key, rep, kind, moe in _each_layer(cfg):
        x, c = run_layer(_at(params, name, key, rep), x, kind, moe)
        per_key.setdefault((name, key, rep is not None), []).append(c)
    for (name, key, stacked), cs in per_key.items():
        cache.setdefault(name, {})[key] = stack_layers(cs) if stacked \
            else cs[0]
    if lengths is None:
        x_last = x[:, -1:]
    else:
        lengths = lengths.to(x.device)
        x_last = x[torch.arange(B, device=x.device), lengths.long() - 1][:,
                                                                          None]
        cache = override_cache_pos(cache, lengths)
    x = apply_norm(params["final_norm"], x_last, cfg)
    return x @ _head(params), cache


def override_cache_pos(tree, lengths):
    """Every ``pos`` leaf of a prefill cache set to per-sample ``lengths``
    (a new tree; scanned leaves (reps, B) get the lengths broadcast). Each
    leaf is its own copy: decode advances them in place."""
    if isinstance(tree, dict):
        return {k: (lengths.to(v.dtype).expand(v.shape).clone()
                    if k == "pos" else override_cache_pos(v, lengths))
                for k, v in tree.items()}
    return tree


def _pad_cache(c, max_len):
    """Right-pad a freshly built cache to max_len time slots: ``k``, ``v``
    or MLA's ``ckv``, ``k_rope``."""
    out = dict(c)
    for key in c.keys() & {"k", "v", "ckv", "k_rope"}:
        T = c[key].shape[1]
        if T < max_len:
            pad = [0, 0] * (c[key].ndim - 2) + [0, max_len - T]
            out[key] = F.pad(c[key], pad)
    return out


def _window_cache(c, cfg, max_len):
    """A full prefill cache -> the ring-buffer window cache: the last
    ``min(W, T)`` positions at slots ``pos mod W`` (W = min(window,
    max_len)), ``abs_pos`` -1 in the slots they leave empty."""
    W = min(cfg.sliding_window, max_len)
    k, v = c["k"], c["v"]
    B, T = k.shape[:2]
    n = min(W, T)
    pos_vals = torch.arange(T - n, T, dtype=torch.int32, device=k.device)
    slots = (pos_vals % W).long()
    k_ring = k.new_zeros((B, W) + k.shape[2:])
    v_ring = v.new_zeros((B, W) + v.shape[2:])
    k_ring[:, slots] = k[:, T - n:]
    v_ring[:, slots] = v[:, T - n:]
    abs_ring = torch.full((B, W), -1, dtype=torch.int32, device=k.device)
    abs_ring[:, slots] = pos_vals
    return {"k": k_ring, "v": v_ring, "pos": c["pos"], "abs_pos": abs_ring}
