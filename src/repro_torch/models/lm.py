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

``apply_lm``, ``lm_prefill`` and ``lm_decode_step`` take ``tp``, a rank's
``common.TensorParallel`` (None: unsharded), with its blocks as params
(``distrib.sharding.forward_specs``): the embedding lookup is
vocab-parallel (``TensorParallel.embed``), the blocks head- and
channel-parallel, and the logits are the rank's column block of the
vocab when the head is split there (``TensorParallel.vocab_argmax`` reads
them; ``all_gather`` gives the whole row). Under ``tp`` the taps of
``apply_lm`` (the sharded calibration forward) are the rank's heads and
channels, under the same keys.

``lm_loss`` is the training objective; ``apply_lm(train=True)``
recomputes each repetition of a scanned segment in the backward, as the
reference's scan body is checkpointed, and returns the MoE blocks' summed
load-balancing loss as aux.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.interop import flatten, map_tree
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (apply_norm, dtype_of, embed_init,
                                       init_norm, init_stacked, layer_slice,
                                       remat as _remat, stack_layers)


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


def _logits(params, x, cfg, tp=None):
    """x @ head; under ``tp`` a head split on D gives partial sums, which
    are reduced, and one split on the vocab the rank's column block."""
    head = _head(params)
    if tp is not None and head.shape[0] != cfg.d_model:
        lo, hi = tp.block(cfg.d_model)
        return tp.reduce_product(x[..., lo:hi], head)
    return x @ head


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


def _embed(params, tokens, patch_embeds, cfg=None, tp=None):
    """Token embeddings, after the patch embeddings when given."""
    x = params["embed"][tokens] if tp is None else tp.embed(
        params["embed"], tokens, cfg.padded_vocab, cfg.d_model)
    if patch_embeds is None:
        return x
    return torch.cat([patch_embeds.to(x.dtype), x], dim=1)


def apply_lm(params, tokens, cfg, taps=None, patch_embeds=None, train=False,
             remat=None, tp=None):
    """tokens: (B, T) int; patch_embeds: (B, P, D) or None -> (logits (B,
    P + T, padded_vocab), aux loss: the sum of every MoE block's
    load-balancing loss, fp32 0-d). Under ``tp`` (module docstring) the
    logits are the rank's vocab block where the head is split there.

    ``taps`` (a dict) collects each block's activation taps under the JAX
    package's keys (``_run_segments``): ``seg<i>/l<j>/<k>`` for an unrolled
    layer, ``seg<i>/p<j>/<k>`` stacked ``(reps, ...)`` for a scanned one.
    A stacked tap is written into one buffer as the layers run, so it is
    never held twice.

    ``remat`` (default: ``train``) recomputes each repetition of a scanned
    segment in the backward, as the reference checkpoints its scan body;
    unrolled layers, and any forward that records taps, keep their
    activations."""
    remat = train if remat is None else remat
    x = _embed(params, tokens, patch_embeds, cfg, tp)
    B, T = x.shape[:2]
    positions = _positions(B, T, x.device)
    aux = torch.zeros((), device=x.device)

    def block(p, x, kind, moe, t=None):
        a = []
        x = blk.apply_block(p, x, cfg, kind, moe, positions=positions,
                            taps=t, tp=tp, aux=a)
        return x, sum(a, torch.zeros((), device=x.device))

    for si, seg in enumerate(cfg.layout()):
        name = _seg_name(si)
        if seg[0] == "unroll":
            for j, li in enumerate(seg[1]):
                t = {} if taps is not None else None
                x, a = block(params[name][f"l{j}"], x, *cfg.layer_spec(li),
                             t)
                aux = aux + a
                for k, v in (t or {}).items():
                    taps[f"{name}/l{j}/{k}"] = v
            continue
        _, reps, idxs = seg
        specs = [cfg.layer_spec(li) for li in idxs]
        for r in range(reps):
            def body(x, r=r):
                a_g = torch.zeros((), device=x.device)
                for j, (kind, moe) in enumerate(specs):
                    t = {} if taps is not None else None
                    x, a = block(layer_slice(params[name][f"p{j}"], r), x,
                                 kind, moe, t)
                    a_g = a_g + a
                    for k, v in (t or {}).items():
                        path = f"{name}/p{j}/{k}"
                        if r == 0:
                            taps[path] = v.new_empty((reps,) + tuple(v.shape))
                        taps[path][r].copy_(v)
                return x, a_g

            x, a = _remat(body, x) if remat and taps is None else body(x)
            aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg)
    return _logits(params, x, cfg, tp), aux


def lm_loss(params, batch, cfg, *, train=True, remat=None):
    """batch: {'tokens': (B, T), 'labels': (B, T)[, 'patch_embeds']} ->
    fp32 0-d: the mean next-token cross entropy over labels >= 0 (padded
    vocab entries at -1e30, patch positions dropped) + 0.01 aux."""
    logits, aux = apply_lm(params, batch["tokens"], cfg,
                           patch_embeds=batch.get("patch_embeds"),
                           train=train, remat=remat)
    labels = batch["labels"]
    if "patch_embeds" in batch:
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    lf = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        lf = torch.cat([lf[..., :cfg.vocab_size],
                        lf.new_full(lf.shape[:-1] + (cfg.padded_vocab
                                                     - cfg.vocab_size,),
                                    -1e30)], dim=-1)
    return masked_nll(lf, labels) + 0.01 * aux


def masked_nll(lf, labels):
    """Mean of logsumexp - gold over the positions whose label is >= 0.
    lf: (..., V) fp32, labels: (...) int."""
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.clamp_min(0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


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


def gather_shifts(cache, tp):
    """Every RWKV layer's token-shift rows, whole: a rank holds its block
    of D of each ``shift`` leaf (``tp``), and one ``all_gather`` over all
    of them serves the whole decode step. -> {leaf path: (..., B, D)}."""
    shifts = {p: t for p, t in flatten(cache).items()
              if p.endswith("/shift")}
    rows = torch.cat([t.reshape(-1, t.shape[-1]) for t in shifts.values()])
    whole = tp.all_gather(rows, -1)
    out, at = {}, 0
    for path, t in shifts.items():
        n = t.numel() // t.shape[-1]
        out[path] = whole[at:at + n].reshape(t.shape[:-1] + (-1,))
        at += n
    return out


def lm_decode_step(params, token, cache, cfg, tp=None):
    """token: (B, 1) int. Returns (logits (B, 1, V), cache); the cache is
    updated in place (new K/V rows or recurrent states, every ``pos`` +
    1)."""
    x = _embed(params, token, None, cfg, tp)
    cache["pos"].add_(1)
    shifts = gather_shifts(cache, tp) \
        if tp is not None and "rwkv" in cfg.layer_kinds else None
    for name, key, rep, kind, moe in _each_layer(cfg):
        prev = None
        if shifts is not None and kind == "rwkv":
            prev = {part: shifts[f"{name}/{key}/{part}/shift"]
                    for part in ("time", "channel")}
            if rep is not None:
                prev = {k: v[rep] for k, v in prev.items()}
        x, _ = blk.decode_block(_at(params, name, key, rep), x,
                                _at(cache, name, key, rep), cfg, kind, moe,
                                tp=tp, prev=prev)
    x = apply_norm(params["final_norm"], x, cfg)
    return _logits(params, x, cfg, tp), cache


def lm_prefill(params, tokens, cfg, max_len: int, lengths=None,
               patch_embeds=None, tp=None):
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
    x = _embed(params, tokens, patch_embeds, cfg, tp)
    B, T = x.shape[:2]
    positions = _positions(B, T, x.device)

    def run_layer(p, x, kind, moe):
        blk._check(kind)
        if kind == "rwkv":
            return blk.rwkv_block(p, x, cfg, tp=tp)
        h = apply_norm(p["ln1"], x, cfg)
        if kind == "mamba":
            y, c = ssm_mod.apply_mamba(p["mixer"], h, cfg, tp=tp)
        else:
            y, c = attn_mod.apply_attn(p["mixer"], h, cfg, kind,
                                       positions=positions,
                                       return_cache=True, tp=tp)
            c = _window_cache(c, cfg, max_len) if kind == "swa" \
                else _pad_cache(c, max_len)
        x = x + y
        h = apply_norm(p["ln2"], x, cfg)
        return x + blk.ffn(p["mlp"], h, cfg, moe, tp=tp), c

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
    return _logits(params, x, cfg, tp), cache


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
