"""Encoder-decoder model (``repro.models.encdec``, the seamless-m4t family).

The encoder takes precomputed frame embeddings (the audio frontend is a
stub); the decoder is a causal LM whose blocks also attend the encoder
memory. Positions are sinusoidal and absolute (no rope), so every
attention unit is class 1.

Params: ``embed``, ``head``, ``enc_final_norm``, ``final_norm`` and the
stacked layers ``enc/p0`` and ``dec/p0`` (layer axis first, as the JAX
package scans them; decoder blocks add ``ln_cross``/``cross``), so
``interop.from_numpy`` carries JAX params across unchanged. Taps are
stacked the same way under ``enc/p0/<k>`` and ``dec/p0/<k>``.

The decode cache is ``{"dec": {"self": {k, v, pos}, "cross": {k_mem,
v_mem}}, "pos"}``, every leaf of ``dec`` stacked (L, B, ...): the decoder's
self-attention K/V padded to ``max_len`` and the memory K/V of each layer,
computed once at prefill. ``encdec_decode_step`` updates it in place.

Two positional tables, as the reference makes them: the prefill's comes
from numpy float64 cast to fp32 (``_sinusoid``), the decode step's row is
computed in fp32 from ``pos``.

``encode``, ``encdec_prefill`` and ``encdec_decode_step`` take ``tp``, a
rank's ``common.TensorParallel`` with its blocks as params
(``distrib.sharding.forward_specs``): the encoder's and the decoder's
attention run over the rank's heads (the cross attention over its cross
heads, whose memory K/V the cache holds), the MLPs over its hidden
channels, one reduction a sub-layer; the embedding is vocab-parallel and
the sinusoid is added to its whole rows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.interop import map_tree
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models import lm as lm_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (apply_norm, dtype_of, embed_init,
                                       init_norm, init_stacked, layer_slice,
                                       remat as _remat, stack_layers)


def _sinusoid(T: int, D: int, device):
    """(T, D) fp32: sin | cos of pos / 10000^(2i/D), in float64 first."""
    pos = np.arange(T)[:, None]
    i = np.arange(D // 2)[None, :]
    ang = pos / (10000 ** (2 * i / D))
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb).float().to(device)


def init_encdec(gen: torch.Generator, cfg):
    """Parameters on ``gen``'s device, drawn from it."""
    dt = dtype_of(cfg)
    params = {"embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt),
              "enc_final_norm": init_norm(cfg),
              "final_norm": init_norm(cfg),
              "head": embed_init(gen, (cfg.d_model, cfg.padded_vocab), dt)}
    params["enc"] = {"p0": init_stacked(
        lambda: blk.init_block(gen, cfg, "attn", False), cfg.n_enc_layers)}
    params["dec"] = {"p0": init_stacked(
        lambda: blk.init_block(gen, cfg, "attn", False, cross=True),
        cfg.n_layers)}
    return params


def _run_stack(stack, x, cfg, L: int, *, taps, mask_kind, mem, prefix,
               tp=None, remat=False):
    """The L stacked blocks ``stack["p0"]`` in order; each tap is written
    into one (L, ...) buffer under ``<prefix>/p0/<k>`` as the layers run.
    ``remat`` recomputes each layer in the backward (the reference's
    checkpointed scan body), unless taps are recorded."""
    layers = stack["p0"]
    for i in range(L):
        t = {} if taps is not None else None

        def body(x, mem, i=i, t=t):
            return blk.apply_block(layer_slice(layers, i), x, cfg, "attn",
                                   False, taps=t, mask_kind=mask_kind,
                                   mem=mem, tp=tp)
        x = _remat(body, x, mem) if remat and taps is None \
            else body(x, mem)
        for k, v in (t or {}).items():
            path = f"{prefix}/p0/{k}"
            if i == 0:
                taps[path] = v.new_empty((L,) + tuple(v.shape))
            taps[path][i].copy_(v)
    return x


def encode(params, frames, cfg, *, taps=None, tp=None, remat=False):
    """frames: (B, S, D) stub frontend embeddings -> encoder memory (B, S,
    D), whole on every rank of ``tp``. The frames are cast to the model
    dtype before the table is added."""
    dt = dtype_of(cfg)
    S, D = frames.shape[1:]
    x = frames.to(dt) + _sinusoid(S, D, frames.device).to(dt)
    x = _run_stack(params["enc"], x, cfg, cfg.n_enc_layers, taps=taps,
                   mask_kind="full", mem=None, prefix="enc", tp=tp,
                   remat=remat)
    return apply_norm(params["enc_final_norm"], x, cfg)


def _embed(params, tokens, cfg, tp=None):
    """The token embeddings (vocab-parallel under ``tp``, whole D rows) with
    the sinusoid added."""
    x = lm_mod._embed(params, tokens, None, cfg, tp)
    return x + _sinusoid(tokens.shape[1], cfg.d_model,
                         x.device).to(x.dtype)


def apply_encdec(params, frames, tokens, cfg, *, taps=None, train=False,
                 remat=None, tp=None):
    """Returns (logits (B, T, padded_vocab), aux loss 0). ``remat``
    (default: ``train``) recomputes each encoder and decoder layer in the
    backward. Under ``tp`` (the sharded calibration forward) the encoder,
    the decoder and its cross sub-layers run over the rank's heads and
    channels, as ``encdec_prefill``'s, the taps are the rank's, and the
    logits the rank's vocab block where the head is split there."""
    remat = train if remat is None else remat
    mem = encode(params, frames, cfg, taps=taps, tp=tp, remat=remat)
    x = _run_stack(params["dec"], _embed(params, tokens, cfg, tp), cfg,
                   cfg.n_layers, taps=taps, mask_kind="causal", mem=mem,
                   prefix="dec", tp=tp, remat=remat)
    x = apply_norm(params["final_norm"], x, cfg)
    return lm_mod._logits(params, x, cfg, tp), \
        torch.zeros((), device=x.device)


def encdec_loss(params, batch, cfg, *, train=True, remat=None):
    """batch: {'frames': (B, S, D), 'tokens': (B, T), 'labels': (B, T)} ->
    the mean cross entropy over labels >= 0, fp32 0-d (no padded-vocab
    mask, as the reference)."""
    logits, _ = apply_encdec(params, batch["frames"], batch["tokens"], cfg,
                             train=train, remat=remat)
    return lm_mod.masked_nll(logits.float(), batch["labels"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_encdec_cache(cfg, batch: int, max_len: int, mem_len: int, device):
    """An empty decode cache (``device="meta"`` gives its shapes only):
    every layer's self-attention cache of ``max_len`` rows and memory K/V
    of ``mem_len`` rows, zeros, ``pos`` 0."""
    L, dt = cfg.n_layers, dtype_of(cfg)
    self_c = map_tree(
        lambda a: a.new_zeros((L,) + tuple(a.shape)),
        attn_mod.init_cache(cfg, "attn", batch, max_len, device))
    mem_shape = (L, batch, mem_len, cfg.n_kv_heads)
    return {"dec": {"self": self_c,
                    "cross": {"k_mem": torch.zeros(mem_shape + (cfg.eff_qk,),
                                                   dtype=dt, device=device),
                              "v_mem": torch.zeros(mem_shape + (cfg.d_head,),
                                                   dtype=dt, device=device)}},
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def encdec_prefill(params, frames, tokens, cfg, max_len: int, lengths=None,
                   tp=None):
    """Encode, then the teacher-forced decoder prefill. Returns (last
    logits (B, 1, V), cache).

    Under ``tp`` (``common.TensorParallel``, with the rank's blocks as
    params) the encoder and decoder run head- and channel-parallel, the
    embedding is vocab-parallel, the cache holds the rank's self and cross
    heads, and the logits are the rank's column block of the vocab when
    the head is split there (``lm._logits``).

    ``lengths`` (B,) allows ragged (right-padded) decoder prompts: causal
    self-attention keeps the cache rows < lengths exact, and the cross
    attention and MLP act per position, so only the logits' gather and
    the cache's ``pos`` take the true length. ``frames`` are unpadded: the
    memory is attended in full."""
    mem = encode(params, frames, cfg, tp=tp)
    x = _embed(params, tokens, cfg, tp)
    B, T = tokens.shape
    positions = lm_mod._positions(B, T, x.device)
    layers = params["dec"]["p0"]
    caches = []
    for i in range(cfg.n_layers):
        p = layer_slice(layers, i)
        h = apply_norm(p["ln1"], x, cfg)
        y, c = attn_mod.apply_attn(p["mixer"], h, cfg, "attn",
                                   positions=positions, return_cache=True,
                                   tp=tp)
        x = x + y
        x = x + blk.cross_sublayer(p, x, mem, cfg, tp=tp)
        h = apply_norm(p["ln2"], x, cfg)
        x = x + mlp_mod.apply_mlp(p["mlp"], h, cfg, tp=tp)
        caches.append({"self": lm_mod._pad_cache(c, max_len),
                       "cross": attn_mod.precompute_cross_cache(
                           p["cross"], mem, cfg)})
    cache = stack_layers(caches)
    del caches
    if lengths is None:
        x_last = x[:, -1:]
        pos = torch.full((B,), T, dtype=torch.int32, device=x.device)
    else:
        lengths = lengths.to(x.device)
        x_last = x[torch.arange(B, device=x.device),
                   lengths.long() - 1][:, None]
        cache = lm_mod.override_cache_pos(cache, lengths)
        pos = lengths.to(torch.int32).clone()
    x = apply_norm(params["final_norm"], x_last, cfg)
    return lm_mod._logits(params, x, cfg, tp), {"dec": cache, "pos": pos}


def encdec_decode_step(params, token, cache, cfg, tp=None):
    """token: (B, 1) int -> (logits (B, 1, V), cache); the cache is updated
    in place (each layer's new self K/V row, every ``pos`` + 1). Under
    ``tp`` as ``encdec_prefill``."""
    x = lm_mod._embed(params, token, None, cfg, tp)
    pos = cache["pos"]
    D = cfg.d_model
    i = torch.arange(D // 2, dtype=torch.float32, device=x.device)[None, :]
    ang = pos.float()[:, None] / (10000.0 ** (2 * i / D))
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)   # (B, D)
    x = x + pe[:, None, :].to(x.dtype)
    layers, dec = params["dec"]["p0"], cache["dec"]
    for li in range(cfg.n_layers):
        c = layer_slice(dec, li)
        x, _ = blk.decode_block(layer_slice(layers, li), x, c["self"], cfg,
                                "attn", False, cross_cache=c["cross"],
                                tp=tp)
    pos.add_(1)
    x = apply_norm(params["final_norm"], x, cfg)
    return lm_mod._logits(params, x, cfg, tp), cache
