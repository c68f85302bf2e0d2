"""Public model API (``repro.models.api``): the vit, lm and encdec
branches of ``build_model``. ``Model`` bundles plain functions:

  init(gen, device=None)                      -> params
  apply(params, batch, taps=None, train=False, tp=None) -> logits (vit) |
                                                 (logits, aux) (lm, encdec)
  loss(params, batch, train=True)             -> fp32 0-d training loss
  prefill(params, batch, max_len, lengths=None, tp=None) -> (logits, cache)
  decode_step(params, token, cache, tp=None)  -> (logits, cache)
  init_cache(batch, max_len, device=None[, mem_len]) -> empty cache

``decode_step`` updates the cache in place. A VLM stub batch
(``frontend="patch_stub"``) carries ``patch_embeds`` (B, P, D) beside its
``tokens``; ``apply`` and ``prefill`` put them before the tokens. ``apply``
of every family, and the ``prefill`` and ``decode_step`` of an LM and of an
enc-dec, take ``tp=``, a rank's tensor-parallel context
(``models.common.TensorParallel``) over its blocks
(``distrib.sharding.forward_specs``); ``apply`` then records the rank's
taps (the sharded calibration forward), and returns whole ViT logits and an
LM's or enc-dec's vocab block where the head is split there. An enc-dec
batch carries the encoder's ``frames`` (B, S, D) beside the decoder's
``tokens``, and its ``init_cache`` takes the memory length ``mem_len`` (S).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import map_tree
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models import vit as vit_mod


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    apply: Callable
    loss: Callable
    prefill: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    init_cache: Optional[Callable] = None


def build_model(cfg: ModelConfig) -> Model:
    init_fn = {"vit": vit_mod.init_vit, "lm": lm_mod.init_lm,
               "encdec": encdec_mod.init_encdec}.get(cfg.family)
    if init_fn is None:
        raise ValueError(f"unknown model family {cfg.family!r}")

    def init(gen: torch.Generator, device=None):
        dev = resolve_device(device)
        return map_tree(lambda a: a.to(dev), init_fn(gen, cfg))

    if cfg.family == "vit":
        def apply(params, batch, taps=None, train=False, tp=None):
            inputs = batch["images"] if "images" in batch else batch["embeds"]
            return vit_mod.apply_vit(params, inputs, cfg, taps=taps,
                                     train=train, tp=tp)

        return Model(cfg=cfg, init=init, apply=apply,
                     loss=lambda params, batch, train=True:
                         vit_mod.vit_loss(params, batch, cfg, train=train))

    if cfg.family == "encdec":
        return _encdec_model(cfg, init)

    def lm_apply(params, batch, taps=None, train=False, tp=None):
        return lm_mod.apply_lm(params, batch["tokens"], cfg, taps=taps,
                               patch_embeds=batch.get("patch_embeds"),
                               train=train, tp=tp)

    def init_cache(batch, max_len, device=None):
        dev = resolve_device(None) if device is None else torch.device(device)
        return lm_mod.init_lm_cache(cfg, batch, max_len, dev)

    return Model(
        cfg=cfg, init=init, apply=lm_apply,
        loss=lambda params, batch, train=True:
            lm_mod.lm_loss(params, batch, cfg, train=train),
        prefill=lambda params, batch, max_len, lengths=None, tp=None:
            lm_mod.lm_prefill(params, batch["tokens"], cfg, max_len,
                              lengths=lengths,
                              patch_embeds=batch.get("patch_embeds"), tp=tp),
        decode_step=lambda params, token, cache, tp=None:
            lm_mod.lm_decode_step(params, token, cache, cfg, tp=tp),
        init_cache=init_cache,
    )


def _encdec_model(cfg: ModelConfig, init) -> Model:
    def init_cache(batch, max_len, device=None, mem_len=None):
        if mem_len is None:
            raise ValueError("an enc-dec cache needs mem_len= (the encoder "
                             "memory's length)")
        dev = resolve_device(None) if device is None else torch.device(device)
        return encdec_mod.init_encdec_cache(cfg, batch, max_len, mem_len, dev)

    return Model(
        cfg=cfg, init=init,
        apply=lambda params, batch, taps=None, train=False, tp=None:
            encdec_mod.apply_encdec(params, batch["frames"], batch["tokens"],
                                    cfg, taps=taps, train=train, tp=tp),
        loss=lambda params, batch, train=True:
            encdec_mod.encdec_loss(params, batch, cfg, train=train),
        prefill=lambda params, batch, max_len, lengths=None, tp=None:
            encdec_mod.encdec_prefill(params, batch["frames"],
                                      batch["tokens"], cfg, max_len,
                                      lengths=lengths, tp=tp),
        decode_step=lambda params, token, cache, tp=None:
            encdec_mod.encdec_decode_step(params, token, cache, cfg, tp=tp),
        init_cache=init_cache,
    )
