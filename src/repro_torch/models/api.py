"""Public model API (``repro.models.api``): the vit branch of
``build_model``. LM and enc-dec families are not ported yet; they raise."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import map_tree
from repro_torch.models import vit as vit_mod


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable      # init(gen: torch.Generator, device=None) -> params
    apply: Callable     # apply(params, batch, taps=None) -> logits


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "vit":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; see "
            f"repro.models.api.build_model")

    def init(gen: torch.Generator, device=None):
        dev = resolve_device(device)
        return map_tree(lambda a: a.to(dev), vit_mod.init_vit(gen, cfg))

    def apply(params, batch, taps=None):
        inputs = batch["images"] if "images" in batch else batch["embeds"]
        return vit_mod.apply_vit(params, inputs, cfg, taps=taps)

    return Model(cfg=cfg, init=init, apply=apply)
