"""ViT / DeiT (``repro.models.vit``): the paper's own architecture family.

Pre-norm ViT: patch embedding (conv-as-linear on flattened patches), cls
token, learned positional embeddings, bidirectional attention blocks, a
classification head. The blocks are stored stacked under ``seg0/p0`` with
the layer axis first, as the JAX pytree keeps them for ``lax.scan``; the
forward loops over that axis and returns taps stacked the same way
(``seg0/p0/{h,q,k}``, layer axis first).
"""
from __future__ import annotations

import torch

from repro_torch.models import blocks as blk
from repro_torch.models.common import (apply_norm, dense_init, dtype_of,
                                       embed_init, init_norm, layer_slice,
                                       stack_layers)


def num_patches(cfg) -> int:
    return (cfg.img_size // cfg.patch) ** 2


def init_vit(gen: torch.Generator, cfg):
    """Parameters on the CPU, drawn from ``gen``."""
    dt = dtype_of(cfg)
    N = num_patches(cfg)
    params = {
        "cls": torch.zeros((1, 1, cfg.d_model), dtype=dt),
        "pos": embed_init(gen, (1, N + 1, cfg.d_model), dt),
        "final_norm": init_norm(cfg),
        "class_head": dense_init(gen, (cfg.d_model, cfg.n_classes), dt,
                                 scale=0.02),
        "head_bias": torch.zeros(cfg.n_classes),
    }
    if cfg.frontend == "patch_conv":
        pdim = cfg.patch * cfg.patch * 3
        params["patch_w"] = dense_init(gen, (pdim, cfg.d_model), dt)
        params["patch_b"] = torch.zeros(cfg.d_model)
    params["seg0"] = {"p0": stack_layers(
        [blk.init_block(gen, cfg, "attn", False)
         for _ in range(cfg.n_layers)])}
    return params


def patchify(images, cfg):
    """images: (B, H, W, 3) -> (B, N, p*p*3)."""
    B, H, W, C = images.shape
    p = cfg.patch
    x = images.reshape(B, H // p, p, W // p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, (H // p) * (W // p),
                                                p * p * C)


def apply_vit(params, inputs, cfg, *, taps=None):
    """inputs: images (B,H,W,3) if frontend='patch_conv', else patch
    embeddings (B, N, D). Returns fp32 logits (B, n_classes)."""
    dt = dtype_of(cfg)
    if cfg.frontend == "patch_conv":
        x = patchify(inputs.to(dt), cfg) @ params["patch_w"] \
            + params["patch_b"].to(dt)
    else:
        x = inputs.to(dt)
    B, N, D = x.shape
    x = torch.cat([params["cls"].expand(B, 1, D), x], dim=1)
    x = x + params["pos"][:, :N + 1].to(dt)
    layers = params["seg0"]["p0"]
    per_layer = []
    for i in range(cfg.n_layers):
        t = {} if taps is not None else None
        x = blk.apply_block(layer_slice(layers, i), x, cfg, "attn", False,
                            taps=t, mask_kind="full")
        per_layer.append(t)
    if taps is not None:
        for k in per_layer[0]:
            taps[f"seg0/p0/{k}"] = torch.stack([t[k] for t in per_layer])
    x = apply_norm(params["final_norm"], x, cfg)
    pooled = x[:, 0] if cfg.pool == "cls" else x.mean(dim=1)
    logits = pooled @ params["class_head"] + params["head_bias"].to(dt)
    return logits.float()
