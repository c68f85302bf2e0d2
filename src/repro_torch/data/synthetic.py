"""Deterministic synthetic data (``repro.data.synthetic``): vision
batches and the LM token stream.

numpy makes every array, with the same generators, seeds and call order as
the JAX package, so both packages see bit-identical images, tokens and
enc-dec frames; they are returned as torch tensors on the requested
device.

Images are class prototypes plus structured (low-rank) noise; tokens follow
an order-1 Markov chain whose rows prefer a small successor set; so models
develop the anisotropic activations CORP exploits (paper App. A). The
chain's table is V x V float32 (17 GB at RWKV6-3B's vocabulary, 92 GB at
Qwen2-1.5B's), as in the reference: it is for reduced configs.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import resolve_device


# ---------------------------------------------------------------------------
# LM: markov chain over tokens
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _markov_table(vocab: int, seed: int):
    """Sparse-ish row-stochastic transition table (vocab, vocab)."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(vocab, vocab).astype(np.float32) * 2.0
    # each token prefers a small successor set -> learnable structure
    for i in range(vocab):
        hot = rng.choice(vocab, size=max(2, vocab // 64), replace=False)
        logits[i, hot] += 6.0
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def lm_batch(step: int, *, batch: int, seq: int, vocab: int, seed: int = 0,
             shard: int = 0, nshards: int = 1, device=None):
    """{'tokens': (b, seq), 'labels': (b, seq)} int32 on ``device``."""
    dev = resolve_device(device)
    table = _markov_table(vocab, seed)
    b = batch // nshards
    rng = np.random.RandomState(
        ((seed * 1_000_003 + step) * 977 + shard) % (2**31 - 1))
    toks = np.empty((b, seq + 1), np.int32)
    toks[:, 0] = rng.randint(0, vocab, size=b)
    # vectorized markov sampling
    u = rng.rand(b, seq).astype(np.float32)
    cdf = np.cumsum(table, axis=-1)
    for t in range(seq):
        rows = cdf[toks[:, t]]
        toks[:, t + 1] = (u[:, t][:, None] < rows).argmax(-1)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
            "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}



def lm_stream(*, batch, seq, vocab, seed=0, start_step=0, shard=0,
              nshards=1, device=None):
    """Endless ``(step, lm_batch(step))`` from ``start_step``."""
    step = start_step
    while True:
        yield step, lm_batch(step, batch=batch, seq=seq, vocab=vocab,
                             seed=seed, shard=shard, nshards=nshards,
                             device=device)
        step += 1

# ---------------------------------------------------------------------------
# vision: prototype classes + low-rank structured noise
# ---------------------------------------------------------------------------

def _smooth(p):
    """0.25 (roll(p, 1, 1) + roll(p, -1, 1) + roll(p, 1, 2) + roll(p, -1,
    2)), summed in that order as the reference does, bit for bit, but into
    one buffer by slices (no rolled copies: 1000 prototypes at 224 are
    0.6 GB)."""
    o = np.empty_like(p)
    o[:, 1:] = p[:, :-1]
    o[:, 0] = p[:, -1]
    o[:, :-1] += p[:, 1:]
    o[:, -1] += p[:, 0]
    o[:, :, 1:] += p[:, :, :-1]
    o[:, :, 0] += p[:, :, -1]
    o[:, :, :-1] += p[:, :, 1:]
    o[:, :, -1] += p[:, :, 0]
    o *= 0.25
    return o


@functools.lru_cache(maxsize=8)
def _prototypes(n_classes: int, img: int, seed: int):
    rng = np.random.RandomState(seed + 7)
    protos = rng.randn(n_classes, img, img, 3).astype(np.float32)
    # smooth the prototypes (low-frequency structure)
    for _ in range(2):
        protos = _smooth(protos)
    basis = rng.randn(8, img, img, 3).astype(np.float32) * 0.5
    return protos, basis


def vit_batch(step: int, *, batch: int, img: int, n_classes: int,
              seed: int = 0, shard: int = 0, nshards: int = 1,
              noise: float = 0.6, iid_noise: float = 0.1, device=None):
    """{'images': (b, img, img, 3) float32, 'labels': (b,)} on ``device``."""
    dev = resolve_device(device)
    protos, basis = _prototypes(n_classes, img, seed)
    b = batch // nshards
    rng = np.random.RandomState(
        ((seed * 999_983 + step) * 1009 + shard + 1) % (2**31 - 1))
    labels = rng.randint(0, n_classes, size=b)
    coef = rng.randn(b, basis.shape[0]).astype(np.float32)
    x = protos[labels] + noise * np.einsum("bk,khwc->bhwc", coef, basis)
    x = x + iid_noise * rng.randn(b, img, img, 3).astype(np.float32)
    return {"images": torch.from_numpy(x).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}



def vit_stream(*, batch, img, n_classes, seed=0, start_step=0, shard=0,
               nshards=1, device=None):
    """Endless ``(step, vit_batch(step))`` from ``start_step``."""
    step = start_step
    while True:
        yield step, vit_batch(step, batch=batch, img=img,
                              n_classes=n_classes, seed=seed, shard=shard,
                              nshards=nshards, device=device)
        step += 1

def calib_stream(cfg, *, n_samples: int, batch: int, seq: int = 64,
                 seed: int = 1234, device=None):
    """Zero-arg-callable factory: a fresh finite iterator of unlabeled
    calibration batches per call (CORP traverses the stream twice):
    ``{"images"}`` for a ViT, ``{"tokens"}`` of ``seq`` tokens for an LM,
    plus ``{"patch_embeds"}`` (batch, 8, d_model) float32 for the VLM
    stub frontend, drawn after the tokens from ``RandomState(seed + i)``;
    an enc-dec's ``{"frames", "tokens"}``, its frames (batch, seq,
    d_model) float32 drawn from ``RandomState(seed + i)`` after the
    tokens."""
    dev = resolve_device(device)
    steps = max(1, n_samples // batch)

    def make():
        for i in range(steps):
            if cfg.family == "vit":
                b = vit_batch(10_000 + i, batch=batch, img=cfg.img_size,
                              n_classes=max(cfg.n_classes, 2), seed=seed,
                              device=dev)
                yield {"images": b["images"]}
            elif cfg.family == "encdec":
                b = lm_batch(10_000 + i, batch=batch, seq=seq,
                             vocab=cfg.vocab_size, seed=seed, device=dev)
                rng = np.random.RandomState(seed + i)
                frames = rng.randn(batch, seq, cfg.d_model) \
                    .astype(np.float32)
                yield {"frames": torch.from_numpy(frames).to(dev),
                       "tokens": b["tokens"]}
            else:
                b = lm_batch(10_000 + i, batch=batch, seq=seq,
                             vocab=cfg.vocab_size, seed=seed, device=dev)
                out = {"tokens": b["tokens"]}
                if cfg.frontend == "patch_stub":
                    rng = np.random.RandomState(seed + i)
                    out["patch_embeds"] = torch.from_numpy(
                        rng.randn(batch, 8, cfg.d_model)
                        .astype(np.float32)).to(dev)
                yield out
    return make
