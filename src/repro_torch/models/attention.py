"""Attention mixer (``repro.models.attention``): q/k/v projections with the
qkv bias, qk-norm and rope, the attention kernel, the output projection;
and the one-token decode against a KV cache. Taps ``q`` (B,T,H,dq) and
``k`` (B,T,Hkv,dq), taken after norm and rope, feed the CORP logit
statistics.

Rope (LMs) uses per-head frequency tables ``rope_inv_q``/``rope_inv_k`` in
the params, as the JAX package stores them; ``swa`` layers take
``rope_theta_local``. Decode updates the cache in place: the new K/V row
and ``pos`` are written into the cache's own tensors, so a step never
copies the cache. A ``swa`` layer's cache is a ring of
``min(max_len, sliding_window)`` slots: token ``pos`` goes to slot ``pos
mod S`` and ``abs_pos`` (-1 where empty) records which position each slot
holds, from which the decode mask follows.

The qk-norm scales are shared by all heads, ``(dq,)``, in a dense config.
A pruned config's template holds them per head, ``(H, qk_kept)`` and
``(Hkv, qk_kept)``: the shape the class-3 fold writes, so that a pruned
checkpoint restores into it (the JAX template keeps ``(qk_kept,)``, and
its restore of a pruned qk-norm checkpoint fails).

MLA (deepseek-v3, ``cfg.mla``): queries and keys/values go through
low-rank latents (``w_dq`` to ``q_lora_rank``, ``w_dkv`` to
``kv_lora_rank``, each rms-normed), per head a prunable *nope* block
(``w_uq_nope``/``w_uk_nope``, ``cfg.eff_qk`` dims) and a rope block
(``w_uq_rope`` per head, one ``w_k_rope`` key shared by the heads), and
``w_uv`` for the values. The taps are the nope blocks only. Prefill runs
the attention kernel on the concatenated (nope | rope) heads at scale
``1/sqrt(qk_nope_dim + qk_rope_dim)``, which pruning leaves as it is.
The cache holds the latent ``ckv`` (B, S, kv_lora_rank) and the roped
``k_rope`` (B, S, qk_rope_dim); decode absorbs ``w_uk_nope`` into the
query and ``w_uv`` after the softmax, in fp32 logits over the latent
cache (plain torch ops, as the reference's jnp).

Cross attention (the enc-dec decoder, no rope): the query comes from the
decoder states and the keys and values from the encoder memory, with
taps ``q`` (B, T, H, dq) and ``k`` (B, S, Hkv, dq), which the block
renames ``cross_q``/``cross_k``. Prefill runs the attention kernel
non-causal over T decoder rows against S memory rows; the decoder's
cache keeps the memory's K/V (``k_mem``, ``v_mem``), and decode runs the
decode kernel over them with every key valid. The logit scale is
1/sqrt(qk_full), after pruning too.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_decode import ops as decode_ops
from repro_torch.models.common import (apply_rope, dense_init, dtype_of,
                                       rms_head_norm, rope_freqs, tap)


def _uses_rope(cfg) -> bool:
    return cfg.family == "lm" and cfg.rwkv is None


def init_attn(gen: torch.Generator, cfg, kind: str = "attn",
              cross: bool = False):
    """kind: 'attn' | 'swa'; ``cross=True`` for decoder cross attention
    (never MLA)."""
    if cfg.mla is not None and not cross:
        return _init_mla(gen, cfg)
    dt = dtype_of(cfg)
    D, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dq, dv = cfg.eff_qk, cfg.d_head
    p = {
        "wq": dense_init(gen, (D, H, dq), dt),
        "wk": dense_init(gen, (D, Hkv, dq), dt),
        "wv": dense_init(gen, (D, Hkv, dv), dt),
        "wo": dense_init(gen, (H, dv, D), dt, scale=1.0 / math.sqrt(H * dv)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H, dq)
        p["bk"] = torch.zeros(Hkv, dq)
        p["bv"] = torch.zeros(Hkv, dv)
    if cfg.qk_norm:
        pruned = cfg.qk_kept is not None
        p["q_scale"] = torch.ones((H, dq) if pruned else (dq,))
        p["k_scale"] = torch.ones((Hkv, dq) if pruned else (dq,))
    if _uses_rope(cfg):
        theta = cfg.rope_theta_local if kind == "swa" else cfg.rope_theta
        inv = torch.from_numpy(rope_freqs(dq, theta)).float()
        # per-head copy so pruning can gather kept pair frequencies per head
        p["rope_inv_q"] = inv[None, :].repeat(H, 1)
        p["rope_inv_k"] = inv[None, :].repeat(Hkv, 1)
    return p


def _init_mla(gen: torch.Generator, cfg):
    """MLA params (``repro.models.attention._init_mla``), drawn in the
    reference's leaf order; ``rope_inv`` is the rope block's frequency
    table, kept as a leaf so that key paths match (the forward recomputes
    it, as the reference does)."""
    dt = dtype_of(cfg)
    m = cfg.mla
    D, H, nope = cfg.d_model, cfg.n_heads, cfg.eff_qk
    return {
        "w_dq": dense_init(gen, (D, m.q_lora_rank), dt),
        "q_norm_scale": torch.ones(m.q_lora_rank),
        "w_uq_nope": dense_init(gen, (m.q_lora_rank, H, nope), dt),
        "w_uq_rope": dense_init(gen, (m.q_lora_rank, H, m.qk_rope_dim), dt),
        "w_dkv": dense_init(gen, (D, m.kv_lora_rank), dt),
        "w_k_rope": dense_init(gen, (D, m.qk_rope_dim), dt),
        "kv_norm_scale": torch.ones(m.kv_lora_rank),
        "w_uk_nope": dense_init(gen, (m.kv_lora_rank, H, nope), dt),
        "w_uv": dense_init(gen, (m.kv_lora_rank, H, m.v_dim), dt),
        "wo": dense_init(gen, (H, m.v_dim, D), dt,
                         scale=1.0 / math.sqrt(H * m.v_dim)),
        "rope_inv": torch.from_numpy(
            rope_freqs(m.qk_rope_dim, cfg.rope_theta)).float(),
    }


def _mla_scale(cfg) -> float:
    """The MLA logit scale: the dense model's, after pruning too."""
    return 1.0 / math.sqrt(cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim)


def _mla_latents(p, x, cfg, positions):
    """The per-token MLA projections (``_apply_mla``, ``_decode_mla``): the
    normed query latent's nope and roped blocks (B, T, H, nope|rope), the
    normed kv latent (B, T, kv_lora_rank) and the roped shared key (B, T,
    rope)."""
    cq = rms_head_norm(torch.einsum("btd,dr->btr", x, p["w_dq"]),
                       p["q_norm_scale"], cfg.norm_eps)
    q_nope = torch.einsum("btr,rhq->bthq", cq, p["w_uq_nope"])
    q_rope = apply_rope(torch.einsum("btr,rhq->bthq", cq, p["w_uq_rope"]),
                        positions, cfg.rope_theta)
    ckv = rms_head_norm(torch.einsum("btd,dr->btr", x, p["w_dkv"]),
                        p["kv_norm_scale"], cfg.norm_eps)
    k_rope = apply_rope(torch.einsum("btd,dq->btq", x, p["w_k_rope"])
                        [:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def _apply_mla(p, x, cfg, *, positions, taps=None, return_cache=False):
    """Full-sequence MLA (``repro.models.attention._apply_mla``): the
    attention kernel on q = (q_nope | q_rope) and k = (k_nope | k_rope
    shared by the heads), v from the latent, causal."""
    B, T, _ = x.shape
    H, rope = cfg.n_heads, cfg.mla.qk_rope_dim
    q_nope, q_rope, ckv, k_rope = _mla_latents(p, x, cfg, positions)
    k_nope = torch.einsum("btr,rhq->bthq", ckv, p["w_uk_nope"])
    v = torch.einsum("btr,rhv->bthv", ckv, p["w_uv"])
    tap(taps, "q", q_nope)
    tap(taps, "k", k_nope)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, H, rope)],
                  dim=-1)
    o = flash_ops.attention(q, k, v, causal=True, scale=_mla_scale(cfg))
    y = torch.einsum("bthv,hvd->btd", o, p["wo"])
    cache = None
    if return_cache:
        cache = {"ckv": ckv, "k_rope": k_rope,
                 "pos": torch.full((B,), T, dtype=torch.int32,
                                   device=x.device)}
    return y, cache


def _decode_mla(p, x, cache, cfg):
    """One-token MLA decode with the absorbed products
    (``repro.models.attention._decode_mla``): the new ``ckv`` and
    ``k_rope`` rows are written at ``pos`` in place, q_eff = q_nope .
    w_uk_nope scores the latent cache directly, in fp32 logits, and the
    softmax-weighted latent goes through ``w_uv``; ``pos`` advances in
    place. Returns (y (B, 1, D), cache)."""
    pos = cache["pos"]
    q_nope, q_rope, ckv_new, kr_new = _mla_latents(p, x, cfg, pos[:, None])
    ckv, krope = cache["ckv"], cache["k_rope"]
    _scatter_time(ckv, ckv_new[:, 0], pos)
    _scatter_time(krope, kr_new[:, 0], pos)
    q_eff = torch.einsum("bhq,rhq->bhr", q_nope[:, 0], p["w_uk_nope"])
    ckv32 = ckv.float()
    logits = (torch.einsum("bhr,bsr->bhs", q_eff.float(), ckv32)
              + torch.einsum("bhq,bsq->bhs", q_rope[:, 0].float(),
                             krope.float())) * _mla_scale(cfg)
    valid = torch.arange(ckv.shape[1], device=pos.device)[None, :] \
        <= pos[:, None]
    logits = logits.masked_fill(~valid[:, None, :], -1e30)
    o_lat = torch.einsum("bhs,bsr->bhr", torch.softmax(logits, dim=-1),
                         ckv32)
    o = torch.einsum("bhr,rhv->bhv", o_lat.to(x.dtype), p["w_uv"])
    y = torch.einsum("bhv,hvd->bd", o, p["wo"])[:, None, :]
    pos.add_(1)
    return y, cache


def _rope_gathered(x, positions, inv):
    """Rope with per-head frequency table inv: (H, D/2); positions (B, T)."""
    ang = positions.float()[:, :, None, None] * inv      # (B,T,H,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def _project_qkv(p, x, cfg, positions, taps):
    """Q/K/V projection + bias (fp32-stored, cast to x's dtype) + qk-norm
    + rope + tap."""
    dt = x.dtype
    q = torch.einsum("btd,dhq->bthq", x, p["wq"])
    k = torch.einsum("btd,dhq->bthq", x, p["wk"])
    v = torch.einsum("btd,dhv->bthv", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if "q_scale" in p:
        q = rms_head_norm(q, p["q_scale"], cfg.norm_eps)
        k = rms_head_norm(k, p["k_scale"], cfg.norm_eps)
    if "rope_inv_q" in p:
        q = _rope_gathered(q, positions, p["rope_inv_q"])
        k = _rope_gathered(k, positions, p["rope_inv_k"])
    tap(taps, "q", q)
    tap(taps, "k", k)
    return q, k, v


def apply_attn(p, x, cfg, kind="attn", *, positions=None, taps=None,
               return_cache=False, mask_kind="causal"):
    """Full-sequence attention. x: (B, T, D); mask_kind 'causal' | 'full'
    (a ``swa`` layer adds its sliding window to 'causal'); ``positions``
    (B, T) for rope. Returns (y, cache | None).

    The scale is 1/sqrt(qk_full) even after pruning: the folded weights
    carry the compensation, the logit scale stays the dense model's. An
    MLA layer runs ``_apply_mla``."""
    if cfg.mla is not None:
        return _apply_mla(p, x, cfg, positions=positions, taps=taps,
                          return_cache=return_cache)
    q, k, v = _project_qkv(p, x, cfg, positions, taps)
    window = cfg.sliding_window if (kind == "swa" and mask_kind != "full") \
        else None
    scale = 1.0 / math.sqrt(cfg.qk_full)
    o = flash_ops.attention(q, k, v, causal=(mask_kind != "full"),
                            window=window, scale=scale)
    y = torch.einsum("bthv,hvd->btd", o, p["wo"])
    cache = None
    if return_cache:
        cache = {"k": k, "v": v,
                 "pos": torch.full((x.shape[0],), x.shape[1],
                                   dtype=torch.int32, device=x.device)}
    return y, cache


# ---------------------------------------------------------------------------
# cross attention (enc-dec)
# ---------------------------------------------------------------------------

def _project_mem(p, mem):
    """The memory's keys and values (B, S, Hkv, dq|dv), with the bias."""
    k = torch.einsum("bsd,dhq->bshq", mem, p["wk"])
    v = torch.einsum("bsd,dhv->bshv", mem, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return k, v


def _cross_q(p, x):
    q = torch.einsum("btd,dhq->bthq", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    return q


def apply_cross_attn(p, x, mem, cfg, *, taps=None):
    """x: (B, T, D) decoder states; mem: (B, S, D) encoder memory ->
    (B, T, D). Every decoder row sees every memory row (non-causal, T and
    S independent)."""
    q = _cross_q(p, x)
    k, v = _project_mem(p, mem)
    tap(taps, "q", q)
    tap(taps, "k", k)
    o = flash_ops.attention(q, k, v, causal=False,
                            scale=1.0 / math.sqrt(cfg.qk_full))
    return torch.einsum("bthv,hvd->btd", o, p["wo"])


def precompute_cross_cache(p, mem, cfg):
    """The memory's K/V a decode step attends: {"k_mem", "v_mem"}."""
    k, v = _project_mem(p, mem)
    return {"k_mem": k, "v_mem": v}


def decode_cross_attn(p, x, cross_cache, cfg):
    """x: (B, 1, D) one decoder token against the precomputed memory K/V,
    every key valid -> (B, 1, D)."""
    q = _cross_q(p, x)
    k = cross_cache["k_mem"]
    valid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    y = _decode_sdpa(q, k, cross_cache["v_mem"], valid,
                     1.0 / math.sqrt(cfg.qk_full))
    return torch.einsum("bhv,hvd->bd", y, p["wo"])[:, None, :]


# ---------------------------------------------------------------------------
# decode (one new token against a KV cache)
# ---------------------------------------------------------------------------

def init_cache(cfg, kind: str, batch: int, max_len: int, device):
    """An empty KV cache for one attention layer: ``max_len`` slots, or
    for ``swa`` a ring of ``min(max_len, sliding_window)`` with
    ``abs_pos`` -1 (empty); ``pos`` and ``abs_pos`` stay int32, as in the
    JAX package. An MLA layer caches the latent ``ckv`` and ``k_rope``."""
    dt = dtype_of(cfg)
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                   dtype=dt, device=device),
                "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim),
                                      dtype=dt, device=device),
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}
    dq, dv, Hkv = cfg.eff_qk, cfg.d_head, cfg.n_kv_heads
    S = min(max_len, cfg.sliding_window) if kind == "swa" else max_len
    c = {
        "k": torch.zeros((batch, S, Hkv, dq), dtype=dt, device=device),
        "v": torch.zeros((batch, S, Hkv, dv), dtype=dt, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if kind == "swa":
        c["abs_pos"] = torch.full((batch, S), -1, dtype=torch.int32,
                                  device=device)
    return c


def decode_attn(p, x, cache, cfg, kind="attn"):
    """x: (B, 1, D) one new token. Writes its K/V row at ``pos`` (a
    ``swa`` ring: at ``pos mod S``, with ``abs_pos``) and advances ``pos``
    in place; returns (y, cache). An MLA layer runs ``_decode_mla``."""
    if cfg.mla is not None:
        return _decode_mla(p, x, cache, cfg)
    pos = cache["pos"]                          # (B,) current length
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None], None)
    k, v = cache["k"], cache["v"]
    S = k.shape[1]
    slot = pos % S if kind == "swa" else pos
    _scatter_time(k, k_new[:, 0], slot)
    _scatter_time(v, v_new[:, 0], slot)
    if kind == "swa":
        abs_pos = cache["abs_pos"]
        _scatter_time(abs_pos, pos, slot)
        valid = (abs_pos >= 0) & (abs_pos >= pos[:, None] - S + 1)
    else:
        valid = torch.arange(S, device=pos.device)[None, :] <= pos[:, None]
    scale = 1.0 / math.sqrt(cfg.qk_full)
    y = _decode_sdpa(q, k, v, valid, scale)
    o = torch.einsum("bhv,hvd->bd", y, p["wo"])[:, None, :]
    pos.add_(1)
    return o, cache


def _scatter_time(buf, val, slot):
    """buf: (B, S, ...), val: (B, ...), slot: (B,) — write val at
    [b, slot[b]] in place, dropping rows with slot[b] >= S as JAX drops an
    out-of-bounds scatter (free slots keep decoding past max_len). The
    dropped rows rewrite their own old value, so nothing syncs with the
    host."""
    S = buf.shape[1]
    rows = torch.arange(buf.shape[0], device=buf.device)
    idx = slot.long().clamp(0, S - 1)
    keep = (slot < S)[(...,) + (None,) * (val.ndim - 1)]
    new = torch.where(keep, val.to(buf.dtype), buf[rows, idx])
    buf.index_put_((rows, idx), new)


def _decode_sdpa(q, k, v, valid, scale):
    """q: (B,1,H,dq); k/v: (B,S,Hkv,d); valid: (B,S) -> (B,H,dv), through
    the flash_decode kernel (its plain version for CPU tensors). Softmax
    weights stay fp32 up to the PV product, as in the TPU kernel."""
    return decode_ops.decode_attention(q[:, 0], k, v, valid, scale=scale)
