"""Model configuration dataclasses, copied from ``repro.configs.base``.

The field set is identical to the JAX package's ``ModelConfig`` (the
boundary test compares the two field by field), so a config names the same
model in both packages. Pruned models are the same dataclass with
``d_ff_kept`` / ``qk_kept`` / ``d_inner_kept`` set; model code reads the
``eff_*`` properties.

One difference from the reference: ``layout()`` of a config cut to fewer
layers than one period unrolls them (the reference indexes past the last
layer there and raises ``IndexError``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert hidden dim
    num_shared: int = 0            # shared (always-on) experts
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dims."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_dim: int


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64           # rank of data-dependent decay LoRA


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # 'lm' | 'encdec' | 'vit'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # block composition ------------------------------------------------
    # mixer pattern, cycled over depth. entries: 'attn' | 'swa' | 'mamba' | 'rwkv'
    pattern: Tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    moe_every: int = 1             # layer i is MoE iff moe and (i % moe_every == moe_every-1)
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    act: str = "silu"              # 'silu' | 'gelu' | 'relu2'
    mlp_kind: str = "glu"          # 'glu' (gated) | 'plain' (two-matrix, ViT/DeiT)
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 1024
    rope_theta: float = 1e4
    rope_theta_local: float = 1e4  # theta for 'swa' layers
    first_k_dense: int = 0         # first k layers use dense FFN even in MoE models
    dense_d_ff: Optional[int] = None  # FFN dim for those dense layers
    dense_d_ff_kept: Optional[int] = None  # pruned dim for those dense layers
    norm_kind: str = "rmsnorm"     # 'rmsnorm' | 'layernorm'
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # encoder-decoder ----------------------------------------------------
    n_enc_layers: int = 0          # >0 => family 'encdec'
    cross_attend: bool = False
    # vit / stub frontends -----------------------------------------------
    frontend: Optional[str] = None  # 'patch_stub' | 'frame_stub' | 'patch_conv'
    n_classes: int = 0
    img_size: int = 224
    patch: int = 16
    pool: str = "cls"              # 'cls' | 'mean'
    # pruning state (CORP) -------------------------------------------------
    d_ff_kept: Optional[int] = None     # kept MLP hidden channels
    qk_kept: Optional[int] = None       # kept per-head qk dims
    d_inner_kept: Optional[int] = None  # kept mamba inner channels
    experts_kept: Optional[int] = None  # kept routed experts
    # numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    vocab_round: int = 128         # embedding table padded to a multiple of this

    # -- derived ------------------------------------------------------------
    @property
    def eff_d_ff(self) -> int:
        return self.d_ff if self.d_ff_kept is None else self.d_ff_kept

    @property
    def eff_dense_d_ff(self) -> Optional[int]:
        """Hidden dim of the ``first_k_dense`` layers' MLPs (pruned or
        not), None without them."""
        if self.dense_d_ff is None:
            return None
        return self.dense_d_ff_kept or self.dense_d_ff

    @property
    def eff_d_expert(self) -> int:
        assert self.moe is not None
        return self.moe.d_expert if self.d_ff_kept is None else self.d_ff_kept

    @property
    def eff_num_experts(self) -> int:
        assert self.moe is not None
        return self.moe.num_experts if self.experts_kept is None \
            else self.experts_kept

    @property
    def qk_full(self) -> int:
        """Full (unpruned) per-head qk dim; prunable part only for MLA (nope)."""
        if self.mla is not None:
            return self.mla.qk_nope_dim
        return self.d_head

    @property
    def eff_qk(self) -> int:
        return self.qk_full if self.qk_kept is None else self.qk_kept

    @property
    def eff_d_inner(self) -> int:
        """Mamba inner channels (pruned or not)."""
        assert self.mamba is not None
        full = self.mamba.expand * self.d_model
        return full if self.d_inner_kept is None else self.d_inner_kept

    @property
    def padded_vocab(self) -> int:
        r = self.vocab_round
        return ((self.vocab_size + r - 1) // r) * r

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Mixer kind for every layer (pattern cycled over depth)."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None or i < self.first_k_dense:
            return False
        return i % self.moe_every == self.moe_every - 1

    def layer_spec(self, i: int) -> Tuple[str, bool]:
        """(mixer kind, is_moe) for absolute layer index i."""
        return (self.layer_kinds[i], self.layer_is_moe(i))

    @property
    def has_attention(self) -> bool:
        return any(k in ("attn", "swa") for k in self.layer_kinds) \
            or self.n_enc_layers > 0

    def layout(self):
        """Depth layout, as the JAX package stacks layer params.

        Returns a list of segments; each segment is ``("unroll", [abs_idx])``
        or ``("scan", n_reps, [abs_idx of first rep's layers])`` where every
        rep of a scanned segment has identical per-position layer specs.
        A scanned segment's params and cache leaves carry a leading
        ``n_reps`` axis (``seg<i>/p<j>``); unrolled layers are ``seg<i>/l<j>``.
        Fewer layers than one period (after the ``first_k_dense`` ones)
        unroll: the layout the reference reaches with no full period if
        its period check did not read past the last layer.
        """
        L = self.n_layers
        segs = []
        start = 0
        if self.first_k_dense > 0:
            segs.append(("unroll", list(range(self.first_k_dense))))
            start = self.first_k_dense
        p = len(self.pattern)
        if self.moe is not None:
            p = math.lcm(p, self.moe_every)
        rem = L - start
        if rem < p:
            if rem > 0:
                segs.append(("unroll", list(range(start, L))))
            return segs

        # period must reproduce identical (kind, moe) specs across reps
        def specs_ok(period: int) -> bool:
            base = [self.layer_spec(start + j) for j in range(period)]
            for r in range(1, rem // period):
                for j in range(period):
                    if self.layer_spec(start + r * period + j) != base[j]:
                        return False
            return True
        while p > 1 and not specs_ok(p):
            p += 1
        n_full = rem // p
        if n_full > 0:
            segs.append(("scan", n_full, list(range(start, start + p))))
        tail_start = start + n_full * p
        if tail_start < L:
            segs.append(("unroll", list(range(tail_start, L))))
        return segs

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # CORP helpers -----------------------------------------------------------
    def pruned(self, mlp_sparsity: float = 0.0, attn_sparsity: float = 0.0,
               round_to: int = 1,
               expert_sparsity: float = 0.0) -> "ModelConfig":
        """Config after CORP pruning at the given sparsities.

        ``expert_sparsity`` removes whole routed experts (MoE configs
        only); the kept count never drops below ``top_k`` so routing stays
        well-defined.
        """
        def keep(full: int, s: float, rt: int = round_to) -> int:
            k = int(round(full * (1.0 - s)))
            if rt > 1:
                k = max(rt, (k // rt) * rt)
            return max(1, min(full, k))

        kw = {}
        if mlp_sparsity > 0:
            full_ff = self.moe.d_expert if self.moe is not None else self.d_ff
            kw["d_ff_kept"] = keep(full_ff, mlp_sparsity)
            if self.dense_d_ff:
                kw["dense_d_ff_kept"] = keep(self.dense_d_ff, mlp_sparsity)
            if self.mamba is not None:
                kw["d_inner_kept"] = keep(self.mamba.expand * self.d_model,
                                          mlp_sparsity)
        if attn_sparsity > 0 and self.has_attention:
            # rope archs prune whole rotary pairs (repro.core.solve)
            pairwise = self.family == "lm" and self.rwkv is None \
                and self.mla is None
            if pairwise:
                kept_pairs = keep(self.qk_full // 2, attn_sparsity,
                                  max(1, round_to // 2))
                kw["qk_kept"] = 2 * kept_pairs
            else:
                kw["qk_kept"] = keep(self.qk_full, attn_sparsity)
        if expert_sparsity > 0 and self.moe is not None:
            kw["experts_kept"] = max(self.moe.top_k,
                                     keep(self.moe.num_experts,
                                          expert_sparsity, 1))
        return self.replace(**kw) if kw else self
