"""Model configuration schema for every assigned architecture family.

One :class:`ModelConfig` describes a decoder-only LM whose layers follow a
repeating *pattern* of block kinds (DESIGN.md §4):

  * ``"attn"``    — global GQA attention block
  * ``"local"``   — sliding-window GQA attention block
  * ``"mamba"``   — Mamba-1 selective-SSM block (attention-free)
  * ``"xattn"``   — cross-attention block (VLM: text queries → vision kv)

and whose feed-forward half is dense or MoE per a second repeating pattern.
``layer_pattern`` is cycled over ``n_layers``; homogeneous repeats of the
full period are stacked, and the backbone loops over the repeats.

A copy of ``repro.models.config``: the port may not import the JAX
package, whose ``repro.models`` package imports ``jax``. Keep the two
diffable; ``tests/test_torch_models.py`` checks every config field-equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Resolved spec of one layer position inside the repeating period."""

    mixer: str        # attn | local | mamba | xattn
    moe: bool         # MoE FF (else dense FF)

    @property
    def is_attention(self) -> bool:
        return self.mixer in ("attn", "local", "xattn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity ---------------------------------------------------------------
    name: str = "model"
    family: str = "dense"         # dense | moe | ssm | hybrid | vlm | audio

    # -- trunk ------------------------------------------------------------------
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0             # 0 → d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"             # silu | gelu
    use_bias: bool = False
    tie_embeddings: bool = False
    scale_embeddings: bool = False    # gemma-style sqrt(d_model) embed scale
    sandwich_norm: bool = False       # gemma2 post-block norms

    # -- attention features -------------------------------------------------------
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0           # stablelm2: 0.25
    qk_norm: bool = False             # qwen3
    attn_logit_softcap: float = 0.0   # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    sliding_window: int = 0           # window for "local" mixers / SWA
    attn_chunk: int = 1024            # kv-chunk for online-softmax attention

    # -- layer pattern --------------------------------------------------------------
    layer_pattern: Tuple[str, ...] = ("attn",)
    moe_period: int = 0               # every p-th layer is MoE (0 = never)
    moe_offset: int = 1               # which residue of the period is MoE
    first_k_dense: int = 0            # leading dense (non-MoE, non-scanned) layers
    first_dense_d_ff: int = 0         # d_ff of those leading layers (0 → d_ff)

    # -- MoE ---------------------------------------------------------------------
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_d_ff: int = 0                 # expert hidden dim (0 → d_ff)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3

    # -- SSM (Mamba-1) --------------------------------------------------------------
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0              # 0 → ceil(d_model / 16)
    ssm_chunk: int = 256              # seq chunk for the scan

    # -- modality frontends (stubs; see repro.models.frontends) ----------------------
    cross_attn_period: int = 0        # vlm: every p-th layer is xattn
    n_vision_tokens: int = 0

    # -- numerics -------------------------------------------------------------------
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"      # master param dtype

    # ---------------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    # -- derived -----------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def period(self) -> int:
        """Length of the repeating block period (layer pattern ∪ moe/xattn
        periods folded in)."""
        p = len(self.layer_pattern)
        if self.moe_period:
            p = _lcm(p, self.moe_period)
        if self.cross_attn_period:
            p = _lcm(p, self.cross_attn_period)
        return p

    @property
    def n_scanned(self) -> int:
        return self.n_layers - self.first_k_dense

    @property
    def n_repeats(self) -> int:
        if self.n_scanned % self.period != 0:
            raise ValueError(
                f"{self.name}: scanned layers {self.n_scanned} not divisible "
                f"by period {self.period}")
        return self.n_scanned // self.period

    def block_spec(self, layer_idx: int) -> BlockSpec:
        """Spec of absolute layer ``layer_idx`` (0-based, incl. leading dense)."""
        if layer_idx < self.first_k_dense:
            return BlockSpec(mixer=self.layer_pattern[0], moe=False)
        i = layer_idx - self.first_k_dense
        mixer = self.layer_pattern[i % len(self.layer_pattern)]
        if self.cross_attn_period and (i % self.cross_attn_period
                                       == self.cross_attn_period - 1):
            mixer = "xattn"
        moe = bool(self.n_experts) and bool(self.moe_period) and (
            i % self.moe_period == self.moe_offset % self.moe_period)
        return BlockSpec(mixer=mixer, moe=moe)

    def period_specs(self) -> List[BlockSpec]:
        """Specs of the scanned period (length ``period``)."""
        return [self.block_spec(self.first_k_dense + i)
                for i in range(self.period)]

    @property
    def has_attention(self) -> bool:
        return any(s.is_attention for s in
                   [self.block_spec(i) for i in range(self.n_layers)])

    @property
    def subquadratic(self) -> bool:
        """True if decode state is bounded (no full-seq dense KV): every
        attention layer is sliding-window, or the arch is (mostly) SSM."""
        specs = [self.block_spec(i) for i in range(self.n_layers)]
        return all(s.mixer in ("mamba", "local", "xattn")  # xattn kv is
                   for s in specs)                         # O(n_vision_tokens)

    @property
    def supports_long_decode(self) -> bool:
        """Whether the ``long_500k`` shape applies: bounded decode state
        (sub-quadratic) or an SSM/hybrid arch whose rare full-attn layers
        cost O(S) per decoded token (DESIGN.md §4 skip table)."""
        return self.subquadratic or self.family in ("ssm", "hybrid")

    # -- parameter counting (MODEL_FLOPS for §Roofline) ------------------------------
    def param_counts(self) -> Dict[str, float]:
        """Analytic parameter counts: total and active-per-token."""
        d, hd = self.d_model, self.head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = float(emb)
        active = float(emb)
        for i in range(self.n_layers):
            s = self.block_spec(i)
            if s.mixer in ("attn", "local", "xattn"):
                mix = d * q + 2 * d * kv + q * d
            else:  # mamba
                di, n, r = self.d_inner, self.ssm_state, self.dt_rank
                mix = (d * 2 * di + di * self.ssm_conv + di * (r + 2 * n)
                       + r * di + di * n + di + d * di)
            if s.moe:
                e_ff = self.expert_d_ff
                ff_tot = self.n_experts * 3 * d * e_ff + d * self.n_experts
                ff_act = ((self.n_experts_per_tok + self.n_shared_experts)
                          * 3 * d * e_ff + d * self.n_experts)
                if self.n_shared_experts:
                    ff_tot += self.n_shared_experts * 3 * d * e_ff
            else:
                dff = (self.first_dense_d_ff or self.d_ff) \
                    if i < self.first_k_dense else self.d_ff
                ff_tot = ff_act = 3 * d * dff
            total += mix + ff_tot
            active += mix + ff_act
        return {"total": total, "active": active}


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)
