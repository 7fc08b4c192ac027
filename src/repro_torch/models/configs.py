"""Unified model configuration for every architecture family the framework serves.

A single ``ModelConfig`` describes dense, MoE, SSM (Mamba2), hybrid
(Mamba2 + shared attention), encoder-decoder (Whisper-style) and VLM
(vision-stub + LLM) architectures.  The elastic-inference component
(the elastic package) derives runtime variants from the same config via the
paper's compression operators; the analytic cost helpers here feed the
runtime performance profiler (paper Eq. 1 / Eq. 2).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

# Block kinds used in ``block_pattern``.
ATTN = "attn"          # global self-attention + FFN
LOCAL = "local_attn"   # sliding-window self-attention + FFN
MAMBA = "mamba"        # Mamba2 (SSD) block
SHARED_ATTN = "shared_attn"  # hybrid: shared-weight attention block (Zamba2)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    qkv_bias: bool = False
    gated_ffn: bool = True              # SwiGLU/GeGLU vs plain MLP
    activation: str = "silu"            # silu | gelu
    tie_embeddings: bool = True

    # --- attention pattern -------------------------------------------------
    sliding_window: int = 0             # window size for LOCAL blocks
    local_global_ratio: int = 0         # gemma3-style N local : 1 global
    rope_theta: float = 10000.0

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_shared_expert: bool = False     # llama4-style shared expert
    router_aux_weight: float = 0.01

    # --- SSM (Mamba2 / SSD) -------------------------------------------------
    ssm_state_dim: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    ssm_ngroups: int = 1

    # --- hybrid (Zamba2) ----------------------------------------------------
    shared_attn_period: int = 0         # apply shared attn block every N blocks

    # --- encoder-decoder (Whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 1500         # whisper: 30s of audio at 50 fps

    # --- VLM ------------------------------------------------------------------
    vision_embed_dim: int = 0           # stub vision encoder output width
    num_vision_tokens: int = 0

    # --- numerics -------------------------------------------------------------
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    max_seq_len: int = 131072
    norm_eps: float = 1e-6

    # elastic-inference applicability notes (DESIGN.md §Arch-applicability)
    inapplicable_operators: Tuple[str, ...] = ()
    source: str = ""                    # citation for the config

    # ------------------------------------------------------------------ derived
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def ssm_conv_dim(self) -> int:
        # channels that go through the causal conv: x, B, C
        return self.ssm_d_inner + 2 * self.ssm_ngroups * self.ssm_state_dim

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding/LM head shard
        evenly over a 16-way model axis (MaxText-style vocab padding)."""
        return (self.vocab_size + 255) // 256 * 256

    def block_pattern(self) -> Tuple[str, ...]:
        """Per-layer block kinds.  Homogeneous stacks collapse to one kind."""
        if self.arch_type == "ssm":
            return tuple([MAMBA] * self.num_layers)
        if self.arch_type == "hybrid":
            pat = []
            for i in range(self.num_layers):
                pat.append(MAMBA)
                if self.shared_attn_period and (i + 1) % self.shared_attn_period == 0:
                    pat.append(SHARED_ATTN)
            return tuple(pat)
        if self.local_global_ratio:
            # gemma3: N local then 1 global, repeating
            pat = []
            for i in range(self.num_layers):
                if (i + 1) % (self.local_global_ratio + 1) == 0:
                    pat.append(ATTN)
                else:
                    pat.append(LOCAL)
            return tuple(pat)
        return tuple([ATTN] * self.num_layers)

    # ------------------------------------------------------------ cost model
    def param_count(self) -> int:
        """Total parameter count (embedding included once if tied)."""
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
        per_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            per_attn += self.q_dim + 2 * self.kv_dim
        ffn_mats = 3 if self.gated_ffn else 2
        per_ffn = ffn_mats * d * f
        norms = 2 * d
        n = 0
        if self.arch_type in ("dense", "audio", "vlm"):
            n += self.num_layers * (per_attn + per_ffn + norms)
        elif self.arch_type == "moe":
            experts = self.num_experts + (1 if self.moe_shared_expert else 0)
            router = d * self.num_experts
            n += self.num_layers * (per_attn + experts * per_ffn + router + norms)
        elif self.arch_type == "ssm":
            n += self.num_layers * self._mamba_block_params()
        elif self.arch_type == "hybrid":
            n += self.num_layers * self._mamba_block_params()
            n += per_attn + per_ffn + norms  # ONE shared attention block
        if self.is_encoder_decoder:
            # encoder self-attn+ffn, decoder adds cross-attn
            n += self.encoder_layers * (per_attn + per_ffn + norms)
            n += self.num_layers * per_attn  # cross attention
        if self.vision_embed_dim:
            n += self.vision_embed_dim * d  # projector
        n += self.vocab_size * d  # embedding (tied with lm head)
        if not self.tie_embeddings:
            n += self.vocab_size * d
        n += d  # final norm
        return int(n)

    def _mamba_block_params(self) -> int:
        d, di = self.d_model, self.ssm_d_inner
        nh, st = self.ssm_num_heads, self.ssm_state_dim
        in_proj = d * (2 * di + 2 * self.ssm_ngroups * st + nh)
        conv = self.ssm_conv_dim * self.ssm_conv_width + self.ssm_conv_dim
        extras = 3 * nh          # A_log, D, dt_bias
        out_proj = di * d
        norm = di + d            # gated RMSNorm + pre-norm
        return in_proj + conv + extras + out_proj + norm

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.arch_type != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        ffn_mats = 3 if self.gated_ffn else 2
        per_ffn = ffn_mats * d * f
        active_experts = self.experts_per_token + (1 if self.moe_shared_expert else 0)
        per_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        router = d * self.num_experts
        n = self.num_layers * (per_attn + active_experts * per_ffn + router + 2 * d)
        n += self.vocab_size * d + d
        return int(n)

    def flops_per_token(self, seq_len: int, decode: bool = False) -> float:
        """Approximate forward FLOPs per token (2*MACs), incl. attention.

        ``decode=True``: one new token attending to a cache of ``seq_len``.
        """
        hd = self.resolved_head_dim
        mm = 2.0 * self.active_param_count()  # weight matmuls (fwd)
        attn = 0.0
        pattern = self.block_pattern()
        for kind in pattern:
            if kind in (ATTN, LOCAL, SHARED_ATTN):
                ctx = seq_len if kind != LOCAL else min(seq_len, max(self.sliding_window, 1))
                if decode:
                    span = ctx if kind == LOCAL else seq_len
                    attn += 2.0 * 2.0 * self.num_heads * hd * span
                else:
                    attn += 2.0 * 2.0 * self.num_heads * hd * (ctx / 2.0 if kind != LOCAL else ctx)
            elif kind == MAMBA:
                # SSD: per-token state update ~ nh*hd*state MACs * few
                attn += 2.0 * 6.0 * self.ssm_num_heads * self.ssm_head_dim * self.ssm_state_dim
        return mm + attn

    def kv_cache_bytes(self, batch: int, seq_len: int, dtype_bytes: int = 2) -> int:
        n_attn = sum(1 for k in self.block_pattern() if k in (ATTN, LOCAL, SHARED_ATTN))
        kv = 2 * n_attn * batch * seq_len * self.kv_dim * dtype_bytes
        n_mamba = sum(1 for k in self.block_pattern() if k == MAMBA)
        ssm = n_mamba * batch * (
            self.ssm_num_heads * self.ssm_head_dim * self.ssm_state_dim
            + self.ssm_conv_dim * (self.ssm_conv_width - 1)
        ) * 4
        return int(kv + ssm)

    def with_updates(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------------------------------------------------------- elastic hooks
    def reduced(self, num_layers: int = 2, d_model: int = 256,
                max_experts: int = 4) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests."""
        ratio = d_model / self.d_model
        nh = max(2, int(self.num_heads * ratio)) if self.num_heads else 0
        nkv = max(1, min(self.num_kv_heads, nh)) if self.num_kv_heads else 0
        if nh and nh % nkv:
            nkv = 1
        kw = dict(
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=(d_model // nh) if nh else 0,
            d_ff=(max(64, int(round(self.d_ff * ratio / 64)) * 64)
                  if self.d_ff else 0),
            vocab_size=min(self.vocab_size, 1024),
            max_seq_len=4096,
        )
        if self.num_experts:
            kw["num_experts"] = min(self.num_experts, max_experts)
            kw["experts_per_token"] = min(self.experts_per_token, kw["num_experts"])
        if self.ssm_state_dim:
            kw["ssm_state_dim"] = min(self.ssm_state_dim, 32)
            kw["ssm_head_dim"] = 32
        if self.is_encoder_decoder:
            kw["encoder_layers"] = num_layers
            kw["encoder_seq_len"] = 64
        if self.vision_embed_dim:
            kw["vision_embed_dim"] = 128
            kw["num_vision_tokens"] = 4
        if self.sliding_window:
            kw["sliding_window"] = 64
        if self.shared_attn_period:
            kw["shared_attn_period"] = 1
        return self.with_updates(**kw)


@dataclass(frozen=True)
class InputShape:
    """One of the assigned workload shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def tokens_per_step(shape: InputShape) -> int:
    if shape.is_decode:
        return shape.global_batch  # one new token per sequence
    return shape.global_batch * shape.seq_len
