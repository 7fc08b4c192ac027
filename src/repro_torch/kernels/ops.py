"""Dispatch from the model code to the port's kernels.

The JAX package chose between its Pallas kernels and their ``ref.py``
oracles with ``RuntimeOptions.use_pallas``.  Here the tensor's device
decides: a tensor on the card launches the hand-written kernel, a tensor
on the CPU takes the plain version.  There is no fallback from the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attn import flash_attention
from .fused_ffn import fused_ffn
from .paged_decode_attn import paged_decode_attention


def gated_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    """``(act(x @ w_gate) * (x @ w_up)) @ w_down``, f32 inside.

    x: (M, D); w_gate/w_up: (D, F); w_down: (F, D).  The device of ``x``
    picks the fused kernel or its plain version."""
    return fused_ffn(x, w_gate, w_up, w_down, activation)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, K, S, hd) with K dividing H — K == H
    is the JAX package's pre-broadcast layout, K < H reads grouped KV
    heads with no broadcast copy.  The device of ``q`` picks the flash
    kernel or its plain version."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           kv_len=kv_len)


def paged_attention(q: torch.Tensor, k_blocks: torch.Tensor,
                    v_blocks: torch.Tensor, tables: torch.Tensor,
                    pos: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    window: int = 0) -> torch.Tensor:
    """Single-query decode attention straight off a BlockPool table.

    q: (slots, H, hd); k/v_blocks: (num_blocks, bs, kvh, hd);
    tables: (slots, mb) int32 runtime data; pos: (slots,) resident tokens;
    k/v_new: (slots, kvh, hd) current-token KV (not yet scattered);
    k/v_scale: optional (num_blocks, bs) per-row int8 scales.  The JAX
    package's ``use_pallas``/``interpret`` flags have no counterpart: the
    device of ``q`` picks the kernel or its plain version."""
    return paged_decode_attention(q, k_blocks, v_blocks, tables, pos, k_new,
                                  v_new, k_scale=k_scale, v_scale=v_scale,
                                  window=window)
