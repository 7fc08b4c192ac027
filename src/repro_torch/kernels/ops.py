"""Dispatch from the model code to the port's kernels.

The JAX package chose between its Pallas kernels and their ``ref.py``
oracles with ``RuntimeOptions.use_pallas``.  Here the tensor's device
decides: a tensor on the card launches the hand-written kernel, a tensor
on the CPU takes the plain version.  There is no fallback from the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from .act_quant import act_dequant, act_quant
from .flash_attn import flash_attention
from .fused_ffn import fused_ffn
from .paged_decode_attn import paged_decode_attention
from .ssd_scan import ssd_scan

__all__ = ["quantize_activations", "dequantize_activations", "gated_ffn",
           "attention", "paged_attention", "ssd", "ssd_scan"]


def quantize_activations(x: torch.Tensor):
    """Blockwise int8: x (M, N) f32/bf16 with ``N % 128 == 0`` -> (codes
    int8 (M, N), scales f32 (M, N/128)).  The JAX package's
    ``use_pallas``/``interpret`` flags have no counterpart: the device of
    ``x`` picks the kernel or its plain version."""
    assert x.dim() == 2 and x.shape[1] % 128 == 0, tuple(x.shape)
    return act_quant(x)


def dequantize_activations(q: torch.Tensor, scales: torch.Tensor,
                           out_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """Inverse of :func:`quantize_activations`: codes int8 (M, N), scales
    f32 (M, N/128) -> (M, N) in ``out_dtype``."""
    assert q.dim() == 2 and q.shape[1] % 128 == 0, tuple(q.shape)
    return act_dequant(q, scales, out_dtype)


def gated_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    """``(act(x @ w_gate) * (x @ w_up)) @ w_down``, f32 inside.

    x: (M, D); w_gate/w_up: (D, F); w_down: (F, D).  The device of ``x``
    picks the fused kernel or its plain version."""
    return fused_ffn(x, w_gate, w_up, w_down, activation)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, K, Sk, hd) with K dividing H — K == H
    is the JAX package's pre-broadcast layout, K < H reads grouped KV
    heads with no broadcast copy.  Sk != Sq (cross-attention) only
    without ``causal`` and ``window``.  The device of ``q`` picks the flash
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


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, chunk: int = 128):
    """Chunked SSD scan in the JAX package's kernel layout: x (BH, S, P),
    dt (BH, S), a (BH,), b, c (BH, S, N) — every row its own sequence and
    head, i.e. the model layout's view B = 1, H = G = BH.  Returns
    ``(y (BH, S, P) f32, final state (BH, P, N) f32)`` like the Pallas
    kernel (y as a view of the model layout's (1, S, BH, P) result).  The
    device of ``x`` picks the kernel or its plain version."""
    y, state = ssd_scan(x.transpose(0, 1)[None], dt.transpose(0, 1)[None],
                        a, b.transpose(0, 1)[None], c.transpose(0, 1)[None],
                        chunk=chunk, out_dtype=torch.float32)
    return y[0].transpose(0, 1), state[0]
