"""Per-row int8 quantization for paged-KV storage (plain PyTorch).

The JAX package computes these outside any kernel too; the paged decode
kernel dequantizes inside its block loop with the scales made here.
"""
from __future__ import annotations

import torch


def kv_quant_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization.

    ``x``: (..., kvh, hd) — one KV row (one token, all kv heads) per
    leading index.  One f32 scale per row (amax over the trailing
    (kvh, hd)), ``scale = amax/127 + 1e-12``; codes round half to even.
    Returns (q int8 same shape, scale f32 with the last two dims gone)."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def kv_dequant_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`kv_quant_rows`: q (..., kvh, hd) int8 with
    per-row scale (...) -> (..., kvh, hd) in ``dtype``."""
    return (q.float() * scale[..., None, None]).to(dtype)
