"""Intermediate activation compression (paper §III-C2 ❼).

Per-block symmetric quantization of activations / KV-cache entries to
int8 or packed int4, with f32 scales, along the last axis in blocks of
``BLOCK`` elements; a short last block is zero-padded (zeros change no
absmax).  The same codec as the JAX package's ``engine/act_compress``:
equal codes, packed bytes and scales.

Every function reshapes its ``(..., n)`` input to rows and calls the
kernels' wrappers (:mod:`repro_torch.kernels.act_quant`): a tensor on
the card launches the hand-written kernel (int8: K4, int4: K5), a
tensor on the CPU takes the plain version.  The kernels take rows of
any length, so a ragged ``n`` needs no padding copy; int4 packs the
padded row, so its packed width is ``ceil(n / BLOCK) * BLOCK / 2``
bytes and every padded byte is ``0x88``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.act_quant import (act_dequant, act_dequant4,
                                           act_quant, act_quant4)

BLOCK = 128


def _rows(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    return x.reshape(-1, x.shape[-1]), tuple(x.shape[:-1])


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8: returns (q (..., n), scales (...,
    ceil(n/BLOCK)))."""
    rows, lead = _rows(x)
    q, s = act_quant(rows)
    return q.reshape(lead + q.shape[-1:]), s.reshape(lead + s.shape[-1:])


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    rows, lead = _rows(q)
    out = act_dequant(rows, scale.reshape(-1, scale.shape[-1]), dtype)
    return out.reshape(lead + out.shape[-1:])


def quantize_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int4 packed two-per-byte (uint8 storage):
    returns (packed (..., ceil(n/BLOCK) * BLOCK/2), scales (...,
    ceil(n/BLOCK)))."""
    rows, lead = _rows(x)
    packed, s = act_quant4(rows)
    return (packed.reshape(lead + packed.shape[-1:]),
            s.reshape(lead + s.shape[-1:]))


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor, n: int,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    rows, lead = _rows(packed)
    out = act_dequant4(rows, scale.reshape(-1, scale.shape[-1]), dtype, n=n)
    return out.reshape(lead + out.shape[-1:])


def compressed_bytes(x_shape: Tuple[int, ...], bits: int) -> int:
    n = 1
    for s in x_shape:
        n *= s
    payload = n * bits // 8
    scales = (n // BLOCK) * 4
    return payload + scales


def compression_error(x: torch.Tensor, bits: int = 8) -> float:
    """Relative L2 reconstruction error (profiler accuracy-impact proxy)."""
    if bits == 8:
        q, s = quantize_int8(x)
        y = dequantize_int8(q, s, torch.float32)
    else:
        q, s = quantize_int4(x)
        y = dequantize_int4(q, s, x.shape[-1], torch.float32)
    x = x.float()
    return float(_norm(x - y) / (_norm(x) + 1e-9))


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The L2 norm as ``jnp.linalg.norm`` computes it, sqrt(sum(x * x)):
    ``torch.sum`` keeps f32 sums accurate over millions of terms, which
    ``torch.linalg.vector_norm`` does not on the CPU."""
    return torch.sqrt(torch.sum(x * x))
