"""Threefry-2x32 key splitting and Gumbel sampling in integer torch ops.

Reproduces the JAX package's ``jax.random`` streams for raw
``(..., 2)`` threefry keys with ``jax_threefry_partitionable=True`` (the
default of JAX 0.9): :func:`split` and :func:`random_bits` give the same
bits, :func:`uniform` the same floats, and :func:`categorical` the same
draws from the same key and logits.  torch has no unsigned 32-bit
arithmetic, so words are held in ``int64`` tensors and masked to 32 bits
after every add and shift.  Keys are ``int64`` tensors whose two last-axis
entries are the key's two uint32 words.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) on broadcastable int64
    words; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) keys -> (..., num, 2) keys; key i
    is threefry(key, (0, i))."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          torch.zeros_like(counts), counts)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element of a length-``n`` draw for each key of
    ``(..., 2)``: (..., n) int64 in [0, 2**32)."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          torch.zeros_like(counts), counts)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits fill the
    mantissa of a float in [1, 2), shifted and scaled to [minval, maxval)."""
    bits = random_bits(key, n)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # filled on the device (no host copy), so sampling can be graph-captured
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` (low mode) in float32."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, n, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: argmax of Gumbel
    noise plus logits (ties keep the lowest index)."""
    g = gumbel(key, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)
