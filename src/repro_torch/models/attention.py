"""Attention for the prefill path: GQA projection and full attention.

Only the ``"full"`` implementation is ported so far; it is what the JAX
package selects for prompt buckets up to 1024 tokens.  Decode attention
on the serving path reads the paged pool through
:func:`repro_torch.kernels.ops.paged_attention`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .layers import Params, apply_rotary, matmul_w, rotary_embedding

NEG_INF = -1e30


def qkv_project(params: Params, x: torch.Tensor, num_heads: int,
                num_kv_heads: int, head_dim: int):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,K,hd)."""
    b, s, _ = x.shape
    q = matmul_w(x, params["wq"])
    k = matmul_w(x, params["wk"])
    v = matmul_w(x, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (q.reshape(b, s, num_heads, head_dim),
            k.reshape(b, s, num_kv_heads, head_dim),
            v.reshape(b, s, num_kv_heads, head_dim))


def _group(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,K,G,hd) for GQA einsums."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, num_kv_heads, h // num_kv_heads, hd)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   q_offset: int = 0) -> torch.Tensor:
    """Reference attention.  q: (B,Sq,H,hd); k,v: (B,Sk,K,hd)."""
    b, sq, h, hd = q.shape
    kheads = k.shape[2]
    qg = _group(q, kheads)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    rows = torch.arange(sq, device=q.device) + q_offset
    cols = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows[:, None] >= cols[None, :]
    if window:
        mask &= cols[None, :] > rows[:, None] - window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def self_attention(params: Params, x: torch.Tensor, *, num_heads: int,
                   num_kv_heads: int, head_dim: int, rope_theta: float,
                   causal: bool = True, window: int = 0,
                   positions: Optional[torch.Tensor] = None):
    """Full self-attention over a sequence.  Returns ``(y, k, v)``: the
    block output and the rotated keys / values the prefill caches."""
    b, s, _ = x.shape
    q, k, v = qkv_project(params, x, num_heads, num_kv_heads, head_dim)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    sin, cos = rotary_embedding(positions, head_dim, rope_theta)
    q = apply_rotary(q, sin, cos)
    k = apply_rotary(k, sin, cos)
    out = full_attention(q, k, v, causal=causal, window=window)
    y = matmul_w(out.reshape(b, s, num_heads * head_dim), params["wo"])
    return y, k, v


def attention_block(params: Params, x: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int, rope_theta: float,
                    causal: bool = True, window: int = 0,
                    impl: str = "full",
                    positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Self-attention over a full sequence (prefill path)."""
    if impl != "full":
        raise NotImplementedError(f"attention impl {impl!r} is not ported "
                                  "yet; only 'full'")
    y, _, _ = self_attention(params, x, num_heads=num_heads,
                             num_kv_heads=num_kv_heads, head_dim=head_dim,
                             rope_theta=rope_theta, causal=causal,
                             window=window, positions=positions)
    return y
