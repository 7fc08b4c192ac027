"""Attention for the prefill path: GQA projection, full and chunked
attention.

The JAX package picks ``full`` for prompt buckets up to 1024 tokens and
``chunked`` above (``transformer._select_impl``).  On the card both go
through the flash kernel (:func:`repro_torch.kernels.ops.attention`),
which computes the same function with bounded memory; on the CPU they
run as the plain ``full_attention`` and ``chunked_attention`` below, as
the JAX package runs them.  ``banded`` is not ported yet.  Decode
attention on the serving path reads the paged pool through
:func:`repro_torch.kernels.ops.paged_attention`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import ops as kernel_ops
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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 512, k_chunk: int = 1024
                      ) -> torch.Tensor:
    """Online-softmax attention with bounded memory.

    Loops over query chunks (outer) and KV chunks (inner), keeping the
    running max / denominator, so the (Sq x Sk) score matrix is never
    materialized.  q: (B,Sq,H,hd); k,v: (B,Sk,K,hd)."""
    b, sq, h, hd = q.shape
    sk, kheads = k.shape[1], k.shape[2]
    g = h // kheads
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, sk)
    if sq % q_chunk or sk % k_chunk:
        raise ValueError(f"chunks ({q_chunk}, {k_chunk}) do not divide "
                         f"({sq}, {sk})")
    scale = 1.0 / math.sqrt(hd)
    qg = _group(q, kheads).float()
    kf, vf = k.float(), v.float()
    chunks = []
    for q0 in range(0, sq, q_chunk):
        qi = qg[:, q0:q0 + q_chunk]
        row = torch.arange(q0, q0 + q_chunk, device=q.device)
        m = torch.full((b, kheads, g, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((b, kheads, g, q_chunk), device=q.device)
        acc = torch.zeros((b, kheads, g, q_chunk, hd), device=q.device)
        for k0 in range(0, sk, k_chunk):
            col = torch.arange(k0, k0 + k_chunk, device=q.device)
            s = torch.einsum("bqkgh,bskh->bkgqs", qi,
                             kf[:, k0:k0 + k_chunk]) * scale
            mask = torch.ones((q_chunk, k_chunk), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= row[:, None] >= col[None, :]
            if window:
                mask &= col[None, :] > row[:, None] - window
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p, vf[:, k0:k0 + k_chunk])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        chunks.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, hd))
    return torch.cat(chunks, dim=1).to(q.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            impl: str, causal: bool, window: int, q_chunk: int,
            k_chunk: int) -> torch.Tensor:
    """The attention core of a prefill block: q (B,S,H,hd), k/v
    (B,S,K,hd) after rotary -> (B,S,H,hd), picked as the JAX
    ``attention_block`` picks it."""
    s = q.shape[1]
    if impl == "banded" and window:
        raise NotImplementedError("attention impl 'banded' is not ported "
                                  "yet")
    if q.device.type != "cpu":
        # full and chunked alike: the flash kernel reads the tensors in
        # place through (B,H,S,hd) views; its output's transpose is
        # contiguous
        out = kernel_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window)
        return out.transpose(1, 2)
    if impl == "chunked" and s > q_chunk:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk, k_chunk=min(k_chunk, s))
    return full_attention(q, k, v, causal=causal, window=window)


def self_attention(params: Params, x: torch.Tensor, *, num_heads: int,
                   num_kv_heads: int, head_dim: int, rope_theta: float,
                   causal: bool = True, window: int = 0,
                   impl: str = "full", q_chunk: int = 512,
                   k_chunk: int = 1024,
                   positions: Optional[torch.Tensor] = None):
    """Self-attention over a sequence.  Returns ``(y, k, v)``: the block
    output and the rotated keys / values the prefill caches."""
    b, s, _ = x.shape
    q, k, v = qkv_project(params, x, num_heads, num_kv_heads, head_dim)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    sin, cos = rotary_embedding(positions, head_dim, rope_theta)
    q = apply_rotary(q, sin, cos)
    k = apply_rotary(k, sin, cos)
    out = _attend(q, k, v, impl=impl, causal=causal, window=window,
                  q_chunk=q_chunk, k_chunk=k_chunk)
    y = matmul_w(out.reshape(b, s, num_heads * head_dim), params["wo"])
    return y, k, v


def attention_block(params: Params, x: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int, rope_theta: float,
                    causal: bool = True, window: int = 0,
                    impl: str = "chunked", q_chunk: int = 512,
                    k_chunk: int = 1024,
                    positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Self-attention over a full sequence (prefill path)."""
    y, _, _ = self_attention(params, x, num_heads=num_heads,
                             num_kv_heads=num_kv_heads, head_dim=head_dim,
                             rope_theta=rope_theta, causal=causal,
                             window=window, impl=impl, q_chunk=q_chunk,
                             k_chunk=k_chunk, positions=positions)
    return y
