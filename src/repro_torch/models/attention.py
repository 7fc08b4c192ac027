"""Attention for the prefill path: GQA projection, full, chunked and
banded attention.

The JAX package picks ``full`` for prompt buckets up to 1024 tokens,
``chunked`` above, and ``banded`` for a sliding window over a prompt
longer than twice the window (``transformer._select_impl``).  On the
card all three go through the flash kernel
(:func:`repro_torch.kernels.ops.attention`), which computes the same
function with bounded memory and skips the key tiles outside the
window; on the CPU they run as the plain ``full_attention``,
``chunked_attention`` and ``banded_attention`` below, as the JAX package
runs them.  Decode attention reads the paged pool through
:func:`repro_torch.kernels.ops.paged_attention`, or a dense cache through
the plain :func:`decode_attention` (plain ``jnp`` in the JAX package
too).
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


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, q_chunk: int = 512) -> torch.Tensor:
    """Sliding-window causal attention with static KV slices.

    Each query chunk ``[r0, r0 + cq)`` attends to the ``window + cq``
    columns ending at its last row (K/V zero-padded in front, the pad
    masked), so the cost is O(S * (window + cq)) instead of O(S^2).
    q: (B,Sq,H,hd); k,v: (B,Sq,K,hd)."""
    b, sq, h, hd = q.shape
    kheads = k.shape[2]
    q_chunk = min(q_chunk, sq)
    if sq % q_chunk:
        raise ValueError(f"q_chunk {q_chunk} does not divide {sq}")
    span = window + q_chunk
    scale = 1.0 / math.sqrt(hd)
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, span, 0)).float()
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, span, 0)).float()
    qg = _group(q, kheads).float()
    chunks = []
    for r0 in range(0, sq, q_chunk):
        row = torch.arange(r0, r0 + q_chunk, device=q.device)
        # padded columns [r0 + cq, r0 + cq + span) are absolute
        # columns [r0 + cq - span, r0 + cq)
        start = r0 + q_chunk
        col = torch.arange(start - span, start, device=q.device)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg[:, r0:r0 + q_chunk],
                         kp[:, start:start + span]) * scale
        mask = (col[None, :] >= 0) & (row[:, None] >= col[None, :]) \
            & (col[None, :] > row[:, None] - window)
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqs,bskh->bqkgh", p, vp[:, start:start + span])
        chunks.append(out.reshape(b, q_chunk, h, hd))
    return torch.cat(chunks, dim=1).to(q.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            impl: str, causal: bool, window: int, q_chunk: int,
            k_chunk: int) -> torch.Tensor:
    """The attention core of a prefill block: q (B,S,H,hd), k/v
    (B,S,K,hd) after rotary -> (B,S,H,hd), picked as the JAX
    ``attention_block`` picks it."""
    s = q.shape[1]
    banded = impl == "banded" and bool(window)
    if q.device.type != "cpu":
        # full, chunked and banded (causal with the window) alike: the
        # flash kernel reads the tensors in place through (B,H,S,hd)
        # views; its output's transpose is contiguous
        out = kernel_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal or banded,
                                   window=window)
        return out.transpose(1, 2)
    if banded:
        return banded_attention(q, k, v, window=window,
                                q_chunk=min(q_chunk, s))
    if impl == "chunked" and s > q_chunk:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk, k_chunk=min(k_chunk, s))
    return full_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """One-token attention against a dense cache.

    q: (B, H, hd); caches: (B, S, K, hd); pos: a scalar or (B,) — the
    row of the current token, which the cache already holds.  Columns
    ``<= pos`` are attended; ``window > 0`` keeps the static-width
    window ending at ``pos`` that the JAX package slices (its start
    clipped to ``[0, S - window]``)."""
    b, h, hd = q.shape
    kheads, s_len = k_cache.shape[2], k_cache.shape[1]
    p = pos.reshape(-1, 1).expand(b, 1)
    cols = torch.arange(s_len, device=q.device)[None, :]
    mask = cols <= p
    if window and window < s_len:
        start = torch.clamp(p + 1 - window, 0, s_len - window)
        mask &= (cols >= start) & (cols < start + window)
    qg = q.reshape(b, kheads, h // kheads, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) \
        * (1.0 / math.sqrt(hd))
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    pos: torch.Tensor):
    """Insert one token per row, in place.  k_new/v_new: (B, K, hd); pos:
    a scalar or (B,), clamped to ``S - 1`` as ``dynamic_update_slice``
    clamps its start in the JAX package.  Returns the caches."""
    b, s_len = k_cache.shape[0], k_cache.shape[1]
    rows = torch.clamp(pos.reshape(-1).expand(b), max=s_len - 1).long()
    idx = torch.arange(b, device=k_cache.device)
    k_cache[idx, rows] = k_new.to(k_cache.dtype)
    v_cache[idx, rows] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


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
