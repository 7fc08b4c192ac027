"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each ``*_ref`` function computes what its kernel computes, in plain
tensor ops.  The wrappers in :mod:`repro_torch.kernels.ops` take it for
tensors on the CPU; on the card it is what a kernel is held against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def paged_decode_attn_ref(q: torch.Tensor, k_blocks: torch.Tensor,
                          v_blocks: torch.Tensor, tables: torch.Tensor,
                          pos: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, *,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          window: int = 0) -> torch.Tensor:
    """Single-query GQA attention over a paged KV pool.

    q: (slots, H, hd); k/v_blocks: (num_blocks, bs, kvh, hd) — ONE layer's
    pool slice (any block stride); tables: (slots, mb) int32 block ids;
    pos: (slots,) — the number of tokens already in the pool (pool columns
    < pos are valid); k_new/v_new: (slots, kvh, hd) — the current token's
    KV, folded in as an always-valid extra key (it has NOT been scattered
    into the pool yet).  Optional k/v_scale: (num_blocks, bs) f32 per-row
    int8 scales.  ``window`` keeps pool columns > pos - window (the new
    token is position ``pos``, so with window w the valid set is
    (pos-w, pos]).  Returns (slots, H, hd) in q.dtype."""
    slots, h, hd = q.shape
    _, bs, kvh, _ = k_blocks.shape
    mb = tables.shape[1]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    idx = tables.long()
    kf = k_blocks[idx].float().reshape(slots, mb * bs, kvh, hd)
    vf = v_blocks[idx].float().reshape(slots, mb * bs, kvh, hd)
    if k_scale is not None:
        kf = kf * k_scale[idx].reshape(slots, mb * bs, 1, 1)
        vf = vf * v_scale[idx].reshape(slots, mb * bs, 1, 1)
    cols = torch.arange(mb * bs, device=q.device)
    p = pos.long()[:, None]
    valid = cols[None, :] < p
    if window:
        valid &= cols[None, :] > p - window
    kf = torch.cat([kf, k_new.float()[:, None]], dim=1)
    vf = torch.cat([vf, v_new.float()[:, None]], dim=1)
    valid = torch.cat([valid, torch.ones((slots, 1), dtype=torch.bool,
                                         device=q.device)], dim=1)
    qg = q.float().reshape(slots, kvh, g, hd) * scale
    s = torch.einsum("bkgh,bskh->bkgs", qg, kf)
    s = s.masked_fill(~valid[:, None, None, :], -1e30)
    p_attn = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p_attn, vf)
    return out.reshape(slots, h, hd).to(q.dtype)


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": torch.nn.functional.silu,
            "gelu": lambda t: torch.nn.functional.gelu(
                t, approximate="tanh")}[name]


def fused_ffn_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, activation: str = "silu"
                  ) -> torch.Tensor:
    """Gated FFN ``(act(x @ w_gate) * (x @ w_up)) @ w_down``.

    x: (M, D); w_gate/w_up: (D, F); w_down: (F, D).  Computed in f32 and
    rounded once to x's dtype; ``activation`` is silu or tanh-gelu."""
    xf = x.float()
    h = _act(activation)(xf @ w_gate.float()) * (xf @ w_up.float())
    return (h @ w_down.float()).to(x.dtype)


def flash_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   kv_len: Optional[int] = None) -> torch.Tensor:
    """Attention with the flash kernel's masks.

    q, k, v: (B, H, S, hd), KV heads already broadcast to the query
    heads.  Keys are masked by ``causal`` (col <= row), ``window``
    (col > row - window) and ``kv_len`` (col < kv_len).  A query row with
    no valid key outputs exactly zero.  f32 inside, out in q's dtype."""
    s, hd = q.shape[-2:]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window:
        mask &= cols > rows - window
    if kv_len is not None:
        mask &= cols < kv_len
    scores = scores.masked_fill(~mask, -1e30)
    p = torch.softmax(scores, dim=-1) * mask.any(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
