"""Mamba2 (state-space duality) blocks: the chunked SSD scan and the O(1)
decode step.

Follows the JAX package's ``models/ssm.py`` (the SSD formulation of
arXiv:2405.21060).  The full-sequence block sends its scan through
:func:`repro_torch.kernels.ops.ssd_scan` — the SSD kernel on the card,
the plain :func:`ssd_scan_ref` on the CPU — and is differentiable on
both: under autograd the card's launch carries the gradient of the
plain version (``kernels.ssd_scan.ssd_scan_backward``).  The decode
step is plain tensor code in both packages.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops
from ..kernels.ref import segsum, ssd_scan_ref
from .configs import ModelConfig
from .layers import (Params, causal_conv1d, causal_conv1d_step,
                     gated_rms_norm, matmul_promote)

__all__ = ["segsum", "ssd_scan_ref", "ssd_step", "mamba_forward",
           "mamba_forward_states", "mamba_step", "mamba_state_shapes"]


def ssd_step(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
             a: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the SSD recurrence.

    state: (B, H, P, N) f32, updated in place; x_t: (B, H, P); dt_t: (B,
    H); b_t, c_t: (B, G, N).  Returns ``(y (B, H, P) in x_t's dtype,
    state)``.

    Heads are taken as (G, H/G) views of the state, so b and c broadcast
    over each group with no repeat, the decay and the outer product
    update the state with no (B, H, P, N) temporary, and the read-out is
    one batched product over (B·G) that reads the state in place — also
    the engine's slot-strided cache view, when G is 1."""
    bsz, h, p, n = state.shape
    g = b_t.shape[1]
    grouped = state.view(bsz, g, h // g, p, n)
    da = torch.exp(dt_t.float() * a.float())                # (B, H)
    xd = (x_t * dt_t[..., None]).float()                    # (B, H, P)
    grouped.mul_(da.view(bsz, g, h // g, 1, 1)).addcmul_(
        xd.view(bsz, g, h // g, p, 1), b_t.float()[:, :, None, None, :])
    y = torch.einsum("bgrpn,bgn->bgrp", grouped, c_t.float())
    return y.reshape(bsz, h, p).to(x_t.dtype), state


def _split_in_proj(cfg: ModelConfig, proj: torch.Tensor):
    di = cfg.ssm_d_inner
    z = proj[..., :di]
    xbc = proj[..., di:di + cfg.ssm_conv_dim]
    dt = proj[..., di + cfg.ssm_conv_dim:]
    return z, xbc, dt


def _heads(cfg: ModelConfig, xbc: torch.Tensor):
    """(..., conv_dim) -> x (..., H, P), b and c (..., G, N), as views."""
    di, gr, st = cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state_dim
    lead = xbc.shape[:-1]
    xs = xbc[..., :di].reshape(*lead, cfg.ssm_num_heads, cfg.ssm_head_dim)
    b = xbc[..., di:di + gr * st].reshape(*lead, gr, st)
    c = xbc[..., di + gr * st:].reshape(*lead, gr, st)
    return xs, b, c


def mamba_forward_states(params: Params, x: torch.Tensor, cfg: ModelConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 block that also returns the decode state.

    x: (B, S, D) -> ``(y (B, S, D), final SSM state (B, H, P, N) f32,
    conv state (B, W-1, conv_dim))``, the conv state being the last W-1
    rows of the conv's input.  The scan runs through
    :func:`kernel_ops.ssd_scan` (under autograd on the card too: every
    weight of the block gets its gradient through the scan); y is in the
    promoted dtype of the block's f32 skip term and its weights, as in
    the JAX package."""
    bsz, s, _ = x.shape
    proj = x @ params["in_proj"]
    z, xbc_pre, dt = _split_in_proj(cfg, proj)
    conv_state = xbc_pre[:, -(cfg.ssm_conv_width - 1):, :]
    xbc = F.silu(causal_conv1d(xbc_pre, params["conv_w"], params["conv_b"])
                 .float()).to(x.dtype)
    xs, b, c = _heads(cfg, xbc)
    dt = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, final_state = kernel_ops.ssd_scan(xs, dt, a, b, c,
                                         chunk=cfg.ssm_chunk)
    y = y + params["d_skip"][None, None, :, None] * xs
    y = y.reshape(bsz, s, cfg.ssm_d_inner)
    y = gated_rms_norm(y, z, params["norm_scale"], cfg.norm_eps)
    return matmul_promote(y, params["out_proj"]), final_state, conv_state


def mamba_forward(params: Params, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 block.  x: (B, S, D) -> (B, S, D)."""
    return mamba_forward_states(params, x, cfg)[0]


def mamba_step(params: Params, x_t: torch.Tensor, ssm_state: torch.Tensor,
               conv_state: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step.  x_t: (B, D); ssm_state: (B, H, P, N) f32;
    conv_state: (B, W-1, conv_dim) in any dtype (the conv runs in x_t's,
    as the JAX package casts the cache).  Both states are updated in
    place.  Returns ``(y (B, D), ssm_state, conv_state)``."""
    bsz = x_t.shape[0]
    proj = x_t @ params["in_proj"]
    z, xbc, dt = _split_in_proj(cfg, proj)
    xbc, new_conv = causal_conv1d_step(xbc, conv_state.to(x_t.dtype),
                                       params["conv_w"], params["conv_b"])
    conv_state.copy_(new_conv)
    xbc = F.silu(xbc.float()).to(x_t.dtype)
    xs, b, c = _heads(cfg, xbc)
    dt = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, ssm_state = ssd_step(ssm_state, xs, dt, a, b, c)
    y = y + params["d_skip"][None, :, None] * xs
    y = y.reshape(bsz, cfg.ssm_d_inner)
    y = gated_rms_norm(y, z, params["norm_scale"], cfg.norm_eps)
    return matmul_promote(y, params["out_proj"]), ssm_state, conv_state


def mamba_state_shapes(cfg: ModelConfig, batch: int):
    return (
        (batch, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim),
        (batch, cfg.ssm_conv_width - 1, cfg.ssm_conv_dim),
    )
