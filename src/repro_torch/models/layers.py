"""Primitive layers shared by the dense attention stacks.

Plain functions over explicit parameter dicts of tensors — the same
layout as the JAX package, with a leading layer axis on every per-layer
leaf, so weights cross over through :mod:`repro_torch.weights` unchanged.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16,
            # engine ❼ activation/KV compression: 1-byte storage
            "fp8": torch.float8_e4m3fn}[name]


# --------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def gated_rms_norm(x: torch.Tensor, gate: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Mamba2-style gated RMSNorm: norm(x * silu(gate)) * (1+scale); the
    silu in f32, then back to x's dtype."""
    return rms_norm(x * F.silu(gate.float()).to(x.dtype), scale, eps)


# --------------------------------------------------------------------- rotary
def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float = 10000.0):
    """Return (sin, cos) of shape positions.shape + (head_dim//2,)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    # ``full`` rather than ``tensor``: no host-to-device copy, so a decode
    # step that computes its rotary phases can be captured as a CUDA graph
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                       device=positions.device), exps)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor,
                 cos: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); sin/cos: (..., seq, head_dim//2).
    Split-half rotation, as in the JAX package."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    s = sin[..., None, :]  # broadcast over heads axis
    c = cos[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)


# ------------------------------------------------------------------ matmul
def matmul_w(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul supporting elastic factored weights: ``w`` is a dense
    tensor or a low-rank pair ``{"u": (d_in, r), "v": (r, d_out)}``
    executed as two thin matmuls."""
    if isinstance(w, dict):
        return (x @ w["u"]) @ w["v"]
    return x @ w


# ----------------------------------------------------------------------- FFN
def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def ffn_apply(params: Params, x: torch.Tensor, *, gated: bool,
              activation: str) -> torch.Tensor:
    if gated and "ghost_src" not in params and not any(
            isinstance(params[k], dict)
            for k in ("w_gate", "w_up", "w_down")):
        # a dense gated FFN is one call of the fused kernel on the card
        # (its plain version on the CPU): f32 inside, one rounding
        lead = x.shape[:-1]
        y = kernel_ops.gated_ffn(x.reshape(-1, x.shape[-1]),
                                 params["w_gate"], params["w_up"],
                                 params["w_down"], activation)
        return y.reshape(*lead, y.shape[-1])
    # the forms the fused kernel does not take, as plain ops: non-gated
    # FFNs, factored {"u","v"} weights and η4 ghost features
    act = {"silu": F.silu, "gelu": _gelu_tanh}[activation]
    if gated:
        h = act(matmul_w(x, params["w_gate"])) * matmul_w(x, params["w_up"])
    else:
        h = act(matmul_w(x, params["w_up"]))
    if "ghost_src" in params:
        # η4 (GhostNet): half the hidden features are computed, the rest
        # are generated by a cheap per-channel linear map of a computed one
        ghost = h.index_select(-1, params["ghost_src"]) * params["ghost_scale"]
        h = torch.cat([h, ghost.to(h.dtype)], dim=-1)
    return matmul_w(h, params["w_down"])


# ----------------------------------------------------------------- embedding
def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: (..., d) @ (vocab, d)^T -> (..., vocab)."""
    return x @ table.T


def matmul_promote(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp`` computes a
    product of mixed float dtypes (f32 @ bf16 is an f32 product)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# -------------------------------------------------------------- conv frontend
def causal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C); weight: (C, W); bias: (C,).
    The W taps are summed in f32 as shifted products (no (B, S, C, W)
    window tensor), rounded once to x's dtype, then the bias is added."""
    w = weight.shape[1]
    s = x.shape[1]
    pad = F.pad(x.float(), (0, 0, w - 1, 0))
    wf = weight.float()
    out = pad[:, 0:s] * wf[:, 0]
    for k in range(1, w):
        out = out + pad[:, k:k + s] * wf[:, k]
    return (out.to(x.dtype) + bias).to(x.dtype)


def causal_conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                       weight: torch.Tensor, bias: torch.Tensor):
    """One decode step.  x_t: (B, C); conv_state: (B, W-1, C).  Returns
    ``(out (B, C), new state (B, W-1, C))``."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)    # (B, W, C)
    out = torch.einsum("bwc,cw->bc", window.float(), weight.float())
    return (out.to(x_t.dtype) + bias).to(x_t.dtype), window[:, 1:, :]


# --------------------------------------------------------------------- misc
# keys kept in float32 regardless of activation dtype (stability-critical)
_F32_KEYS = ("a_log", "d_skip", "dt_bias", "router")


def cast_params(params: Params, act_dtype: torch.dtype) -> Params:
    """Cast floating weights to the activation dtype for execution; leaves
    whose name contains one of ``_F32_KEYS`` stay as they are.  Leaves
    already in ``act_dtype`` are returned as they are (no copy), so casting
    an already-cast dict is free."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, str(k)) for k, v in tree.items()}
        if any(k in name for k in _F32_KEYS):
            return tree
        if isinstance(tree, torch.Tensor) and tree.is_floating_point():
            return tree.to(act_dtype)
        return tree
    return walk(params, "")


def tree_map(fn, *trees):
    """``fn`` over the leaves of same-structure nested dicts."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of a nested dict, depth first in key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def layer_slice(stack: Params, j: int) -> Params:
    """Layer ``j`` of a stacked per-layer parameter dict."""
    return {k: layer_slice(v, j) if isinstance(v, dict) else v[j]
            for k, v in stack.items()}


def mask_padded_logits_raw(logits: torch.Tensor,
                           vocab_size: int) -> torch.Tensor:
    if logits.shape[-1] == vocab_size:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(ids >= vocab_size, -1e30)
