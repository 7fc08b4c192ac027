"""Mixture-of-Experts FFN with token-choice routing and capacity dispatch.

Ported from the JAX package's ``models/moe.py``.  Prefill (``moe_apply``)
routes each token to its top-k experts, lets each expert keep its top-C
tokens (C from :func:`_capacity`; tokens beyond it are dropped,
Switch-style), gathers them, runs the batched expert products and
combines the gate-weighted outputs.  Decode (``moe_apply_decode``) is
the reference's dense dispatch: every expert computes every token and a
top-k one-hot gate combines the results.

The expert products are plain batched matmuls (the JAX package has no
Pallas kernel for them); the optional shared expert is a dense gated FFN
through :func:`layers.ffn_apply`, so it runs the fused FFN kernel on the
card.  Three choices keep the port equal to the reference and
deterministic on the card:

* every top-k is a *stable* descending sort, sliced: ``jax.lax.top_k``
  takes the lower index on a tie, which decides which tokens an
  over-full expert keeps when gates tie (top-1 routing gives every
  token the gate 1.0) and the order of the unchosen tokens' -1 scores;
* the router product runs in f32 on f32 router weights;
* the combine gathers each token's (expert, slot) outputs and sums them
  in ascending expert order, the order in which the reference's
  scatter-add applies them, with no atomics (``index_add_`` on the card
  would add in a different order from run to run).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .configs import ModelConfig
from .layers import Params, _gelu_tanh, ffn_apply

_ACT = {"silu": F.silu, "gelu": _gelu_tanh}


def _capacity(num_tokens: int, cfg: ModelConfig, cap_factor: float) -> int:
    c = int(cap_factor * cfg.experts_per_token * num_tokens / cfg.num_experts)
    c = max(8, int(math.ceil(c / 8) * 8))
    return min(c, num_tokens)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest in
    descending order, a tie to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router: torch.Tensor, x: torch.Tensor, k: int):
    """Softmax router in f32, per-token top-k, renormalised gates.
    Returns ``(probs (T, E), gates (T, E), chosen experts (T, k))``."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    topk_p, topk_i = _top_k(probs, k)
    topk_p = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)
    gates = torch.zeros_like(probs).scatter(1, topk_i, topk_p)
    return probs, gates, topk_i


def _select(gates: torch.Tensor, cap: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-expert capacity-C token selection from the gates (T, E): each
    expert's top-C tokens by gate, unchosen tokens scoring -1.  Returns
    ``(sel_idx (E, C), valid (E, C))``; invalid slots are dropped."""
    scores = torch.where(gates > 0, gates, torch.full_like(gates, -1.0)).T
    sel_score, sel_idx = _top_k(scores, cap)
    return sel_idx, sel_score > 0


def _experts(params: Params, xg: torch.Tensor, cfg: ModelConfig):
    """The batched expert FFNs: xg (E, C, D) -> (E, C, D)."""
    act = _ACT[cfg.activation]
    up = torch.bmm(xg, params["w_up"])
    h = act(torch.bmm(xg, params["w_gate"])) * up if cfg.gated_ffn \
        else act(up)
    return torch.bmm(h, params["w_down"])


def _combine(yg: torch.Tensor, sel_idx: torch.Tensor, valid: torch.Tensor,
             topk_i: torch.Tensor) -> torch.Tensor:
    """Sum each token's weighted expert outputs ``yg (E, C, D)`` into
    ``(T, D)`` in ascending expert order, without atomics."""
    e, cap, d = yg.shape
    t, k = topk_i.shape
    dev = yg.device
    # the slot of token t in expert e's kept list, -1 where not kept
    # (each row of sel_idx names distinct tokens, so the scatter is exact)
    slots = torch.where(valid, torch.arange(cap, device=dev), -1)
    slot_of = torch.full((e, t), -1, dtype=torch.long, device=dev)
    slot_of.scatter_(1, sel_idx, slots)
    experts = torch.sort(topk_i, dim=-1).values            # ascending
    tok = torch.arange(t, device=dev)
    flat = yg.reshape(e * cap, d)
    y = torch.zeros((t, d), dtype=yg.dtype, device=dev)
    for j in range(k):
        ex = experts[:, j]
        c = slot_of[ex, tok]
        rows = flat[ex * cap + torch.clamp(c, min=0)]
        y = y + torch.where((c >= 0)[:, None], rows, torch.zeros_like(rows))
    return y


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
              capacity_factor: float = 1.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).

    Routing: softmax router -> per-token top-k gates -> per-expert top-C
    token selection, ranked by the renormalised gate (as the reference's
    code ranks them).  ``aux`` is the Switch load-balance loss
    ``E * sum(mean(probs) * mean(gates > 0))``."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    cap = _capacity(t, cfg, capacity_factor)
    xf = x.reshape(t, d)
    probs, gates, topk_i = _route(params["router"], xf, k)

    sel_idx, valid = _select(gates, cap)
    xg = xf[sel_idx.reshape(-1)].reshape(e, cap, d)
    xg = xg * valid[..., None].to(x.dtype)
    yg = _experts(params, xg, cfg)                           # (E, C, D)
    gate_sel = gates.T.gather(1, sel_idx)                    # (E, C)
    yg = yg * (gate_sel * valid).to(yg.dtype)[..., None]
    y = _combine(yg, sel_idx, valid, topk_i)

    if cfg.moe_shared_expert:
        y = y + ffn_apply(params["shared"], xf, gated=cfg.gated_ffn,
                          activation=cfg.activation)

    me = probs.mean(dim=0)                                   # (E,)
    ce = (gates > 0).float().mean(dim=0)                     # (E,)
    aux = e * torch.sum(me * ce)
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_apply_decode(params: Params, x: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Decode path: DENSE dispatch.  x: (T, D) -> (T, D).

    Every expert computes every token and a top-k one-hot gate combines
    the results: the step's shapes do not depend on the routing, so it
    replays as a CUDA graph.  The gated combine is one product over the
    (expert, feature) pairs, as the reference's three-operand einsum
    contracts it (gates times hidden features first)."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    _, gates, _ = _route(params["router"], x, k)
    act = _ACT[cfg.activation]
    up = torch.matmul(x, params["w_up"])                     # (E, T, F)
    h = act(torch.matmul(x, params["w_gate"])) * up if cfg.gated_ffn \
        else act(up)
    hw = h * gates.T.to(h.dtype)[..., None]                  # (E, T, F)
    f = hw.shape[-1]
    y = hw.transpose(0, 1).reshape(t, e * f) @ \
        params["w_down"].reshape(e * f, d)
    if cfg.moe_shared_expert:
        y = y + ffn_apply(params["shared"], x, gated=cfg.gated_ffn,
                          activation=cfg.activation)
    return y.to(x.dtype)
