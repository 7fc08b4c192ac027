"""AdamW over a nested dict of tensors (the JAX package's parameter
layout): f32 moments for floating leaves, clipping by the global norm,
decoupled weight decay, and the update computed in f32 and rounded back
to each leaf's dtype.  Non-floating leaves pass through unchanged.

:func:`apply` returns new tensors; :func:`apply_` writes the same values
over the parameters and moments it is given, as the JAX package's train
step does under ``jax.jit(..., donate_argnums=(0, 1))``.  Both work a
leaf in chunks of at most ``CHUNK`` elements along its leading axis (a
stacked leaf one layer at a time), so an update's f32 temporaries stay
small beside the tree."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple, Union

import torch

from ..models.layers import tree_leaves, tree_map

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Params
    v: Params


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0


def init(params: Params) -> AdamWState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32) \
            if p.is_floating_point() else torch.zeros_like(p)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(tree_leaves(params)).device)
    return AdamWState(step=step, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


# elements of a leaf that one update or sum of squares works on at once
CHUNK = 1 << 24


def _chunks(t: torch.Tensor):
    """Views of ``t`` along its leading axis, each of at most ``CHUNK``
    elements where a row allows (a 0-d leaf is one chunk)."""
    if t.dim() == 0:
        return [t]
    rows = max(1, CHUNK // max(1, t[0].numel()))
    return list(t.split(rows))


def global_norm(tree: Params) -> torch.Tensor:
    sq = [sum(c.float().square().sum() for c in _chunks(g))
          for g in tree_leaves(tree) if g.is_floating_point()]
    return torch.sqrt(sum(sq))


def _scalars(grads: Params, state: AdamWState, cfg: AdamWConfig,
             lr_scale):
    """The step's count, clip factor, bias corrections and learning
    rate."""
    step = state.step + 1
    clip = torch.clamp(cfg.grad_clip / (global_norm(grads) + 1e-9), max=1.0)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    return step, clip, b1c, b2c, cfg.lr * lr_scale


def _update(p, g, m, v, clip, b1c, b2c, lr, cfg: AdamWConfig):
    """One chunk's new (p, m, v) in f32, p rounded to its dtype."""
    g = g.float() * clip
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g.square()
    delta = lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                  + cfg.weight_decay * p.float())
    return (p.float() - delta).to(p.dtype), m, v


def apply(grads: Params, params: Params, state: AdamWState,
          cfg: AdamWConfig = AdamWConfig(),
          lr_scale: Union[torch.Tensor, float] = 1.0
          ) -> Tuple[Params, AdamWState]:
    """One AdamW step.  Returns (new params, new state); the inputs are
    not modified."""
    step, *scalars = _scalars(grads, state, cfg, lr_scale)

    def upd(p, g, m, v):
        if not p.is_floating_point():
            return p, m, v
        new = [torch.empty_like(t) for t in (p, m, v)]
        for chunk in zip(*(_chunks(t) for t in (p, g, m, v, *new))):
            for dst, val in zip(chunk[4:], _update(*chunk[:4], *scalars,
                                                    cfg)):
                dst.copy_(val)
        return tuple(new)

    out = tree_map(upd, params, grads, state.m, state.v)
    new_p, new_m, new_v = (tree_map(lambda o: o[i], out) for i in range(3))
    return new_p, AdamWState(step=step, m=new_m, v=new_v)


def apply_(grads: Params, params: Params, state: AdamWState,
           cfg: AdamWConfig = AdamWConfig(),
           lr_scale: Union[torch.Tensor, float] = 1.0
           ) -> Tuple[Params, AdamWState]:
    """:func:`apply` in place: the same values, bit for bit, written over
    ``params`` and the moments of ``state`` (the donated buffers), whose
    tensors it returns with the step count advanced.  ``grads`` is
    read only."""
    step, *scalars = _scalars(grads, state, cfg, lr_scale)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        if not p.is_floating_point():
            continue
        for pc, gc, mc, vc in zip(*(_chunks(t) for t in (p, g, m, v))):
            for dst, val in zip((pc, mc, vc),
                                _update(pc, gc, mc, vc, *scalars, cfg)):
                dst.copy_(val)
    state.step.copy_(step)
    return params, state
