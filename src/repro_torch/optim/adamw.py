"""AdamW over a nested dict of tensors (the JAX package's parameter
layout): f32 moments for floating leaves, clipping by the global norm,
decoupled weight decay, and the update computed in f32 and rounded back
to each leaf's dtype.  Non-floating leaves pass through unchanged."""
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


def global_norm(tree: Params) -> torch.Tensor:
    sq = [g.float().square().sum() for g in tree_leaves(tree)
          if g.is_floating_point()]
    return torch.sqrt(sum(sq))


def apply(grads: Params, params: Params, state: AdamWState,
          cfg: AdamWConfig = AdamWConfig(),
          lr_scale: Union[torch.Tensor, float] = 1.0
          ) -> Tuple[Params, AdamWState]:
    """One AdamW step.  Returns (new params, new state); the inputs are
    not modified."""
    step = state.step + 1
    clip = torch.clamp(cfg.grad_clip / (global_norm(grads) + 1e-9), max=1.0)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        if not p.is_floating_point():
            return p, m, v
        g = g.float() * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        delta = lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                      + cfg.weight_decay * p.float())
        return (p.float() - delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.m, state.v)
    new_p, new_m, new_v = (tree_map(lambda o: o[i], out) for i in range(3))
    return new_p, AdamWState(step=step, m=new_m, v=new_v)
