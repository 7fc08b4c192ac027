"""Test-time adaptation for data drift (paper §III-A2).

Unsupervised entropy minimization that updates ONLY normalization scales
(TENT-style) — the selective-weight-update strategy the paper uses so that
adaptation is cheap enough to run inside the serving loop.  The backend
engine's TTA optimizations (§III-C2: sub-batch accumulation) surface here
as options.

The gradient is ``torch.autograd.grad`` of the objective over every
floating leaf of the parameter tree, as the JAX package takes it; the
update is then masked to the ``NORM_KEYS`` paths.  On the card the
forward runs the flash attention and fused FFN kernels, whose autograd
wrappers carry the analytic gradients.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..models.configs import ModelConfig
from ..models.layers import Params
from ..models.runtime import DEFAULT_OPTIONS, RuntimeOptions
from ..models.transformer import forward, lm_loss

NORM_KEYS = ("ln", "ln1", "ln2", "ln_cross", "final_norm", "norm_scale",
             "encoder_norm", "logit_bias")


def _paths(tree, prefix=()) -> List[Tuple[Tuple[str, ...], object]]:
    """(key path, leaf) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _paths(v, prefix + (str(k),))]
    return [(prefix, tree)]


def _map_with_path(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _is_norm_path(path: Tuple[str, ...]) -> bool:
    return any(n in NORM_KEYS for n in path)


def split_norm_params(params: Params) -> Params:
    """The adaptable norm scales: a same-structure tree holding the
    leaves under a ``NORM_KEYS`` key and ``None`` everywhere else."""
    return _map_with_path(lambda p, a: a if _is_norm_path(p) else None,
                          params)


def prediction_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp.exp() * logp).sum(dim=-1).mean()


def tta_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
             opts: RuntimeOptions = DEFAULT_OPTIONS,
             objective: str = "entropy", **fwd_kw) -> torch.Tensor:
    """Unsupervised adaptation objective on unlabeled live tokens.

    "entropy" — TENT-style prediction-entropy minimization (the paper's
    classifier setting); "self" — next-token loss on the live stream
    itself, which for an LM is the natural label-free objective (live
    tokens ARE their own supervision)."""
    logits, _ = forward(params, cfg, tokens, opts, **fwd_kw)
    if objective == "self":
        return lm_loss(logits[:, :-1], tokens[:, 1:])
    return prediction_entropy(logits)


def tta_grads(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
              opts: RuntimeOptions = DEFAULT_OPTIONS, sub_batches: int = 1,
              objective: str = "entropy", **fwd_kw
              ) -> Tuple[Params, Dict[Tuple[str, ...], torch.Tensor],
                         torch.Tensor]:
    """Gradients of the TTA objective over every floating leaf.

    Returns (params with ``logit_bias`` attached, ``{key path: f32
    gradient}``, the mean objective).  ``sub_batches > 1`` accumulates
    gradients over batch slices (the engine's ❽ sub-batch accumulation
    strategy) so peak activation memory shrinks by ~sub_batches at equal
    statistical effect.  A leaf the objective does not read (an exit
    head) gets a zero gradient.  ``params`` is not modified."""
    b = tokens.shape[0]
    if b % sub_batches:
        raise ValueError(f"batch {b} does not split into {sub_batches}")
    step = b // sub_batches
    if "logit_bias" not in params:
        # lazily attach the adaptable output-prior vector
        params = dict(params)
        params["logit_bias"] = torch.zeros(
            (cfg.padded_vocab,), dtype=torch.float32,
            device=params["embed"].device)
    leaves = [(p, a) for p, a in _paths(params)
              if isinstance(a, torch.Tensor) and a.is_floating_point()]
    grads = [torch.zeros_like(a, dtype=torch.float32) for _, a in leaves]
    total = torch.zeros((), dtype=torch.float32,
                        device=params["embed"].device)
    for i in range(sub_batches):
        sl = slice(i * step, (i + 1) * step)
        kw = {k: (v[sl] if hasattr(v, "shape") else v)
              for k, v in fwd_kw.items()}
        live = {p: a.detach().requires_grad_(True) for p, a in leaves}
        tree = _map_with_path(lambda p, a: live.get(p, a), params)
        loss = tta_loss(tree, cfg, tokens[sl], opts, objective=objective,
                        **kw)
        gs = torch.autograd.grad(loss, list(live.values()),
                                 allow_unused=True)
        total = total + loss.detach() / sub_batches
        grads = [acc if g is None else acc + g.float() / sub_batches
                 for acc, g in zip(grads, gs)]
    return params, {p: g for (p, _), g in zip(leaves, grads)}, total


def tta_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
             lr: float = 1e-3, opts: RuntimeOptions = DEFAULT_OPTIONS,
             sub_batches: int = 1, objective: str = "entropy",
             **fwd_kw) -> Tuple[Params, torch.Tensor]:
    """One TTA update on unlabeled live tokens.  Returns (new params, the
    mean objective before the update).

    The gradients are ``tta_grads``'s; only norm scales receive updates,
    and every other leaf is the input's own tensor.  ``params`` is not
    modified."""
    params, grads, total = tta_grads(params, cfg, tokens, opts, sub_batches,
                                     objective, **fwd_kw)
    leaf = dict(_paths(params))
    new = {}
    for path, g in grads.items():
        if _is_norm_path(path):
            p = leaf[path]
            # the output-prior bias sees (p_model - p_live)-scale gradients
            # (~1/V per entry): give it a proportionally larger step so the
            # log-prior can actually move within a few adaptation ticks
            eta = lr * 100.0 if "logit_bias" in path else lr
            new[path] = (p.detach().float() - eta * g).to(p.dtype)
    return _map_with_path(lambda p, a: new.get(p, a), params), total
