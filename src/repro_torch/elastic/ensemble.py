"""Offline ensemble training of backbone + variants (paper §III-A1).

The paper moves retraining into a one-time ensemble-training phase: the
backbone is trained to high accuracy, then variants are co-trained with
weight recycling so that any runtime subset keeps accuracy.  Here the
variants ARE slices of the backbone (supernet), so ensemble training is
sandwich-style (slimmable networks): each step trains the full model, the
smallest variant, and random intermediate variants, with the full model
distilling into the slices.  Gradients flow into the same backbone tensors
— that is the weight recycling.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..models.configs import ModelConfig
from ..models.layers import Params
from ..models.runtime import DEFAULT_OPTIONS, RuntimeOptions
from ..models.transformer import forward, lm_loss
from .operators import VariantSpec


def sliced_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   spec: VariantSpec, opts: RuntimeOptions = DEFAULT_OPTIONS
                   ) -> torch.Tensor:
    """Forward through a *differentiable* weight-recycled slice.

    Unlike ``derive_variant`` (importance-ordered, for inference), this
    takes prefix slices so gradients flow into the backbone tensors:
    depth -> first n layers, width -> first k FFN channels.  Prefix
    slicing during ensemble training is what MAKES prefix channels the
    important ones at inference (OFA/slimmable training convention).
    The width slices are made contiguous (a differentiable copy), as the
    fused FFN kernel takes only contiguous weights."""
    p = dict(params)
    n_layers = max(1, int(round(cfg.num_layers * spec.depth_ratio)))
    vcfg = cfg
    layers = params["layers"]
    if spec.width_ratio < 1.0 and cfg.d_ff and cfg.arch_type == "dense":
        f2 = max(8, int(cfg.d_ff * spec.width_ratio) // 8 * 8)
        ffn = {k: (v[:, :, :f2] if k in ("w_up", "w_gate") else v[:, :f2, :]
                   ).contiguous()
               for k, v in layers["ffn"].items()}
        layers = {**layers, "ffn": ffn}
        vcfg = vcfg.with_updates(d_ff=f2)
    p["layers"] = layers
    logits, _ = forward(p, vcfg, tokens, opts, num_layers=n_layers)
    return logits


def ensemble_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  labels: torch.Tensor,
                  specs: Sequence[VariantSpec] = (),
                  distill_weight: float = 0.5,
                  opts: RuntimeOptions = DEFAULT_OPTIONS) -> torch.Tensor:
    """Sandwich-rule ensemble loss: full + smallest + sampled variants.

    The full model trains on data; variants train on data +
    KL-distillation from the (detached) full model.  (The JAX version
    also takes a PRNG key, which it does not use: draw the sampled
    variants with :func:`sample_variant_specs`.)"""
    full_logits, aux = forward(params, cfg, tokens, opts)
    loss = lm_loss(full_logits, labels) + cfg.router_aux_weight * aux
    teacher = torch.log_softmax(full_logits.float(), dim=-1).detach()
    if not specs:
        specs = (VariantSpec(depth_ratio=0.5, width_ratio=0.5),)
    for spec in specs:
        v_logits = sliced_forward(params, cfg, tokens, spec, opts)
        v_loss = lm_loss(v_logits, labels)
        logq = torch.log_softmax(v_logits.float(), dim=-1)
        kl = (teacher.exp() * (teacher - logq)).sum(dim=-1).mean()
        loss = loss + (1 - distill_weight) * v_loss + distill_weight * kl
    return loss / (1 + len(specs))


def sample_variant_specs(gen: torch.Generator, n: int = 2
                         ) -> Tuple[VariantSpec, ...]:
    """Random intermediate variants for the sandwich rule: depth and
    width ratios uniform in [0.5, 1), rounded to quarters, drawn from
    ``gen``."""
    specs = []
    for _ in range(n):
        d, w = (0.5 + 0.5 * torch.rand(2, generator=gen,
                                       dtype=torch.float64)).tolist()
        specs.append(VariantSpec(depth_ratio=round(d * 4) / 4,
                                 width_ratio=round(w * 4) / 4))
    return tuple(specs)
