"""Multi-branch early exits (paper §III-A1).

Exit heads (norm + linear-to-vocab via the tied embedding) are attached at
chosen depths of the backbone.  At inference, per-example confidence
(max softmax prob) against a threshold decides the exit — realized with
masking, as in the JAX package, so the whole batch runs every segment
(no data-dependent shapes).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..models.configs import ModelConfig
from ..models.layers import (Params, cast_params, dtype_of, embed_lookup,
                             rms_norm, tree_map, unembed)
from ..models.runtime import DEFAULT_OPTIONS, RuntimeOptions
from ..models.transformer import apply_stack


def attach_exits(cfg: ModelConfig, params: Params,
                 positions: Sequence[int]) -> Params:
    """Add exit-head parameters at the given layer indices: one zero norm
    scale per exit, on the device of the embedding.  (The JAX version
    takes a PRNG key that it does not use.)"""
    out = dict(params)
    out["exits"] = {
        "positions": tuple(int(p) for p in positions),
        "norms": torch.zeros((len(positions), cfg.d_model),
                             dtype=dtype_of(cfg.param_dtype),
                             device=params["embed"].device),
    }
    return out


def forward_with_exits(params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor,
                       opts: RuntimeOptions = DEFAULT_OPTIONS
                       ) -> List[torch.Tensor]:
    """Return logits at every exit position plus the final head.

    Runs the stack in segments between exit positions; a hybrid's
    shared attention block runs after each full period of a segment, so
    its placement restarts at every exit, as in the JAX package."""
    act_dt = dtype_of(cfg.activation_dtype)
    ps = cast_params(params, act_dt)
    x = embed_lookup(ps["embed"], tokens).to(act_dt)
    positions = list(params["exits"]["positions"]) if "exits" in params \
        else []
    bounds = positions + [cfg.num_layers]
    start = 0
    outs = []
    for i, end in enumerate(bounds):
        if end > start:
            seg = tree_map(lambda a: a[start:end], ps["layers"])
            x, _ = apply_stack(seg, x, cfg, opts,
                               shared=ps.get("shared_attn"))
        if i < len(positions):
            h = rms_norm(x, ps["exits"]["norms"][i], cfg.norm_eps)
            outs.append(unembed(ps["embed"], h))
        start = end
    h = rms_norm(x, ps["final_norm"], cfg.norm_eps)
    outs.append(unembed(ps["embed"], h))
    return outs


def early_exit_predict(params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor, threshold: float = 0.7,
                       opts: RuntimeOptions = DEFAULT_OPTIONS
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched adaptive early exit.

    Returns (logits (B,S,V) f32, exit_depth (B,S) int32 — index of the
    exit taken).  Confidence = max softmax probability of the exit head;
    once an example clears the threshold its logits are frozen (masking
    semantics)."""
    outs = forward_with_exits(params, cfg, tokens, opts)
    n = len(outs)
    result = outs[-1].float()
    chosen = torch.full(result.shape[:-1], n - 1, dtype=torch.int32,
                        device=result.device)
    done = torch.zeros(result.shape[:-1], dtype=torch.bool,
                       device=result.device)
    for i, lg in enumerate(outs[:-1]):
        lg = lg.float()
        conf = torch.softmax(lg, dim=-1).amax(dim=-1)
        take = (conf >= threshold) & ~done
        result = torch.where(take[..., None], lg, result)
        chosen = torch.where(take, torch.full_like(chosen, i), chosen)
        done = done | take
    return result, chosen


def expected_exit_flops(cfg: ModelConfig, exit_depth: torch.Tensor,
                        positions: Sequence[int], seq_len: int) -> float:
    """Average per-token FLOPs given realized exit depths (for the
    profiler)."""
    bounds = list(positions) + [cfg.num_layers]
    per_layer = cfg.flops_per_token(seq_len) / max(cfg.num_layers, 1)
    depths = torch.tensor(bounds, dtype=torch.float64)
    used = depths[exit_depth.long().cpu()]
    return float(used.mean() * per_layer)
