"""Progressive recomputation (paper §III-C2 ❺/❻ for TTA workloads).

The policies run in ``models/transformer.apply_stack``: a non-reentrant
``torch.utils.checkpoint.checkpoint`` around each pattern period, with a
selective policy (``create_selective_checkpoint_contexts`` keeping the
projections' and the fused FFN's outputs) for "dots".  The ladder's
byte and FLOP figures below are analytic, as in the JAX package, and
``chip_smoke.py`` prints them beside what the card measures.  The engine
exposes a *progressive* ladder of
policies ordered by activation memory vs recompute FLOPs; given a live
memory budget it walks down the ladder until the analytic activation
footprint fits — the paper's "proactively discards tensors when memory
exceeds thresholds, recomputes when budget changes".
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.models.configs import InputShape, ModelConfig

# (name, activation fraction kept, recompute FLOP overhead fraction)
POLICY_LADDER: Tuple[Tuple[str, float, float], ...] = (
    ("none", 1.00, 0.00),   # keep everything
    ("dots", 0.45, 0.18),   # keep matmul outputs, recompute elementwise/norm
    ("full", 0.08, 0.33),   # keep only layer boundaries (classic 1/L remat)
)


@dataclass(frozen=True)
class RematDecision:
    policy: str
    act_bytes: int
    recompute_flops: float


def activation_bytes(cfg: ModelConfig, batch: int, seq: int,
                     dtype_bytes: int = 2) -> int:
    """Forward activation footprint per step without any remat."""
    t = batch * seq
    per_layer = t * (
        4 * cfg.d_model                      # block inputs/residuals/norms
        + 2 * cfg.q_dim + 2 * cfg.kv_dim     # qkvo
        + (3 if cfg.gated_ffn else 2) * cfg.d_ff   # ffn hiddens
    ) * dtype_bytes
    if cfg.arch_type in ("ssm", "hybrid"):
        per_layer = t * (4 * cfg.d_model + 3 * cfg.ssm_d_inner
                         + 2 * cfg.ssm_ngroups * cfg.ssm_state_dim
                         ) * dtype_bytes
    n = cfg.num_layers * per_layer
    n += t * cfg.vocab_size * dtype_bytes   # logits
    return int(n)


def choose_policy(cfg: ModelConfig, batch: int, seq: int,
                  budget_bytes: float, dtype_bytes: int = 2,
                  train_flops: Optional[float] = None) -> RematDecision:
    """Walk the ladder progressively; return the cheapest policy that fits.

    If even 'full' misses the budget, return it anyway (the middleware then
    escalates to sub-batch accumulation / offloading instead)."""
    base = activation_bytes(cfg, batch, seq, dtype_bytes)
    flops = train_flops or (3.0 * cfg.flops_per_token(seq) * batch * seq)
    decision = None
    for name, keep, overhead in POLICY_LADDER:
        decision = RematDecision(policy=name,
                                 act_bytes=int(base * keep),
                                 recompute_flops=flops * overhead)
        if decision.act_bytes <= budget_bytes:
            return decision
    return decision  # the most aggressive one


def sub_batch_split(cfg: ModelConfig, batch: int, seq: int,
                    budget_bytes: float, policy: str = "full",
                    dtype_bytes: int = 2) -> int:
    """Engine ❽: number of gradient-accumulation sub-batches needed so the
    per-sub-batch activation footprint fits the budget."""
    keep = dict((n, k) for n, k, _ in POLICY_LADDER)[policy]
    per_example = activation_bytes(cfg, 1, seq, dtype_bytes) * keep
    max_examples = max(1, int(budget_bytes / max(per_example, 1)))
    n = 1
    while batch // n > max_examples and n < batch:
        n *= 2
    return min(n, batch)
