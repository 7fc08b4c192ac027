"""Weight-recycled supernet: runtime variant selection without retraining.

The paper pre-assembles a multi-variant model whose variants share (recycle)
backbone weights so that switching compression level at runtime needs no
retraining (§III-A1).  Here the backbone IS the supernet: variants are
derived on demand by ``derive_variant`` and cached; switching variants is a
dictionary lookup (and, on first use, one derivation on the backbone's
device).
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..models.configs import ModelConfig
from ..models.layers import Params
from .operators import FULL_SPEC, VariantSpec, derive_variant, variant_cost


class ElasticSupernet:
    """Holds one backbone and materializes/caches its elastic variants."""

    def __init__(self, cfg: ModelConfig, params: Params,
                 max_cached: int = 8):
        self.backbone_cfg = cfg
        self.backbone_params = params
        self.max_cached = max_cached
        self._cache: Dict[VariantSpec, Tuple[ModelConfig, Params]] = {}

    def variant(self, spec: VariantSpec) -> Tuple[ModelConfig, Params]:
        if spec == FULL_SPEC:
            return self.backbone_cfg, self.backbone_params
        if spec not in self._cache:
            if len(self._cache) >= self.max_cached:
                # evict the least recently inserted (simple FIFO)
                self._cache.pop(next(iter(self._cache)))
            self._cache[spec] = derive_variant(self.backbone_cfg,
                                               self.backbone_params, spec)
        return self._cache[spec]

    def cost(self, spec: VariantSpec, seq_len: int = 2048):
        return variant_cost(self.backbone_cfg, spec, seq_len)

    def applicable_operators(self) -> Tuple[str, ...]:
        """Which η families apply to this backbone."""
        t = self.backbone_cfg.arch_type
        if t == "ssm":
            return ("eta5",)              # depth only: no FFN, no attention
        if t == "moe":
            return ("eta5", "eta6")       # expert/top-k scaling + depth
        if t == "hybrid":
            return ("eta5",)
        return ("eta1", "eta2", "eta3", "eta4", "eta5", "eta6")

    def action_space(self) -> Tuple[VariantSpec, ...]:
        """The discrete variant grid the middleware optimizer searches."""
        ops = set(self.applicable_operators())
        specs = [FULL_SPEC]
        if "eta5" in ops:
            specs += [VariantSpec(depth_ratio=r) for r in (0.75, 0.5)]
        if "eta6" in ops:
            specs += [VariantSpec(width_ratio=r) for r in (0.75, 0.5)]
        if "eta1" in ops:
            specs += [VariantSpec(rank_ratio=r) for r in (0.5, 0.25)]
        if "eta4" in ops:
            specs += [VariantSpec(ghost=True)]
        if "eta2" in ops and self.backbone_cfg.num_kv_heads % 2 == 0 \
                and self.backbone_cfg.num_kv_heads > 1:
            specs += [VariantSpec(kv_merge=2)]
        if "eta3" in ops:
            specs += [VariantSpec(compound=1.0)]
        # the paper's favored pairings
        if {"eta1", "eta6"} <= ops:
            specs += [VariantSpec(rank_ratio=0.5, width_ratio=0.5)]
        if {"eta1", "eta5"} <= ops:
            specs += [VariantSpec(rank_ratio=0.5, depth_ratio=0.75)]
        if {"eta5", "eta6"} <= ops:
            specs += [VariantSpec(depth_ratio=0.75, width_ratio=0.75)]
        return tuple(dict.fromkeys(specs))
