"""CrowdHMTware middleware facade (paper §III-D3).

The paper's public surface is ``run.py(device_id, model, IP, PORT, fuse,
quan)``; here the same spirit: register a model once, then let the
middleware own variant selection, placement and engine configuration
while the application just calls ``infer`` / ``adapt_weights``.  "It
hides run-time system issues from developers."

The JAX package jit-compiles one forward per variant; here ``infer``
calls the port's ``forward`` on the materialised variant directly.  The
parameters stay on the caller's device (the card unless the caller
passes CPU tensors), and every variant derived from them lives there
too.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from ..elastic.supernet import ElasticSupernet
from ..elastic.tta import tta_step
from ..models.configs import TRAIN_4K, InputShape, ModelConfig
from ..models.layers import Params
from ..models.model import forward
from ..models.runtime import RuntimeOptions
from .loop import AdaptationLoop, Decision
from .monitor import ResourceContext
from .optimizer import Budgets
from .profiler import H100_SXM, HardwareProfile


@dataclass
class Middleware:
    """run(device_id, model, ...) → adaptive execution."""
    cfg: ModelConfig
    params: Params
    shape: InputShape = TRAIN_4K
    hw: HardwareProfile = H100_SXM
    budgets: Budgets = field(default_factory=Budgets)
    allow_offload: bool = True

    def __post_init__(self):
        self.supernet = ElasticSupernet(self.cfg, self.params)
        self.loop = AdaptationLoop(cfg=self.cfg, shape=self.shape,
                                   supernet=self.supernet, hw=self.hw,
                                   budgets=self.budgets,
                                   allow_offload=self.allow_offload)
        self.loop.build_pareto(evolve=False)

    # ------------------------------------------------------------ control --
    def adapt(self, ctx: ResourceContext) -> Decision:
        """One loop tick: monitor -> profile -> optimize -> reconfigure."""
        return self.loop.tick(ctx)

    def current_runtime(self) -> Tuple[ModelConfig, Params, RuntimeOptions]:
        if self.loop.current is None:
            self.adapt(ResourceContext())
        return self.loop.materialize()

    # ------------------------------------------------------------ serving --
    @torch.no_grad()
    def infer(self, tokens: torch.Tensor, **fwd_kw) -> torch.Tensor:
        """Logits of the current variant for ``tokens`` (B, S) on the
        params' device."""
        vcfg, vparams, opts = self.current_runtime()
        return forward(vparams, vcfg, tokens, opts, **fwd_kw)[0]

    def adapt_weights(self, live_tokens: torch.Tensor, lr: float = 1e-3
                      ) -> float:
        """Test-time adaptation on unlabeled live data (drift mitigation)."""
        self.current_runtime()
        new_params, ent = tta_step(self.supernet.backbone_params, self.cfg,
                                   live_tokens, lr=lr)
        self.supernet.backbone_params = new_params
        self.supernet._cache.clear()       # variants re-derive lazily
        return float(ent)

    def report(self) -> str:
        lines = ["tick  reason                      action"]
        for d in self.loop.decisions[-10:]:
            lines.append(f"{d.tick:4d}  {d.reason:26s} {d.action.describe()}")
        return "\n".join(lines)
