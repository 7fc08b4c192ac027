"""The cross-level action space (θ_p, θ_o, θ_s) the optimizer searches
(paper §III-D2).

θ_p — elastic model variant (compression-operator combination, η1…η6)
θ_o — offloading placement (pre-partition level + device pool cut)
θ_s — engine schedule (fusion, remat, KV dtype, chunking, sub-batching)
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..elastic.operators import FULL_SPEC, VariantSpec
from ..engine.schedule import EngineConfig


@dataclass(frozen=True)
class OffloadChoice:
    """θ_o: where (and at what granularity) to place the partitioned
    model.

    ``pool`` names the placement target.  With empty ``peers`` it is a
    key into the static ``offload.placer.DEVICE_POOLS`` (or a
    mesh-slice pipeline).  When ``peers`` is non-empty the target is a
    chain of live *fleet members* — ``peers[0]`` is the requesting
    device itself, the rest are helper device-ids — and the evaluator
    resolves it through its installed ``pool_resolver`` (the fleet
    placer synthesizing calibrated live profiles) instead of the static
    table; ``pool`` then serves only as a display label (``"fleet"``).
    """
    enabled: bool = False
    pool: str = "edge_pair"      # DEVICE_POOLS key, or "fleet" with peers
    level: int = 2               # pre-partition granularity
    peers: Tuple[str, ...] = ()  # live fleet chain; [0] = requester


@dataclass(frozen=True)
class Action:
    variant: VariantSpec = FULL_SPEC
    offload: OffloadChoice = OffloadChoice()
    engine: EngineConfig = EngineConfig()

    def describe(self) -> str:
        ops = "+".join(self.variant.operators()) or "full"
        target = (">".join(self.offload.peers) if self.offload.peers
                  else self.offload.pool)
        off = (f"offload[{target}/L{self.offload.level}]"
               if self.offload.enabled else "local")
        eng = (f"fuse={int(self.engine.fuse)},remat={self.engine.remat_policy},"
               f"kv={self.engine.kv_cache_dtype},streams={self.engine.parallel_streams}")
        return f"θp={ops} θo={off} θs=({eng})"


def default_action_space(variants: Sequence[VariantSpec],
                         allow_offload: bool = True,
                         decode: bool = False) -> Tuple[Action, ...]:
    """A tractable cross-product of the three levels."""
    engines = [
        EngineConfig(fuse=False, remat_policy="none"),
        EngineConfig(fuse=True, remat_policy="none"),
        EngineConfig(fuse=True, remat_policy="dots"),
        EngineConfig(fuse=True, remat_policy="full", sub_batches=2),
        EngineConfig(fuse=True, kv_cache_dtype="int8"),
    ]
    if decode:
        engines.append(EngineConfig(fuse=True, decode_window=8192))
    offloads = [OffloadChoice(False)]
    if allow_offload:
        offloads += [OffloadChoice(True, "edge_pair", 2),
                     OffloadChoice(True, "edge_trio", 2),
                     OffloadChoice(True, "pod_pipeline", 3)]
    actions = []
    for v, o, e in itertools.product(variants, offloads, engines):
        actions.append(Action(variant=v, offload=o, engine=e))
    return tuple(actions)
