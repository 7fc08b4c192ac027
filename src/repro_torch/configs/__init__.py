"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

Every assigned architecture (plus the paper's own evaluation backbone) is
a selectable config; reduced same-family variants for CPU smoke tests come
from ``get_config(arch_id).reduced()``.
"""
from __future__ import annotations

from repro_torch.models.configs import ModelConfig

from . import (gemma3_12b, gemma_7b, internvl2_26b, llama4_scout_17b_a16e,
               mamba2_370m, mixtral_8x7b, olmoe_1b_7b, paper_backbone,
               phi3_mini, qwen1_5_32b, whisper_small, yi_34b, zamba2_1_2b)

_REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen1_5_32b, yi_34b, llama4_scout_17b_a16e, mamba2_370m,
              whisper_small, olmoe_1b_7b, gemma3_12b, internvl2_26b,
              gemma_7b, zamba2_1_2b, paper_backbone, mixtral_8x7b,
              phi3_mini)
}

ASSIGNED_ARCHS = (
    "qwen1.5-32b", "yi-34b", "llama4-scout-17b-a16e", "mamba2-370m",
    "whisper-small", "olmoe-1b-7b", "gemma3-12b", "internvl2-26b",
    "gemma-7b", "zamba2-1.2b",
)

# beyond the assignment: extra pool archs proving the config system
# generalizes (NOT part of the canonical 10x4 dry-run grid)
BONUS_ARCHS = ("mixtral-8x7b", "phi3-mini")


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return list(ASSIGNED_ARCHS)
