from .configs import (ATTN, INPUT_SHAPES, LOCAL, MAMBA, SHARED_ATTN,
                      DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                      InputShape, ModelConfig, tokens_per_step)
from .model import (Cache, batched_prefill_admit, decode_step, init_cache,
                    init_paged_pool, init_paged_slot_cache,
                    init_slot_cache, paged_kernel_sample_batched_step,
                    paged_prefill_admit, prefill, sample_batched_step,
                    sample_logits)
from .runtime import DEFAULT_OPTIONS, RuntimeOptions
from .transformer import apply_stack, forward, init_params, lm_loss

__all__ = [
    "ModelConfig", "InputShape", "INPUT_SHAPES", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K", "tokens_per_step", "Cache", "init_cache",
    "init_params", "forward", "apply_stack", "lm_loss", "prefill",
    "decode_step", "init_slot_cache",
    "sample_batched_step", "batched_prefill_admit", "sample_logits",
    "init_paged_pool",
    "init_paged_slot_cache", "paged_kernel_sample_batched_step",
    "paged_prefill_admit", "RuntimeOptions", "DEFAULT_OPTIONS", "ATTN",
    "LOCAL", "MAMBA", "SHARED_ATTN",
]
