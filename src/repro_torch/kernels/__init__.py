"""The port's kernels: hand-written CUDA for Hopper, each with a plain
PyTorch version beside it (:mod:`repro_torch.kernels.ref`)."""
from . import ops, ref
from .act_quant import (act_dequant, act_dequant4, act_quant, act_quant4,
                        kv_dequant_rows, kv_quant_rows)
from .flash_attn import flash_attention
from .fused_ffn import fused_ffn
from .ops import (attention, dequantize_activations, gated_ffn,
                  quantize_activations, ssd)
from .paged_decode_attn import paged_decode_attention
from .ssd_scan import ssd_scan

# every wrapper that counts its kernel's launches (``fn.launches``): a
# decode step replayed as a CUDA graph adds the launches it captured
COUNTED_KERNELS = (paged_decode_attention, flash_attention, fused_ffn,
                   ssd_scan, act_quant, act_dequant, act_quant4,
                   act_dequant4)

__all__ = ["COUNTED_KERNELS", "ops", "ref", "act_dequant", "act_dequant4", "act_quant",
           "act_quant4", "attention", "dequantize_activations",
           "flash_attention", "fused_ffn", "gated_ffn", "kv_dequant_rows",
           "kv_quant_rows", "paged_decode_attention",
           "quantize_activations", "ssd", "ssd_scan"]
