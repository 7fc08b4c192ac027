"""The port's kernels: hand-written CUDA for Hopper, each with a plain
PyTorch version beside it (:mod:`repro_torch.kernels.ref`)."""
from . import ops, ref
from .act_quant import kv_dequant_rows, kv_quant_rows
from .flash_attn import flash_attention
from .fused_ffn import fused_ffn
from .ops import attention, gated_ffn, ssd
from .paged_decode_attn import paged_decode_attention
from .ssd_scan import ssd_scan

__all__ = ["ops", "ref", "attention", "flash_attention", "fused_ffn",
           "gated_ffn", "kv_dequant_rows", "kv_quant_rows",
           "paged_decode_attention", "ssd", "ssd_scan"]
