"""The port's kernels: hand-written CUDA for Hopper, each with a plain
PyTorch version beside it (:mod:`repro_torch.kernels.ref`)."""
from . import ops, ref
from .act_quant import kv_dequant_rows, kv_quant_rows
from .paged_decode_attn import paged_decode_attention

__all__ = ["ops", "ref", "kv_dequant_rows", "kv_quant_rows",
           "paged_decode_attention"]
