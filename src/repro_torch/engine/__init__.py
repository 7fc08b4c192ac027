from .act_compress import (compressed_bytes, compression_error,
                           dequantize_int4, dequantize_int8, quantize_int4,
                           quantize_int8)
from .fusion import STRATEGIES, FusionReport, fuse_graph, fusion_memory_saving
from .memory import (AllocationPlan, greedy_no_reuse, peak_live_bytes,
                     plan_memory, tensor_lifetimes)
from .remat import (POLICY_LADDER, RematDecision, activation_bytes,
                    choose_policy, sub_batch_split)
from .schedule import (EngineConfig, ParallelPlan, backprop_reorder_savings,
                       plan_parallelism)
from .swap import Swapper, swap_overlap_latency, swap_plan

__all__ = ["compressed_bytes", "compression_error", "dequantize_int4",
           "dequantize_int8", "quantize_int4", "quantize_int8", "STRATEGIES",
           "FusionReport", "fuse_graph", "fusion_memory_saving",
           "AllocationPlan", "greedy_no_reuse", "peak_live_bytes",
           "plan_memory", "tensor_lifetimes", "POLICY_LADDER",
           "RematDecision", "activation_bytes", "choose_policy",
           "sub_batch_split", "EngineConfig", "ParallelPlan",
           "backprop_reorder_savings", "plan_parallelism", "Swapper",
           "swap_overlap_latency", "swap_plan"]
