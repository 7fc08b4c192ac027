"""Runtime (engine-selected) execution options.

This is the θ_s action surface of the paper's back-end engine (§III-C) as it
exists on TPU: attention implementation / chunking, rematerialization policy,
KV-cache numerics, decode windowing and MoE capacity.  The middleware
optimizer mutates these; the model code only *reads* them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class RuntimeOptions:
    attn_impl: str = "auto"        # auto | full | chunked | banded
    q_chunk: int = 512
    k_chunk: int = 1024
    decode_window: int = 0         # 0 = attend to the full KV cache
    remat: str = "none"            # none | dots | full
    # The JAX package's switch for its Pallas kernels.  In the port the
    # tensor's device picks the kernel (the hand-written CUDA kernel on
    # the card, its plain version on the CPU); the field is kept only so
    # that EngineConfig.to_runtime_options gives the JAX options.
    use_pallas: bool = False
    kv_cache_dtype: str = "bfloat16"
    moe_capacity_factor: float = 1.0
    logit_chunk: int = 0           # chunk the LM loss over sequence (0 = off)
    scan_layers: bool = True
    # §Perf: sequence-parallel activation sharding between blocks — the
    # residual stream is constrained to (batch, seq->axis, none) so TP
    # partial-sum all-reduces become reduce-scatter (+ per-block gather)
    seq_shard_axis: str = ""
    # §Perf: constrain FFN hidden activations to (batch, seq, f->axis) so
    # the up/gate matmul outputs stay sharded on d_ff (matching the weight
    # sharding) and only the (B,S,D)-sized w_down output is reduced
    ffn_shard_axis: str = ""
    # Paged-pool storage dtype: "auto" follows kv_cache_dtype; "int8" stores
    # KV blocks as int8 with per-row f32 scales (~4x resident slots per
    # device).  Only read by decode_mode="paged"; dense caches keep
    # kv_cache_dtype.
    kv_dtype: str = "auto"
    # Paged decode reads KV straight from block tables via the Pallas
    # decode-attention op instead of gathering the pool to dense first.
    # Tables stay runtime data either way, so flipping this only changes
    # which program the CompileCache builds — never how it is keyed.
    paged_kernel: bool = False

    def replace(self, **kw) -> "RuntimeOptions":
        return dataclasses.replace(self, **kw)


DEFAULT_OPTIONS = RuntimeOptions()
