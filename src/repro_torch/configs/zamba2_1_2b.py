"""Zamba2-1.2B [hybrid]: Mamba2 blocks + ONE shared attention block
applied every 6 mamba blocks (weight recycling, per the paper's
η2-style squeeze).  [arXiv:2411.15242]"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", arch_type="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=8192, vocab_size=32000,
    ssm_state_dim=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    shared_attn_period=6,
    gated_ffn=True, activation="gelu",
    source="arXiv:2411.15242",
)
