"""Llama-4-Scout-17B-16E [moe]: 16 experts top-1 + shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", arch_type="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202048,
    num_experts=16, experts_per_token=1, moe_shared_expert=True,
    gated_ffn=True, activation="silu", rope_theta=5e5,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
