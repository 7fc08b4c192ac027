"""BONUS (beyond the assigned 10): Mixtral-8x7B [moe] — 8 experts top-2,
the canonical open MoE.  [arXiv:2401.04088]"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", arch_type="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=32000,
    num_experts=8, experts_per_token=2,
    gated_ffn=True, activation="silu", rope_theta=1e6,
    sliding_window=4096,
    source="arXiv:2401.04088 (bonus arch)",
)
