"""Mamba2-370m [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", arch_type="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state_dim=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    inapplicable_operators=("window_scaling",),
    source="arXiv:2405.21060",
)
