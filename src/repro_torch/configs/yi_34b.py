"""Yi-34B [dense]: llama-arch GQA kv=8.  [arXiv:2403.04652]"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", arch_type="dense",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=20480, vocab_size=64000,
    gated_ffn=True, activation="silu", rope_theta=5e6,
    max_seq_len=200000,
    source="arXiv:2403.04652",
)
