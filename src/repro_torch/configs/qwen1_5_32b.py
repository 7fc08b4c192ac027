"""Qwen1.5-32B [dense]: QKV bias, MHA (kv=40).  [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", arch_type="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    head_dim=128, d_ff=27392, vocab_size=152064,
    qkv_bias=True, gated_ffn=True, activation="silu",
    rope_theta=1e6, max_seq_len=32768,
    source="hf:Qwen/Qwen1.5-0.5B (scaled per assignment)",
)
