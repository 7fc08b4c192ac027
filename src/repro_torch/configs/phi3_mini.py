"""BONUS (beyond the assigned 10): Phi-3-mini-4k [dense] — 3.8B small
dense LLM.  [arXiv:2404.14219]"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini", arch_type="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    head_dim=96, d_ff=8192, vocab_size=32064,
    gated_ffn=True, activation="silu",
    source="arXiv:2404.14219 (bonus arch)",
)
