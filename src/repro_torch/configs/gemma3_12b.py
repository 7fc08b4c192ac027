"""Gemma3-12B [dense]: 5 local : 1 global attention, 128k context.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", arch_type="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    head_dim=256, d_ff=15360, vocab_size=262144,
    gated_ffn=True, activation="gelu",
    local_global_ratio=5, sliding_window=1024, rope_theta=1e6,
    max_seq_len=131072,
    source="hf:google/gemma-3-1b-pt (scaled per assignment)",
)
