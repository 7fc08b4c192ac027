"""Whisper-small [audio]: enc-dec; conv/mel frontend is a STUB — the
encoder consumes precomputed frame embeddings.  [arXiv:2212.04356]"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", arch_type="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    head_dim=64, d_ff=3072, vocab_size=51865,
    gated_ffn=False, activation="gelu",
    is_encoder_decoder=True, encoder_layers=12, encoder_seq_len=1500,
    source="arXiv:2212.04356",
)
