"""InternVL2-26B [vlm]: InternViT (STUB patch embeddings) + InternLM2
backbone.  [arXiv:2404.16821]"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", arch_type="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=16384, vocab_size=92553,
    gated_ffn=True, activation="silu",
    vision_embed_dim=3200, num_vision_tokens=256,
    source="arXiv:2404.16821",
)
