"""The paper's own evaluation backbone, adapted: a small elastic
transformer standing in for ResNet18/VGG16 in the CrowdHMTware
experiments (mobile CNNs do not transfer to a TPU LLM substrate; the
multi-branch/early-exit + compression-operator structure does).
Used by the middleware benchmarks and examples.
"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="paper-backbone", arch_type="dense",
    num_layers=8, d_model=256, num_heads=8, num_kv_heads=8,
    head_dim=32, d_ff=1024, vocab_size=2048,
    gated_ffn=True, activation="silu", max_seq_len=2048,
    source="CrowdHMTware §IV (substrate-adapted)",
)
