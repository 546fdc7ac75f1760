"""yi-9b — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

llama-arch GQA. [arXiv:2403.04652; hf]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64_000,
    rope_theta=5.0e6,
)


def reduced() -> ModelConfig:
    return FULL.replace(
        name="yi-9b-reduced", n_layers=3, d_model=128, n_heads=8,
        n_kv_heads=2, d_ff=384, vocab_size=512, d_head=16)
