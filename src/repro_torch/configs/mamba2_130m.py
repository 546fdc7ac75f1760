"""mamba2-130m — 24L d_model=768, attention-free SSD, ssm_state=128,
vocab=50280.  State-space duality. [arXiv:2405.21060]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,            # unused (attention-free)
    n_kv_heads=12,
    d_ff=0,
    vocab_size=50_280,
    ssm=True,
    d_state=128,
    headdim=64,            # d_inner = 1536 -> 24 ssd heads
    expand=2,
    ssd_chunk=128,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return FULL.replace(
        name="mamba2-130m-reduced", n_layers=2, d_model=64, d_state=16,
        headdim=16, ssd_chunk=16, vocab_size=512)
