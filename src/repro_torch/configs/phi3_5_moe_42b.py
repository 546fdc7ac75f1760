"""phi3.5-moe-42b-a6.6b — 32L d_model=4096 32H (GQA kv=8) d_ff=6400 per
expert, vocab=32064, MoE 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    moe=True,
    n_experts=16,
    top_k=2,
    d_ff_expert=6400,
)


def reduced() -> ModelConfig:
    return FULL.replace(
        name="phi3.5-moe-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, d_ff_expert=128, n_experts=4, top_k=2,
        vocab_size=512, d_head=16)
