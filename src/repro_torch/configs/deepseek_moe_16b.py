"""deepseek-moe-16b — 28L d_model=2048 16H (kv=16) d_ff=1408 per expert,
vocab=102400, MoE 2 shared + 64 routed top-6 (fine-grained experts).
[arXiv:2401.06066; hf]

Deviation (DESIGN.md §5): the HF checkpoint's dense layer 0 is made MoE for
scan homogeneity.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    moe=True,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
)


def reduced() -> ModelConfig:
    return FULL.replace(
        name="deepseek-moe-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=96, d_ff_expert=96, n_experts=8,
        n_shared_experts=1, top_k=2, vocab_size=512, d_head=16)
