"""zamba2-2.7b — 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  Mamba2 backbone + shared-weight attention blocks applied every
6 layers (9 applications, separate KV per application). [arXiv:2411.15242; hf]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32_000,
    ssm=True,
    d_state=64,
    headdim=64,            # d_inner = 5120 -> 80 ssd heads
    expand=2,
    ssd_chunk=128,
    attn_every=6,
)


def reduced() -> ModelConfig:
    return FULL.replace(
        name="zamba2-2.7b-reduced", n_layers=4, attn_every=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=192, d_state=16, headdim=16,
        ssd_chunk=16, vocab_size=512)
