"""qwen3-14b — 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.

qk-norm (per-head RMSNorm on q/k), GQA. [hf:Qwen/Qwen3-8B family; hf]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1.0e6,
    # attn_seq_shard stays False: a GSPMD hint with no one-card counterpart
)


def reduced() -> ModelConfig:
    return FULL.replace(
        name="qwen3-14b-reduced", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=320, vocab_size=512, d_head=32)
