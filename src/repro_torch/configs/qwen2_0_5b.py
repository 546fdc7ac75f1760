"""qwen2-0.5b — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.

GQA, QKV bias, tied embeddings. [arXiv:2407.10671; hf]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1.0e6,
    tie_embeddings=True,
    # attn_seq_shard stays False: a GSPMD hint with no one-card counterpart
)


def reduced() -> ModelConfig:
    return FULL.replace(
        name="qwen2-0.5b-reduced", n_layers=2, d_model=112, n_heads=7,
        n_kv_heads=1, d_ff=256, vocab_size=512, d_head=16)
