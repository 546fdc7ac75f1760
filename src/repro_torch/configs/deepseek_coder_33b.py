"""deepseek-coder-33b — 62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.

llama-arch. [arXiv:2401.14196; hf]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32_256,
    rope_theta=1.0e5,
    # attn_seq_shard stays False: a GSPMD hint with no one-card counterpart
)


def reduced() -> ModelConfig:
    return FULL.replace(
        name="deepseek-coder-33b-reduced", n_layers=3, d_model=128, n_heads=8,
        n_kv_heads=2, d_ff=320, vocab_size=512, d_head=16)
