"""qwen2-vl-2b — 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

M-RoPE (3D rotary over temporal/height/width ids), dynamic resolution.
[arXiv:2409.12191; hf].  The vision frontend is a stub: a batch carries
merged token ids plus precomputed 3D position ids (``positions``,
``[B, S, 3]``).
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),   # head_dim 128 -> half 64
    rope_theta=1.0e6,
    tie_embeddings=True,
    # attn_seq_shard stays False: a GSPMD hint with no one-card counterpart
)


def reduced() -> ModelConfig:
    return FULL.replace(
        name="qwen2-vl-2b-reduced", n_layers=2, d_model=96, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab_size=512, d_head=24,
        mrope_sections=(4, 4, 4))
