"""seamless-m4t-large-v2 — 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 — encoder-decoder, multimodal. [arXiv:2308.11596; hf]

Interpreted as 24 encoder + 24 decoder layers (text path).  The speech
frontend is a stub, as in the reference: the encoder takes precomputed frame
embeddings (``launch/inputs.py`` ``make_batch``).
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    encdec=True,
    n_layers=24,           # decoder layers
    n_enc_layers=24,       # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
)


def reduced() -> ModelConfig:
    return FULL.replace(
        name="seamless-reduced", n_layers=2, n_enc_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=192, vocab_size=512, d_head=16)
