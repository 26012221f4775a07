"""whisper-base — encoder-decoder, conv audio frontend (stub: precomputed
frame embeddings). [arXiv:2212.04356; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865,
    block_pattern="encdec", enc_layers=6,
    frontend="audio", frontend_len=1500,
    source="arXiv:2212.04356",
)
