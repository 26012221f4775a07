"""phi4-mini-3.8b — RoPE SwiGLU GQA, 200k vocab (largest assigned vocab —
the most ProMIPS-representative decode cell). [arXiv:2412.08905; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064,
    source="arXiv:2412.08905",
)
