"""internvl2-2b — InternViT patch-embed stub + InternLM2 LM backbone.
[arXiv:2404.16821; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553,
    frontend="vision", frontend_len=256,
    source="arXiv:2404.16821",
)
