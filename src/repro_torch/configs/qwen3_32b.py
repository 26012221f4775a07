"""qwen3-32b — dense GQA with qk-norm, head_dim=128.
[hf:Qwen/Qwen3-8B family; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    d_ff=25600, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6, tie_embeddings=False,
    source="hf:Qwen/Qwen3-32B",
)
