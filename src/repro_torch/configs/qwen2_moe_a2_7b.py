"""qwen2-moe-a2.7b — 4 shared + 60 routed experts top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936,
    moe=MoECfg(n_experts=60, top_k=4, n_shared=4),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
