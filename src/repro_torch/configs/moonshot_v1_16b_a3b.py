"""moonshot-v1-16b-a3b — Kimi/Moonlight-style MoE, 64 routed experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840,
    moe=MoECfg(n_experts=64, top_k=6, n_shared=0),
    source="hf:moonshotai/Moonlight-16B-A3B",
)
