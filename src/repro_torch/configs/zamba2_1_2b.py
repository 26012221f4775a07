"""zamba2-1.2b — Mamba2 backbone + shared attention block every 6 layers,
ssm_state=64. [arXiv:2411.15242; hf]"""
from .base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000,
    ssm=SSMCfg(state_dim=64, conv_dim=4, expand=2, head_dim=64),
    block_pattern="zamba2", shared_attn_every=6,
    source="arXiv:2411.15242",
)
