"""xlstm-1.3b — sLSTM + mLSTM blocks (7:1), no FFN (d_ff=0).
[arXiv:2405.04517; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    block_pattern="xlstm_7_1",
    source="arXiv:2405.04517",
)
