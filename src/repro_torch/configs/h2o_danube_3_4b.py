"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000,
    attn="swa", window=4096,
    source="arXiv:2401.16818",
)
