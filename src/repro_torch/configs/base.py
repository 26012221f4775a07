"""Architecture + run configuration; copy of `repro.configs.base`
(framework-free).

Every architecture is one `ArchConfig` in its own module; the registry
resolves ``<id>`` (dashes or underscores). `reduced()` returns the
family-faithful small config the CPU parity tests instantiate; the full
config is what the serve path runs on the card.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    n_shared: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMCfg:
    state_dim: int = 64
    conv_dim: int = 4
    expand: int = 2
    head_dim: int = 64


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    attn: str = "full"              # full | swa
    window: int = 4096
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    block_pattern: str = "attn"     # attn | xlstm_7_1 | zamba2 | encdec
    shared_attn_every: int = 6      # zamba2 shared-block period
    enc_layers: int = 0             # whisper encoder depth
    frontend: str = "none"          # none | audio | vision (stubs)
    frontend_len: int = 0           # precomputed frames / patches
    source: str = ""                # provenance note

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded so the vocab dim shards over any mesh axis
        up to 32 (MaxText-style padding; pad logits masked in the loss)."""
        return -(-self.vocab // 512) * 512

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell ."""
        return self.family in ("ssm", "hybrid") or self.attn == "swa"

    @property
    def is_encdec(self) -> bool:
        return self.block_pattern == "encdec"

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model FLOPs)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_padded
        h, kh, dh = self.n_heads, self.n_kv_heads, self.head_dim_
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * h * dh + 2 * d * kh * dh + h * dh * d
        per_layer = 0
        if self.block_pattern == "attn":
            mlp = 3 * d * ff
            if self.moe:
                mlp = self.moe.n_experts * 3 * d * ff + d * self.moe.n_experts
                mlp += self.moe.n_shared * 3 * d * ff
            per_layer = attn + mlp + 2 * d
            total = emb + self.n_layers * per_layer
        elif self.block_pattern == "xlstm_7_1":
            mlstm = 2 * d * 2 * d + 3 * d * d + d * 2 * h + d * d
            slstm = d * 4 * d + h * self.head_dim_ ** 2 * 4 + d * d
            n_s = self.n_layers // 8
            total = emb + (self.n_layers - n_s) * mlstm + n_s * slstm
        elif self.block_pattern == "zamba2":
            inner = self.ssm.expand * d
            mamba = d * (2 * inner + 2 * self.ssm.state_dim + inner // self.ssm.head_dim) + inner * d
            shared = attn + 3 * d * ff
            total = emb + self.n_layers * mamba + shared
        elif self.block_pattern == "encdec":
            mlp = 3 * d * ff
            total = emb + (self.enc_layers + self.n_layers) * (attn + mlp) + self.n_layers * attn
        else:
            total = emb + self.n_layers * (attn + 3 * d * ff)
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: routed top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_like = self.param_count() - self.n_layers * (
            self.moe.n_experts * 3 * d * ff
        )
        return int(dense_like + self.n_layers * self.moe.top_k * 3 * d * ff)

    def reduced(self) -> "ArchConfig":
        """Family-faithful small config for CPU smoke tests."""
        def shrink(v, cap):
            return min(v, cap)

        kw = dict(
            n_layers=shrink(self.n_layers, 4 if self.block_pattern != "xlstm_7_1" else 8),
            d_model=shrink(self.d_model, 128),
            n_heads=shrink(self.n_heads, 4),
            n_kv_heads=shrink(self.n_kv_heads, 2 if self.n_kv_heads < self.n_heads else 4),
            d_ff=shrink(self.d_ff, 256) if self.d_ff else 0,
            vocab=shrink(self.vocab, 512),
            head_dim=32 if self.head_dim else 0,
            window=shrink(self.window, 32),
            enc_layers=shrink(self.enc_layers, 2),
            frontend_len=shrink(self.frontend_len, 8),
            shared_attn_every=min(self.shared_attn_every, 2),
        )
        if self.moe:
            kw["moe"] = MoECfg(n_experts=8, top_k=min(self.moe.top_k, 2),
                               n_shared=min(self.moe.n_shared, 1))
        if self.ssm:
            kw["ssm"] = SSMCfg(state_dim=16, conv_dim=4, expand=2, head_dim=32)
        if kw["n_kv_heads"] > kw["n_heads"]:
            kw["n_kv_heads"] = kw["n_heads"]
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCfg:
    """One input-shape cell (assigned per architecture)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeCfg, ...] = (
    ShapeCfg("train_4k", 4096, 256, "train"),
    ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    ShapeCfg("decode_32k", 32768, 128, "decode"),
    ShapeCfg("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
