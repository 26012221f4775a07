"""Architecture registry of the port: ``get_config("<id>")`` accepts dashed
or underscored ids, as `repro.configs` does, but knows only the configs the
port runs (the dense ``attn`` family without MoE). The others are named so
that asking for one says why it fails."""
from __future__ import annotations

import importlib

from .base import SHAPES, SHAPES_BY_NAME, ArchConfig, MoECfg, ShapeCfg, SSMCfg

_MODULES = {"tinyllama-1.1b": "tinyllama_1_1b"}

# The JAX package's other architectures: MoE, recurrent and encoder-decoder
# blocks, vision and audio frontends, which the port has not taken yet.
NOT_PORTED = ("moonshot-v1-16b-a3b", "qwen2-moe-a2.7b", "h2o-danube-3-4b",
              "qwen3-32b", "phi4-mini-3.8b", "internvl2-2b", "xlstm-1.3b",
              "whisper-base", "zamba2-1.2b")

ARCH_IDS = tuple(_MODULES)


def _canon(name: str) -> str:
    n = name.strip().lower()
    for arch_id in (*_MODULES, *NOT_PORTED):
        if n in (arch_id, arch_id.replace("-", "_").replace(".", "_")):
            return arch_id
    raise KeyError(f"unknown arch {name!r}; known: {[*_MODULES, *NOT_PORTED]}")


def get_config(name: str) -> ArchConfig:
    arch_id = _canon(name)
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP Queue 1 item 12); "
            f"the port runs {list(_MODULES)}")
    module = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return module.CONFIG


__all__ = ["ArchConfig", "MoECfg", "SSMCfg", "ShapeCfg", "SHAPES",
           "SHAPES_BY_NAME", "ARCH_IDS", "NOT_PORTED", "get_config"]
