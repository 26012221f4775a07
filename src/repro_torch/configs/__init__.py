"""Architecture registry of the port: ``get_config("<id>")`` accepts dashed
or underscored ids, as `repro.configs` does, and knows every config of the
JAX registry: the attention-block models (dense, MoE, the vision stub, the
encoder-decoder) and the recurrent ones (the xLSTM and the Mamba2
hybrid)."""
from __future__ import annotations

import importlib

from .base import SHAPES, SHAPES_BY_NAME, ArchConfig, MoECfg, ShapeCfg, SSMCfg

_MODULES = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "qwen3-32b": "qwen3_32b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "internvl2-2b": "internvl2_2b",
    "xlstm-1.3b": "xlstm_1_3b",
    "whisper-base": "whisper_base",
    "zamba2-1.2b": "zamba2_1_2b",
}

ARCH_IDS = tuple(_MODULES)


def _canon(name: str) -> str:
    n = name.strip().lower()
    for arch_id, mod in _MODULES.items():
        if n in (arch_id, mod, arch_id.replace("-", "_").replace(".", "_")):
            return arch_id
    raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")


def get_config(name: str) -> ArchConfig:
    arch_id = _canon(name)
    module = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return module.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {arch_id: get_config(arch_id) for arch_id in _MODULES}


__all__ = ["ArchConfig", "MoECfg", "SSMCfg", "ShapeCfg", "SHAPES",
           "SHAPES_BY_NAME", "ARCH_IDS", "get_config", "all_configs"]
