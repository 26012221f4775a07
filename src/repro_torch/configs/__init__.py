"""Architecture registry of the port: ``get_config("<id>")`` accepts dashed
or underscored ids, as `repro.configs` does, but knows only the configs the
port runs (the attention-block models: dense, MoE, the vision stub and the
encoder-decoder). The recurrent ones are named so that asking for one says
why it fails."""
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
    "whisper-base": "whisper_base",
}

# The JAX package's recurrent architectures (the xLSTM and the Mamba2
# hybrid), which the port has not taken yet.
NOT_PORTED = ("xlstm-1.3b", "zamba2-1.2b")

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
            f"arch {arch_id!r} (a recurrent or hybrid family) is not ported "
            f"yet (ROADMAP Queue 1 item 12); "
            f"the port runs {list(_MODULES)}")
    module = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return module.CONFIG


__all__ = ["ArchConfig", "MoECfg", "SSMCfg", "ShapeCfg", "SHAPES",
           "SHAPES_BY_NAME", "ARCH_IDS", "NOT_PORTED", "get_config"]
