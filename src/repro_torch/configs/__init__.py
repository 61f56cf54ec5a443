"""Architecture registry: ``--arch <id>`` resolution.

``get_config(name)`` returns the full published config and
``get_config(name, reduced=True)`` the reduced test variant.  The port
serves smollm-135m so far; every other arch of the JAX package is named
here with the slice of the port that brings it (see ROADMAP.md), and
asking for one raises.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "smollm-135m": "smollm_135m",
}

# Arch -> the later slice of the port that brings it.
_LATER = {
    "gemma2-27b": "the other-archs slice (ring windows, softcap, post norms)",
    "qwen3-0.6b": "the other-archs slice (qk_norm)",
    "olmo-1b": "the other-archs slice (non-parametric layernorm)",
    "deepseek-v3-671b": "the other-archs slice (MLA with v_width, MoE)",
    "kimi-k2-1t-a32b": "the other-archs slice (MLA, MoE)",
    "qwen2-vl-72b": "the other-archs slice (M-RoPE, patch embeds)",
    "jamba-v0.1-52b": "the other-archs slice (mamba, MoE)",
    "xlstm-1.3b": "the other-archs slice (mLSTM/sLSTM)",
    "whisper-tiny": "the other-archs slice (encoder-decoder)",
}

ARCH_NAMES = tuple(_MODULES) + tuple(_LATER)


def get_config(name: str, reduced: bool = False, **overrides) -> ModelConfig:
    if name in _LATER:
        raise NotImplementedError(
            f"{name} is not ported yet; it comes with {_LATER[name]}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg = mod.REDUCED if reduced else mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


__all__ = ["ARCH_NAMES", "get_config", "ModelConfig"]
