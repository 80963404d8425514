"""Config registry of the port: the reference's ten architectures, of
the dense, MoE, ssm, hybrid, vlm and encdec families.

Counterpart of ``repro/configs/__init__.py`` and of ``parse_arch`` in
``repro/launch/train.py``.
"""

from __future__ import annotations

import importlib

from .common import smoke_reduce

__all__ = ["ARCH_NAMES", "get_config", "smoke_config", "parse_arch",
           "smoke_reduce"]

_ARCH_MODULES = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "gemma2-27b": "gemma2_27b",
    "chatglm3-6b": "chatglm3_6b",
    "olmo-1b": "olmo_1b",
    "qwen3-4b": "qwen3_4b",
    "whisper-base": "whisper_base",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

ARCH_NAMES = list(_ARCH_MODULES)


def get_config(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f".{_ARCH_MODULES[name]}", __package__)
    return mod.ARCH


def smoke_config(name: str):
    return smoke_reduce(get_config(name))


def parse_arch(name: str):
    """``<id>`` or ``smoke:<id>`` (the reduced config)."""
    if name.startswith("smoke:"):
        return smoke_config(name.split(":", 1)[1])
    return get_config(name)
