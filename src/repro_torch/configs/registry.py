"""Registry mapping ``--arch`` ids to ModelConfigs. Mirrors
``repro/configs/registry.py``: the same ids, each config a field-for-field
copy of the reference's."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "llava-next-mistral-7b",
    "llama3-8b",
    "yi-9b",
    "codeqwen1.5-7b",
    "qwen2-0.5b",
    "whisper-large-v3",
    "jamba-1.5-large-398b",
    "dbrx-132b",
    "kimi-k2-1t-a32b",
    "xlstm-125m",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
