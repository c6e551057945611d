"""Assigned-architecture configs (``--arch <id>``).

One module per architecture; each exposes ``CONFIG`` (the exact assigned
full config) and ``SMOKE`` (a reduced same-family config for CPU smoke
tests). ``get_config(name, smoke=…)`` is the public lookup used by the
launcher and the tests. Copies of ``repro.configs``, which the port may
not import (``tests/test_torch_models.py`` checks them field-equal).
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "gemma2-9b",
    "command-r-35b",
    "stablelm-1.6b",
    "qwen3-0.6b",
    "musicgen-medium",
    "mixtral-8x22b",
    "kimi-k2-1t-a32b",
    "falcon-mamba-7b",
    "llama-3.2-vision-11b",
    "jamba-v0.1-52b",
]

_MODULES = {name: "repro_torch.configs." + name.replace("-", "_").replace(".", "_")
            for name in ARCHS}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {ARCHS}")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "get_config"]
