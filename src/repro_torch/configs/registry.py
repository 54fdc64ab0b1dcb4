"""Architecture registry of the port.

The port serves the GQA attention-only family; ``llama31_8b`` is its
first configuration.  Each config module carries the full-size
:class:`ModelConfig` and a ``reduced()`` factory for CPU tests.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = ["llama31_8b"]


def _module(arch: str):
    arch = arch.replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return _module(arch).reduced()
