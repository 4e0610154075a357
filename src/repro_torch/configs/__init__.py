"""Config registry.

``get_config(arch_id)`` returns an LM architecture's published spec and
``get_reduced`` its CPU-smoke variant, for each of the reference's ten
architectures (``ARCH_IDS``). The paper's own ResNet workload is separate
(``paper_resnet_speech``).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs.paper_resnet_speech import CONFIG, ResNetConfig, reduced

ARCH_IDS = ("phi3-mini-3.8b", "phi4-mini-3.8b", "zamba2-1.2b",
            "deepseek-v2-236b", "olmo-1b", "llama4-scout-17b-a16e",
            "falcon-mamba-7b", "internvl2-2b", "minicpm3-4b",
            "musicgen-large")


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


__all__ = ["ARCH_IDS", "CONFIG", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "ResNetConfig", "get_config", "get_reduced", "reduced"]
