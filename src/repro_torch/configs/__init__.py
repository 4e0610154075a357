"""Config registry.

``get_config(arch_id)`` returns an LM architecture's published spec and
``get_reduced`` its CPU-smoke variant, for the architectures the port runs
so far; ``ARCH_IDS`` lists all ten of the reference's. The paper's own
ResNet workload is separate (``paper_resnet_speech``).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs.paper_resnet_speech import CONFIG, ResNetConfig, reduced

ARCH_IDS = ("phi3-mini-3.8b", "phi4-mini-3.8b", "zamba2-1.2b",
            "deepseek-v2-236b", "olmo-1b", "llama4-scout-17b-a16e",
            "falcon-mamba-7b", "internvl2-2b", "minicpm3-4b",
            "musicgen-large")
_PORTED = {"zamba2-1.2b": "zamba2_1_2b",
           "falcon-mamba-7b": "falcon_mamba_7b", "olmo-1b": "olmo_1b",
           "phi4-mini-3.8b": "phi4_mini_3_8b",
           "phi3-mini-3.8b": "phi3_mini_3_8b", "minicpm3-4b": "minicpm3_4b",
           "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
           "deepseek-v2-236b": "deepseek_v2_236b"}


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    if arch_id not in _PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: the vision frontend and the "
            f"multi-codebook heads are missing (ROADMAP.md queue 1 item 16); "
            f"ported: {sorted(_PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{_PORTED[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


__all__ = ["ARCH_IDS", "CONFIG", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "ResNetConfig", "get_config", "get_reduced", "reduced"]
