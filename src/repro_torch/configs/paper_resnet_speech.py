"""The paper's own FL workload: ResNet on Google-Speech-Commands-style input.

EAFL's evaluation (Sec. 5) trains a ResNet speech classifier (35 keyword
classes). The synthetic dataset (``repro_torch.data``) keeps the input
geometry (1x32x32) and the 35 classes.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ResNetConfig:
    name: str = "paper-resnet-speech"
    source: str = "EAFL Sec.5 [arXiv:2208.04505-style setup]; He et al. CVPR'16"
    n_classes: int = 35
    in_channels: int = 1
    width: int = 16               # stem width; stages = (w, 2w, 4w)
    blocks_per_stage: int = 2     # ResNet-14-ish: fits edge-device simulation
    input_hw: int = 32


CONFIG = ResNetConfig()


def reduced() -> ResNetConfig:
    return ResNetConfig(width=8, blocks_per_stage=1, input_hw=16)
