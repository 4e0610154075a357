from repro_torch.configs.paper_resnet_speech import CONFIG, ResNetConfig, reduced

__all__ = ["CONFIG", "ResNetConfig", "reduced"]
