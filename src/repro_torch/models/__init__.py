from repro_torch.models.resnet import (init_resnet, resnet_accuracy,
                                       resnet_forward, resnet_loss)

__all__ = ["init_resnet", "resnet_forward", "resnet_loss", "resnet_accuracy"]
