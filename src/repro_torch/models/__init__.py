from repro_torch.models.resnet import (init_resnet, resnet_accuracy,
                                       resnet_forward, resnet_loss)
from repro_torch.models.transformer import (build_stages, decode_step,
                                            forward_logits, init_cache,
                                            init_params, loss_fn)

__all__ = ["build_stages", "decode_step", "forward_logits", "init_cache",
           "init_params", "init_resnet", "loss_fn", "resnet_forward",
           "resnet_loss", "resnet_accuracy"]
