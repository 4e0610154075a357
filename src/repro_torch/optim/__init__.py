from repro_torch.optim.optimizers import (
    SERVER_OPTIMIZERS,
    Optimizer,
    adagrad,
    adam,
    adamw,
    apply_updates,
    sgd,
    yogi,
)

__all__ = ["Optimizer", "apply_updates", "sgd", "adam", "adamw", "yogi",
           "adagrad", "SERVER_OPTIMIZERS"]
