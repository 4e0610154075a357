from repro_torch.checkpoint.checkpoint import (CheckpointError, load_checkpoint,
                                               save_checkpoint)
from repro_torch.checkpoint.engine import (CarryCheckpointer,
                                           checkpoint_path_for,
                                           load_engine_checkpoint,
                                           save_engine_checkpoint,
                                           segment_bounds, tree_flatten,
                                           tree_unflatten)

__all__ = ["CarryCheckpointer", "CheckpointError", "checkpoint_path_for",
           "load_checkpoint", "load_engine_checkpoint",
           "save_checkpoint", "save_engine_checkpoint", "segment_bounds",
           "tree_flatten", "tree_unflatten"]
