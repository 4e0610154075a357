"""Step functions, the serving loop, the dry-run and roofline of the LM
path, and the client meshes of the federated engines.

NOTE: the dry-run (``launch/dryrun.py``) is imported by its entry point
only; the spec functions it traces on are exported here, as the
reference's ``repro.launch`` exports them.
"""
from repro_torch.launch.specs import (cache_len_for, cache_specs,
                                      input_specs, params_specs)

__all__ = ["cache_len_for", "cache_specs", "input_specs", "params_specs"]
