"""Static PyTorch-hazard lint pass + runtime sanitizers for the port.

The static half (``engine``/``rules``/``callgraph``/``__main__``) is
stdlib-only, so the lint runs without torch. The runtime half
(``runtime``: ``strict_mode``, ``setup_transfers``, ``device_get``,
``retrace_guard``) imports torch, and is exposed through module
``__getattr__`` so ``import repro_torch.analysis`` never pulls it in.
"""
from repro_torch.analysis.engine import Finding, Report, analyze  # noqa: F401

_RUNTIME = ("strict_mode", "setup_transfers", "device_get", "retrace_guard",
            "CompileLog")


def __getattr__(name):
    if name in _RUNTIME:
        from repro_torch.analysis import runtime
        return getattr(runtime, name)
    raise AttributeError(f"module 'repro_torch.analysis' has no attribute "
                         f"{name!r}")


__all__ = ["Finding", "Report", "analyze", *_RUNTIME]
