"""Batched serving demo: prompt replay + cached greedy decode, full cache or
a sliding-window ring, on the CUDA card unless ``--device cpu``.

The twin of the reference's ``examples/serve_decode.py``: it runs the
port's serving driver (``repro_torch.launch.serve``) at the example's
defaults, ``--arch phi3-mini-3.8b --batch 2 --prompt-len 16 --gen 8`` (the
reduced config, random weights from ``--seed``); any argument given
overrides its default.

  python -m repro_torch.examples.serve_decode [--arch minicpm3-4b] \\
      [--window 8] [--device cpu]
"""
import sys
from typing import Optional, Sequence

from repro_torch.launch import serve

DEFAULTS = ["--arch", "phi3-mini-3.8b", "--batch", "2", "--prompt-len", "16",
            "--gen", "8"]


def main(argv: Optional[Sequence[str]] = None) -> serve.Generation:
    args = list(sys.argv[1:] if argv is None else argv)
    return serve.main(DEFAULTS + args)


if __name__ == "__main__":
    main()
