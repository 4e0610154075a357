"""Quickstart: EAFL vs Oort vs Random on the paper's battery-powered FL task.

The end-to-end driver of the paper's kind of system: real federated
training (ResNet on non-IID speech-like data, YoGi aggregation) under the
event-driven energy simulation, on the CUDA card unless ``--device cpu``.
Defaults are sized for a quick run; ``--rounds 150 --clients 200`` is the
paper-scale comparison.

  python -m repro_torch.examples.quickstart [--rounds 30] [--device cpu]
"""
import argparse
from typing import Dict, Optional, Sequence

from repro_torch.configs.paper_resnet_speech import reduced
from repro_torch.core.selection import SelectorConfig
from repro_torch.federated import FLConfig, FLHistory, run_fl


def fl_config(kind: str, rounds: int, clients: int, f: float) -> FLConfig:
    return FLConfig(
        selector=SelectorConfig(kind=kind, k=8, f=f),
        n_clients=clients, rounds=rounds, local_steps=6, batch_size=10,
        samples_per_client=48, eval_every=5, eval_samples=280,
        model=reduced(), input_hw=16,
        init_battery_low=8.0, init_battery_high=60.0)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, FLHistory]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=60)
    ap.add_argument("--f", type=float, default=0.25, help="Eq.1 weight")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    results = {}
    for kind in ("eafl", "oort", "random"):
        cfg = fl_config(kind, args.rounds, args.clients, args.f)
        results[kind] = h = run_fl(cfg, device=args.device)
        print(f"{kind:7s} acc={h.test_acc[-1]:.3f} "
              f"dropouts={h.cum_dropouts[-1]:3d} "
              f"fairness={h.fairness[-1]:.3f} "
              f"wall={h.wall_hours[-1]:.2f}h "
              f"participation={sum(h.participation)/len(h.participation):.2f}")

    e, o = results["eafl"], results["oort"]
    if o.cum_dropouts[-1] > 0:
        print(f"\nEAFL dropout reduction vs Oort: "
              f"{o.cum_dropouts[-1] / max(e.cum_dropouts[-1], 1):.2f}x "
              f"(paper reports up to 2.45x)")
    return results


if __name__ == "__main__":
    main()
