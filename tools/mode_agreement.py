"""How far the round modes of the port drift apart: ``client_sequential``
against ``per_client``'s collapse path, and ``weighted_grad`` against
``per_client`` at T = 1, after a few rounds of the same experiment.

The modes sum the same client deltas (or gradients) in another order, so
the params differ only by rounding; ``weighted_grad`` also applies the
weight decay once, where the collapse weights each client's decay by its
realized weight.  The readings set ``chip_smoke.py``'s ``MODE_REL_L2``.

    PYTHONPATH=src python tools/mode_agreement.py [--model cifar_cnn_full] \
        [--rounds 3] [--device cpu] [--threads 1]

Prints, per pair, the params' relative L2 and largest difference and the
losses.  On the CPU keep one thread (the CNN's backward on several oneDNN
threads is not repeatable in this torch build).
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch import tree
from repro_torch.fl.experiment import ExperimentSpec, build_experiment

RUNS = {
    "per_client collapse": dict(strategy_options={"fused": "collapse"}),
    "client_sequential": dict(mode="client_sequential"),
    "per_client collapse T=1": dict(strategy_options={"fused": "collapse"}, local_steps=1),
    "weighted_grad T=1": dict(mode="weighted_grad", local_steps=1),
}
PAIRS = (("client_sequential", "per_client collapse"),
         ("weighted_grad T=1", "per_client collapse T=1"))


def rel_l2(a, b) -> float:
    num = sum(float(torch.sum((x - y).double() ** 2))
              for x, y in zip(tree.leaves(a), tree.leaves(b)))
    return math.sqrt(num / sum(float(torch.sum(y.double() ** 2)) for y in tree.leaves(b)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="cifar_cnn_full")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    runs = {}
    for label, kw in RUNS.items():
        t = time.perf_counter()
        exp = build_experiment(ExperimentSpec(model=args.model, **kw), device=args.device)
        exp.run(args.rounds)
        runs[label] = exp
        print(f"{label}: loss {exp.log.loss} participation {exp.log.participation} "
              f"weight_sum {exp.log.weight_sums} ({time.perf_counter() - t:.1f} s)", flush=True)
    for a, b in PAIRS:
        pa, pb = runs[a].params, runs[b].params
        diff = max(float((x - y).abs().max()) for x, y in zip(tree.leaves(pa), tree.leaves(pb)))
        print(f"{a} vs {b} after {args.rounds} rounds on {args.device}: params relative L2 "
              f"{rel_l2(pa, pb):.3e}, max abs {diff:.3e}")


if __name__ == "__main__":
    main()
