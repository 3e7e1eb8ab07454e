"""Quickstart on the PyTorch port: federated training of a small
qwen3-family LM with ColRel over an intermittently-connected network, vs
blind FedAvg.

    PYTHONPATH=src python examples/quickstart_torch.py [--rounds 15] [--device cpu]

Runs on the CUDA device unless ``--device`` names another.  Shows the
public API: topology -> COPT-alpha weight optimization -> FLTrainer with
the paper's protocol.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core import fedavg_weights, optimize_weights, topology
from repro_torch.data import synthetic_tokens, partition_iid
from repro_torch.data.pipeline import make_federated_clients
from repro_torch.fl import FLTrainer
from repro_torch.fl.trainer import resolve_device
from repro_torch.models import build, count_params
from repro_torch.optim import sgd, sgd_momentum


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # 1. the intermittent network (paper Fig. 2b: heterogeneous uplinks)
    link_model = topology.paper_fig2b(p_c=0.9)
    print(f"uplink probabilities: {link_model.p}")

    # 2. optimize the consensus weights (Algorithm 3)
    res = optimize_weights(link_model, sweeps=25, fine_tune_sweeps=25)
    print(f"COPT-alpha: S {res.S_init:.1f} -> {res.S:.1f} "
          f"({res.S_init / res.S:.1f}x variance reduction)")

    # 3. model + federated data
    cfg = get_arch("qwen3-0.6b").smoke()
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    print(f"model: {cfg.name} (reduced), {count_params(params):,} params")

    toks, _ = synthetic_tokens(600, 65, vocab=cfg.vocab_size, seed=0)
    arrays = {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}
    parts = partition_iid(600, link_model.n, seed=0)

    def run(strategy, A, tag):
        clients = make_federated_clients(arrays, parts, batch_size=8)
        t = FLTrainer(
            bundle.loss_fn, params, link_model, A, clients,
            sgd(0.25), sgd_momentum(1.0, beta=0.9),
            local_steps=args.local_steps, strategy=strategy, seed=0, device=dev,
        )
        t.run(args.rounds)
        print(f"{tag:16s} loss: {t.log.loss[0]:.3f} -> {t.log.loss[-1]:.3f}")
        return t.log.loss[-1]

    colrel = run("colrel", res.A, "ColRel")
    blind = run("fedavg_blind", fedavg_weights(10), "FedAvg-blind")
    print(f"\nColRel final loss {colrel:.3f} vs blind {blind:.3f} "
          f"({'better' if colrel < blind else 'worse'})")


if __name__ == "__main__":
    main()
