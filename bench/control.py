"""The readings that a cell's limits are set from, other than the program's
own runs: the control and the planted faults, each against the plain
reference over the first chunk's rounds, at the cell's own size.

    python3 bench/control.py --workload olmo1b.seq64.k2 --seeds 11 12 13

For every seed, the reference runs three times from the same inputs: sound
(f32, TF32 off); as the control, in the precision one step below the one
the configuration states (its ``precision.control``: bf16 for f32, fp8 for
bf16); and with half of every minibatch left out, the mean over the rest.
Each line of the output is one seed's gaps of the control and of the fault
against the sound run, by the numbers of ``benchlib.check``.  A state left
unchanged reads 1 on the momentum and the change by construction and needs
no run.  ``--rehearse`` runs at the configuration's rehearsal sizes on the
CPU.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from benchlib import check, driver  # noqa: E402
from benchlib.registry import Registry  # noqa: E402


def readings(reg: Registry, workload: str, seed: int, rehearse: bool = False) -> dict:
    """One seed's gaps of the control and of the half-batch fault."""
    import torch

    entry = reg.cell(workload)
    config = reg.data("configs", entry["config"])
    traffic = reg.data("traffic", entry["traffic"])
    if rehearse:
        config = driver.merged(config, config.get("rehearse"))
        traffic = driver.merged(traffic, traffic.get("rehearse"))
    device = torch.device("cpu" if rehearse else "cuda")
    cell = driver.Cell(reg, config, traffic, seed, device)
    limits = reg.data("workloads", workload)["limits"]
    sound = driver.reference_readout(cell)
    out = {"workload": workload, "seed": seed}
    for tag, kw in (("control", {"prec": config["precision"]["control"]}),
                    ("half_batch", {"fault": "half_batch"})):
        numbers, correct, _ = check.compare(driver.reference_readout(cell, **kw), sound, limits)
        out[tag] = {k: v["value"] for k, v in numbers.items()}
        out[tag]["correct"] = correct
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    reg = Registry()
    sys.path.insert(0, str(reg.root / "src"))
    for seed in args.seeds:
        t = time.perf_counter()
        line = readings(reg, args.workload, seed, rehearse=args.rehearse)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
