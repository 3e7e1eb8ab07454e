#!/usr/bin/env python3
"""The one-card hot paths of qwen3-0.6b at full width, timed, so that two
checkouts of the port can be held against each other in one call:

    python tools/torch_onecard_ab.py --src SRC_DIR [--label NAME] [--rounds 2]

``--src`` is the ``src`` directory of the checkout to import ``repro_torch``
from.  qwen3-0.6b ``full()`` (28 layers, bf16, the init of seed 0) on the
card, through the entry points a user calls:

1. the prefill step (``build_step(bundle, "prefill")``), 4 requests x 1024
   tokens: the CUDA-synchronized wall of each of ``--reps`` calls after
   two warm-up calls, ms;
2. ``launch.serve.serve``: 4 requests, a 32-token prompt replayed through
   the serve step, 16 greedy tokens: prefill ms, replay ms, decode ms/step;
3. ``launch.train.train`` at the launcher's defaults (8 clients, 4 local
   steps, 4 x 64 tokens), ``--rounds`` rounds per round on the collapse,
   kernel and segmented paths: s/round.

Prints one JSON line, with the card's name and power limit.  Run the
checkouts in turns (A, B, B, A) within one call to compare them.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import build_step
    from repro_torch.launch.train import train
    from repro_torch.models import build

    import repro_torch

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    cfg = get_arch("qwen3-0.6b").full()
    bundle = build(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init(gen)
    out = {"label": args.label, "package": os.path.dirname(repro_torch.__file__), "card": card}
    with torch.inference_mode():
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 1024), generator=gen,
                                         device=dev)}
        prefill = build_step(bundle, "prefill")
        ms = []
        for i in range(2 + args.reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            if i >= 2:
                ms.append(round(1e3 * (time.perf_counter() - t), 3))
        out["prefill_ms"] = ms
        res = serve(cfg=cfg, batch=4, prompt_len=32, gen=16, device=dev, params=params,
                    log=lambda line: None)
        out["serve"] = {"prefill_ms": round(1e3 * res.prefill_s, 3),
                        "replay_ms": round(1e3 * res.replay_s, 3),
                        "decode_ms_per_step": round(res.decode_ms_per_step, 3)}
    out["train_s_per_round"] = {}
    for label, flags in (("collapse", []), ("kernel", ["--fused-kernel"]),
                         ("segmented", ["--fused-kernel", "--segment-d", "1"])):
        r = train(["--arch", "qwen3-0.6b", "--rounds", str(args.rounds), *flags],
                  params=params)
        out["train_s_per_round"][label] = [round(b["seconds"] / b["rounds"], 4)
                                           for b in r.blocks]
        del r
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
