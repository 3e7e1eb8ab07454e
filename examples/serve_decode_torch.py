"""Batched serving demo on the PyTorch port: prefill + KV-cache decode on a
gemma3-family model (sliding-window + global layers), greedy generation.

    PYTHONPATH=src python examples/serve_decode_torch.py --batch 4 --gen 32 [--device cpu]

Runs on the CUDA device unless ``--device`` names another.
"""

import argparse
import time

import torch

from repro_torch.configs.base import get_arch
from repro_torch.fl.trainer import resolve_device
from repro_torch.models import build, count_params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_arch("gemma3-1b").smoke()
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    print(f"serving {cfg.name} (reduced): {count_params(params):,} params, "
          f"window={cfg.sliding_window}, local:global={cfg.local_global_ratio}:1")

    B, P, G = args.batch, args.prompt_len, args.gen
    max_len = P + G
    prompts = torch.randint(0, cfg.vocab_size, (B, P), dtype=torch.int32, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))

    cache = bundle.init_cache(B, max_len, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # prefill by replaying the prompt through the decode path (exactly the
    # cache the prefill would produce)
    with torch.inference_mode():
        t0 = time.perf_counter()
        for t in range(P):
            logits, cache = bundle.decode_step(params, cache, prompts[:, t:t + 1], t)
        sync()
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out = [tok]
        t0 = time.perf_counter()
        for t in range(P, P + G - 1):
            logits, cache = bundle.decode_step(params, cache, tok, t)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out.append(tok)
        sync()
        t_gen = time.perf_counter() - t0

    gen = torch.cat(out, dim=1).cpu()
    prompts = prompts.cpu()
    print(f"prefill: {P} tokens x {B} seqs in {t_prefill:.2f}s")
    print(f"decode:  {G - 1} steps in {t_gen:.2f}s "
          f"({B * (G - 1) / max(t_gen, 1e-9):.1f} tok/s)")
    for b in range(min(B, 2)):
        print(f"  seq{b}: ...{list(map(int, prompts[b, -5:]))} -> "
              f"{list(map(int, gen[b, :8]))}...")


if __name__ == "__main__":
    main()
