#!/usr/bin/env python
"""How far two exact computations of seamless-m4t-large-v2 drift apart
with depth, at full width (d_model 1024, 16 heads of 64).

The zoo's init scales every projection by the fan-in ``shape[-2]`` (the
head count for ``wq (d, H, hd)``), so attention logits come out with a
standard deviation of ~64 and the softmaxes are nearly one-hot: a
last-bit difference can flip which key wins.  This probe prints, for the
same params cut to their first L encoder and decoder layers, the relative
L2 distance between the last-position logits of

* the flash prefill and the plain prefill (``use_flash=False``), and
* the prefill and the last step of the prompt replayed through the decode
  path (``tests/test_decode_consistency.py``'s check).

Two packages, one at a time:

    python3 tools/depth_probe.py                      # the port, on the CUDA card
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/depth_probe.py --package jax

``--package torch`` (the default) runs the port at the full config and
the chip smoke's prefill shape (4 requests, 960 frames, a 4096-token
prompt; 64-token prompt for the replay), bf16 and f32, L in 1, 2, 3, 4,
8, 24.  ``--package jax`` runs the reference on the CPU at full width but
with d_ff 1024, vocab 512, 64 frames, one 64-token request, f32, L in 1,
2, 4, 8 (its flash path runs the Pallas kernel in interpret mode).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "seamless-m4t-large-v2"


def _probe_torch():
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch import tree
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.steps import build_step
    from repro_torch.models import build, encdec

    if not torch.cuda.is_available():
        raise SystemExit("depth_probe --package torch needs a CUDA card")
    dev = torch.device("cuda")
    cfg = get_arch(ARCH).full()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build(cfg).init(gen)
    frames = torch.randn((4, cfg.frontend_tokens, cfg.d_model), generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (4, 4096), generator=gen, device=dev)

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for depth in (1, 2, 3, 4, 8, 24):
                c = cfg.replace(dtype=str(dtype)[6:], n_layers=depth, n_encoder_layers=depth)
                b = build(c)
                p = {k: tree.map(lambda x: x[:depth].to(dtype), v) if k in ("encoder", "decoder")
                     else tree.map(lambda x: x.to(dtype), v) for k, v in params.items()}
                batch = {"prefix": frames, "tokens": tokens}
                flash = build_step(b, "prefill")(p, batch)
                plain = b.forward(p, batch, use_flash=False)[:, -1, :].contiguous()
                short = {"prefix": frames, "tokens": tokens[:, :64]}
                pre = build_step(b, "prefill")(p, short)
                cache = b.init_cache(4, 64, cfg.frontend_tokens, device=dev)
                cache["memory"] = encdec.encode(c, p, frames)
                step = build_step(b, "decode")
                for t in range(64):
                    last, cache = step(p, cache, tokens[:, t:t + 1], t)
                print(json.dumps({"package": "torch", "device": torch.cuda.get_device_name(0),
                                  "dtype": str(dtype)[6:], "depth": depth,
                                  "flash_vs_plain_T4096": rel(flash, plain),
                                  "replay_vs_prefill_T64": rel(last, pre)}), flush=True)


def _probe_jax():
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, str(ROOT / "src"))
    from repro.configs.base import get_arch
    from repro.models import build, encdec

    def rel(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for depth in (1, 2, 4, 8):
        cfg = get_arch(ARCH).full(dtype="float32").replace(
            n_layers=depth, n_encoder_layers=depth, d_ff=1024, vocab_size=512,
            frontend_tokens=64)
        b = build(cfg)
        p = b.init(jax.random.PRNGKey(0))
        k1, k2 = jax.random.split(jax.random.PRNGKey(1))
        frames = jax.random.normal(k1, (1, 64, cfg.d_model))
        tokens = jax.random.randint(k2, (1, 64), 0, cfg.vocab_size)
        batch = {"prefix": frames, "tokens": tokens}
        pre = b.forward(p, batch)[:, -1]
        flash = b.forward(p, batch, use_flash=True)[:, -1]
        cache = {**b.init_cache(1, 64, 64), "memory": encdec.encode(cfg, p, frames)}
        step = jax.jit(b.decode_step)
        for t in range(64):
            last, cache = step(p, cache, tokens[:, t:t + 1], jnp.int32(t))
        print(json.dumps({"package": "jax", "device": "cpu", "dtype": "float32",
                          "depth": depth, "flash_vs_plain_T64": rel(flash, pre),
                          "replay_vs_prefill_T64": rel(last, pre)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    args = ap.parse_args(argv)
    if args.package == "torch":
        _probe_torch()
    else:
        _probe_jax()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
