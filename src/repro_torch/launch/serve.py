"""Batched serving of an encoder-decoder of the model zoo: prefill, then
greedy KV-cache decode.

    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \\
        [--smoke] [--batch 4] [--prompt-len 32] [--gen 32] [--device cuda]

The counterpart of ``examples/serve_decode.py`` for seamless-m4t: random
weights and synthetic frame embeddings ``(B, frames, d_model)`` and
prompts, all from ``--seed``.  It times

* the prefill step (last-position logits of the prompt, the decoder's
  self-attention through the flash-attention kernel);
* filling the cache by replaying the prompt through the serve step, as the
  reference does (no prefill there writes a cache);
* greedy generation of ``--gen`` tokens, the first from the replay's last
  logits and each further one from one serve step.

Runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.fl.trainer import resolve_device
from repro_torch.launch.steps import build_step, get_arch_cfg
from repro_torch.models import build, count_params
from repro_torch.models import encdec

__all__ = ["ServeResult", "serve", "main"]


@dataclasses.dataclass
class ServeResult:
    frames: torch.Tensor  # (B, frames, d_model) synthetic frame embeddings
    prompts: torch.Tensor  # (B, prompt_len) prompt tokens
    prefill_logits: torch.Tensor  # (B, V) from the prefill step
    replay_logits: torch.Tensor  # (B, V) from the last replayed prompt token
    tokens: torch.Tensor  # (B, gen) greedy tokens
    prefill_s: float
    replay_s: float
    decode_s: float
    decode_steps: int

    @property
    def decode_ms_per_step(self) -> float:
        return 1e3 * self.decode_s / max(self.decode_steps, 1)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.shape[0] * self.decode_steps / max(self.decode_s, 1e-9)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str = "seamless-m4t-large-v2", *, smoke: bool = False, batch: int = 4,
          prompt_len: int = 32, gen: int = 32, device=None, seed: int = 0,
          params=None, log: Optional[Callable[[str], None]] = print) -> ServeResult:
    """Prefill, cache replay and greedy decode of ``batch`` requests;
    ``params`` (on the device) are drawn from ``seed`` when not given."""
    dev = resolve_device(device)
    cfg = get_arch_cfg(arch, smoke=smoke)
    if prompt_len < 1 or gen < 1:
        raise ValueError(f"prompt_len and gen must be >= 1, got {prompt_len}, {gen}")
    bundle = build(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = bundle.init(g)
    B, P, G, F = batch, prompt_len, gen, cfg.frontend_tokens
    frames = torch.randn((B, F, cfg.d_model), generator=g, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev)
    if log:
        log(f"serving {cfg.name}{' (smoke)' if smoke else ''} on {dev}: "
            f"{count_params(params):,} params, {cfg.dtype}, batch {B}, prompt {P}, "
            f"{F} frames, gen {G}")
    prefill_step, serve_step = build_step(bundle, "prefill"), build_step(bundle, "decode")

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        prefill_logits = prefill_step(params, {"prefix": frames, "tokens": prompts})
        _sync(dev)
        prefill_s = time.perf_counter() - t0

        cache = bundle.init_cache(B, P + G, F, device=dev)
        t0 = time.perf_counter()
        cache["memory"] = encdec.encode(cfg, params, frames)
        for t in range(P):
            logits, cache = serve_step(params, cache, prompts[:, t:t + 1], t)
        _sync(dev)
        replay_s = time.perf_counter() - t0
        replay_logits = logits

        tok = torch.argmax(logits, -1)[:, None]
        out = [tok]
        t0 = time.perf_counter()
        for t in range(P, P + G - 1):
            logits, cache = serve_step(params, cache, tok, t)
            tok = torch.argmax(logits, -1)[:, None]
            out.append(tok)
        _sync(dev)
        decode_s = time.perf_counter() - t0

    res = ServeResult(frames=frames, prompts=prompts, prefill_logits=prefill_logits,
                      replay_logits=replay_logits,
                      tokens=torch.cat(out, dim=1), prefill_s=prefill_s, replay_s=replay_s,
                      decode_s=decode_s, decode_steps=G - 1)
    if log:
        log(f"prefill: {P} tokens x {B} seqs + {F} frames in {1e3 * prefill_s:.2f} ms")
        log(f"cache replay: {P} serve steps in {1e3 * replay_s:.2f} ms")
        log(f"decode: {G - 1} steps in {1e3 * decode_s:.2f} ms "
            f"({res.decode_ms_per_step:.3f} ms/step, {res.tokens_per_s:.1f} tok/s)")
        for b in range(min(B, 2)):
            log(f"  seq{b}: ...{prompts[b, -5:].tolist()} -> {res.tokens[b, :8].tolist()}...")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="seamless-m4t-large-v2")
    ap.add_argument("--smoke", action="store_true", help="the reduced smoke() config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    serve(args.arch, smoke=args.smoke, batch=args.batch, prompt_len=args.prompt_len,
          gen=args.gen, device=args.device, seed=args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
