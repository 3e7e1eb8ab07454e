"""Batched serving of a model of the zoo: prefill, then greedy decode
against the KV cache (the hybrid's also holds the Mamba states; RWKV6's
holds its shift and wkv states instead).

    python -m repro_torch.launch.serve --arch <id> \\
        [--smoke] [--batch 4] [--prompt-len 32] [--gen 32] [--device cuda]

``<id>`` is any of the ten architectures of
:data:`repro_torch.configs.base.CLI_ALIASES`.  The counterpart of
``examples/serve_decode.py``: random weights and prompts, all from
``--seed``.  An encoder-decoder (seamless-m4t) also gets synthetic frame
embeddings ``(B, frames, d_model)``, a VLM (internvl2) synthetic patch
embeddings ``(B, patches, d_model)`` in front of its prompt, but only in
the prefill: the decode step has no prefix, as in the reference, so the
cache replay and the decode see the text alone.  Every other model gets
prompts only.  It times

* the prefill step (last-position logits of the prompt; an
  encoder-decoder's and a hybrid's through the hand-written kernels: flash
  attention, and ``ssd_scan`` for Mamba);
* filling the cache by replaying the prompt through the serve step, as the
  reference does (no prefill there writes a cache);
* greedy generation of ``--gen`` tokens, the first from the replay's last
  logits and each further one from one serve step.

Runs on CUDA unless ``--device`` names another device.  A config of
one's own (say, a depth cut) goes through ``serve(cfg=...)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.fl.trainer import resolve_device
from repro_torch.launch.steps import build_step, get_arch_cfg
from repro_torch.models import ModelConfig, build, count_params
from repro_torch.models import encdec

__all__ = ["ServeResult", "serve", "main"]


@dataclasses.dataclass
class ServeResult:
    # the prefill's frontend embeddings: an encoder-decoder's frames or a
    # VLM's patches (B, frontend_tokens, d_model); None for the others
    frames: Optional[torch.Tensor]
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


def serve(arch: str = "seamless-m4t-large-v2", *, cfg: Optional[ModelConfig] = None,
          smoke: bool = False, batch: int = 4, prompt_len: int = 32, gen: int = 32, device=None,
          seed: int = 0, params=None,
          log: Optional[Callable[[str], None]] = print) -> ServeResult:
    """Prefill, cache replay and greedy decode of ``batch`` requests of the
    model ``cfg`` (default: ``arch``'s config, its ``smoke()`` under
    ``smoke``); ``params`` (on the device) are drawn from ``seed`` when
    not given."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_arch_cfg(arch, smoke=smoke)
    if prompt_len < 1 or gen < 1:
        raise ValueError(f"prompt_len and gen must be >= 1, got {prompt_len}, {gen}")
    bundle = build(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = bundle.init(g)
    B, P, G = batch, prompt_len, gen
    encoder = cfg.arch_type in ("encdec", "audio")
    prefixed = encoder or (cfg.arch_type == "vlm" and cfg.frontend_tokens > 0)
    F = cfg.frontend_tokens if prefixed else 0
    what = "frames" if encoder else "patches"
    frames = torch.randn((B, F, cfg.d_model), generator=g, device=dev) if prefixed else None
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev)
    if log:
        log(f"serving {cfg.name}{' (smoke)' if smoke else ''} on {dev}: "
            f"{count_params(params):,} params, {cfg.dtype}, batch {B}, prompt {P}, "
            f"{f'{F} {what}, ' if prefixed else ''}gen {G}")
    prefill_step, serve_step = build_step(bundle, "prefill"), build_step(bundle, "decode")
    batch_in = {"tokens": prompts} if frames is None else {"prefix": frames, "tokens": prompts}

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        prefill_logits = prefill_step(params, batch_in)
        _sync(dev)
        prefill_s = time.perf_counter() - t0

        cache = (bundle.init_cache(B, P + G, F, device=dev) if encoder
                 else bundle.init_cache(B, P + G, device=dev))
        t0 = time.perf_counter()
        if encoder:
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
        log(f"prefill: {P} tokens x {B} seqs{f' + {F} {what}' if prefixed else ''} in "
            f"{1e3 * prefill_s:.2f} ms")
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
