"""The OLMo decoder: its weights and client shards as the benchmark makes
them from the seed, the port's model that the trainer runs, and the
arithmetic of its operations.

Weights (made on the run's device by one generator, in one f32 draw, then
cast to the configuration's dtype): the embedding ``N(0, 0.02^2)``, every
projection ``N(0, 1/fan_in)``.  Data: each client's shard of sequences of
``seq_len + 1`` tokens drawn uniformly from the vocabulary; the model
reads the first ``seq_len`` and predicts the last ``seq_len``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["param_shapes", "make_params", "make_shards", "program", "n_params",
           "flops_per_round", "comparison_leaves"]


def param_shapes(model: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    L, d, V = model["num_hidden_layers"], model["hidden_size"], model["vocab_size"]
    H, hd, f = model["num_attention_heads"], model["head_dim"], model["intermediate_size"]
    if model["num_key_value_heads"] != H or not model["tie_word_embeddings"]:
        raise ValueError("this family takes full multi-head attention and a tied head")
    return [("embed", (V, d)),
            ("layers.attn.wq", (L, d, H, hd)), ("layers.attn.wk", (L, d, H, hd)),
            ("layers.attn.wv", (L, d, H, hd)), ("layers.attn.wo", (L, H, hd, d)),
            ("layers.ffn.wg", (L, d, f)), ("layers.ffn.wu", (L, d, f)),
            ("layers.ffn.wd", (L, f, d))]


def n_params(config: dict) -> int:
    model = config["model"]
    return int(sum(np.prod(s) for _, s in param_shapes(model)))


def _fan_in(path: str, shape) -> int:
    if path == "layers.attn.wo":
        return shape[1] * shape[2]
    return shape[1]


def make_params(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    model = config["model"]
    dtype = getattr(torch, model["torch_dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for path, shape in param_shapes(model):
        std = 0.02 if path == "embed" else _fan_in(path, shape) ** -0.5
        out[path] = (torch.randn(shape, generator=gen, device=device) * std).to(dtype)
    return out


def make_shards(config: dict, traffic: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """Every client's ``tokens`` and ``labels``, (N_i, S) int64."""
    model, n_clients = config["model"], config["protocol"]["n_clients"]
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    N, S = int(traffic["sequences_per_client"]), int(traffic["seq_len"])
    seqs = torch.randint(0, model["vocab_size"], (n_clients, N, S + 1), generator=gen,
                         device=device).cpu().numpy()
    return [{"tokens": np.ascontiguousarray(s[:, :-1]), "labels": np.ascontiguousarray(s[:, 1:])}
            for s in seqs]


def program(config: dict, device):
    """The port's model: ``(loss_fn(params, batch), tree_of(flat))``; its
    configuration is the port's preset for the architecture with the sizes
    of this file (a test holds the file's widths to the preset's)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import build

    model = config["model"]
    cfg = get_arch(model["arch"]).full().replace(
        n_layers=model["num_hidden_layers"], tie_embeddings=model["tie_word_embeddings"],
        d_model=model["hidden_size"], n_heads=model["num_attention_heads"],
        n_kv_heads=model["num_key_value_heads"], head_dim=model["head_dim"],
        d_ff=model["intermediate_size"], vocab_size=model["vocab_size"],
        rope_theta=model["rope_theta"], dtype=model["torch_dtype"])
    if (cfg.norm, cfg.mlp, cfg.arch_type) != ("nonparametric_ln", "swiglu", "dense"):
        raise RuntimeError(f"the port's {model['arch']} is not a dense SwiGLU decoder with a "
                           f"non-parametric LayerNorm: {cfg}")
    bundle = build(cfg)

    def tree_of(flat: Dict[str, torch.Tensor]):
        return {"embed": flat["embed"],
                "layers": {"ln1": {}, "ln2": {},
                           "attn": {k: flat[f"layers.attn.{k}"] for k in ("wq", "wk", "wv", "wo")},
                           "ffn": {k: flat[f"layers.ffn.{k}"] for k in ("wg", "wu", "wd")}},
                "final_norm": {}}

    return bundle.loss_fn, tree_of


def flops_per_round(config: dict, traffic: dict) -> float:
    """6 N D: N the parameters (the tied embedding counted once, as the
    head's product), D the tokens of every client's T steps.  The causal
    attention's products are not counted."""
    protocol = config["protocol"]
    tokens = (protocol["n_clients"] * protocol["local_steps"] * traffic["batch_size"]
              * traffic["seq_len"])
    return 6.0 * n_params(config) * tokens


def comparison_leaves(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The leaves the comparison holds apart: the embedding, and each
    layer's slice of every stacked projection."""
    out = {}
    for k, v in flat.items():
        if k.startswith("layers."):
            out.update((f"{k}.{l}", x) for l, x in enumerate(v.unbind(0)))
        else:
            out[k] = v
    return out
