"""Plain reference of a ColRel round (Yemini et al., arXiv:2202.11850,
Algorithms 1 and 2), in f32 PyTorch.

Each client takes T SGD steps with weight decay from the PS model on its
own minibatches; relay i forms its consensus of what it heard,
``tilde_i = sum_j tau_ji alpha_ij delta_j``, and the PS adds what arrives,
``g = (1/n) sum_i tau_i tilde_i`` (Eq. (3)); the PS then takes a momentum
step on the pseudo-gradient ``-g`` with step 1: ``m = beta m - g``,
``x = x - m``.  Parameters are kept in the configuration's storage dtype
and rounded to it after every update; every update and the update stack
are f32, as the configuration states.

``loss(params, batch, prec)`` is the model's own reference (its module's
``make_loss``), ``prec`` the precision of its arithmetic (``"f32"``, or the
control's lower one).  ``fault="half_batch"`` takes each minibatch's
first half, the mean over the rest: one of the faults the comparison has
to catch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["run_rounds", "relay_aggregate"]


def relay_aggregate(deltas: Sequence[torch.Tensor], tau_up: torch.Tensor,
                    tau_dd: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Eq. (3) for one leaf: each relay's weighted consensus of the updates
    it heard, then the PS's mean over the relays whose uplink succeeded."""
    n = len(deltas)
    D = torch.stack([d.reshape(-1) for d in deltas])  # (n, numel)
    tilde = []
    for i in range(n):
        w = tau_dd[:, i] * A[i, :]  # tau_ji alpha_ij over j
        tilde.append(w @ D)
    g = sum(tau_up[i] * tilde[i] for i in range(n)) / n
    return g.reshape(deltas[0].shape)


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def run_rounds(loss_fn, params0: Dict[str, torch.Tensor], streams, taus, A: np.ndarray, *,
               local_steps: int, chunk: int, rounds: int, lr: float, weight_decay: float,
               beta: float, prec: str = "f32", fault: Optional[str] = None,
               device=None) -> Dict[str, object]:
    """``rounds`` rounds from ``params0`` (storage dtype, on ``device``);
    ``streams`` are fresh client streams, asked for ``chunk * T`` batches a
    chunk as the program's trainer asks; ``taus[r] = (tau_up, tau_dd)``.

    Returns each round's mean client loss and the norm of its PS delta, and
    the parameters and the PS momentum after the last round."""
    n, T = len(streams), int(local_steps)
    A_t = torch.as_tensor(np.asarray(A), dtype=torch.float32, device=device)
    p = {k: v.detach().clone() for k, v in params0.items()}
    m = {k: torch.zeros(v.shape, dtype=torch.float32, device=device) for k, v in p.items()}
    losses: List[float] = []
    delta_norms: List[float] = []
    pending: List[Dict[str, np.ndarray]] = []
    for r in range(rounds):
        if r % chunk == 0:
            pending = [s.next_batches(chunk * T) for s in streams]
        tau_up = torch.as_tensor(taus[r][0], dtype=torch.float32, device=device)
        tau_dd = torch.as_tensor(taus[r][1], dtype=torch.float32, device=device)
        deltas: Dict[str, List[torch.Tensor]] = {k: [] for k in p}
        client_losses = []
        for i in range(n):
            q = dict(p)
            step_losses = []
            for t in range(T):
                row = (r % chunk) * T + t
                batch = {k: v[row] for k, v in pending[i].items()}
                if fault == "half_batch":
                    batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
                leaves = {k: v.float().requires_grad_() for k, v in q.items()}
                loss = loss_fn(leaves, _to_device(batch, device), prec)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                with torch.no_grad():
                    q = {k: (x - lr * (g.float() + weight_decay * x)).to(p[k].dtype)
                         for (k, x), g in zip(leaves.items(), grads)}
                step_losses.append(float(loss.detach()))
                del leaves, grads, loss
            client_losses.append(float(np.mean(step_losses)))
            with torch.no_grad():
                for k in p:
                    deltas[k].append(q[k].float() - p[k].float())
            del q
        with torch.no_grad():
            sq = 0.0
            for k in list(p):
                g = relay_aggregate(deltas.pop(k), tau_up, tau_dd, A_t)
                sq += float(torch.sum(g.double() ** 2))
                m[k] = beta * m[k] - g
                p[k] = (p[k].float() - m[k]).to(p[k].dtype)
                del g
        losses.append(float(np.mean(client_losses)))
        delta_norms.append(sq ** 0.5)
    return {"loss": losses, "delta_norm": delta_norms, "params": p, "momentum": m}
