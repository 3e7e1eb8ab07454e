"""Synthetic datasets, a numpy copy of ``repro.data.synthetic``.

``synthetic_cifar`` is interface-compatible with CIFAR-10: (N, 32, 32, 3)
float images in 10 classes.  Classes are separable but noisy — each class
has a random smooth template plus per-sample noise — so learning curves
show the same qualitative convergence/ordering phenomena the paper reports
(the absolute accuracies differ from real CIFAR).

``quadratic_problem`` builds the strongly-convex least-squares instance
used to validate Theorem 1 exactly (mu-strong convexity and L-smoothness
are explicit eigenvalue bounds).
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_cifar", "quadratic_problem"]


def synthetic_cifar(
    n: int = 10000,
    n_classes: int = 10,
    image_size: int = 32,
    noise: float = 0.6,
    seed: int = 0,
):
    """Returns (images (N,H,W,3) float32 in [-1, 1]-ish, labels (N,) int32)."""
    rng = np.random.default_rng(seed)
    # smooth class templates: low-frequency random fields
    freq = 4
    base = rng.normal(size=(n_classes, freq, freq, 3)).astype(np.float32)
    templates = np.stack(
        [
            np.kron(base[c], np.ones((image_size // freq, image_size // freq, 1), np.float32))
            for c in range(n_classes)
        ]
    )  # (C, H, W, 3)
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    images = templates[labels] + noise * rng.normal(size=(n, image_size, image_size, 3)).astype(
        np.float32
    )
    return images.astype(np.float32), labels


def quadratic_problem(n_clients: int, dim: int, mu: float = 1.0, L: float = 10.0,
                      hetero: float = 0.0, seed: int = 0):
    """Per-client quadratics f_i(x) = 0.5 (x - c_i)^T H (x - c_i) with common
    Hessian H (eigenvalues in [mu, L]) and centers c_i = c + hetero * d_i.
    The global optimum is x* = mean(c_i).  Returns dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    eig = np.linspace(mu, L, dim)
    H = (q * eig) @ q.T
    c = rng.normal(size=dim)
    centers = c[None, :] + hetero * rng.normal(size=(n_clients, dim))
    return {
        "H": H.astype(np.float64),
        "centers": centers.astype(np.float64),
        "x_star": centers.mean(axis=0),
        "mu": mu,
        "L": L,
    }
