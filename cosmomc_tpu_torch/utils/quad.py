"""Fixed-order quadrature rules for background integrals.

Gauss-Legendre nodes are computed host-side once (numpy, f64) and moved to
the caller's device and dtype; the integrand is evaluated on all nodes at
once, batched over chains.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def gauss_legendre(n: int):
    """(nodes, weights) on [-1, 1], float64 numpy."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x, w


def gl_nodes(a: torch.Tensor, b, n: int = 64):
    """Scaled nodes and weights for int_a^b, batched: `a`/`b` are (C,)
    tensors (or one of them a float); returns (x, w) of shape (C, n)."""
    ref = a if torch.is_tensor(a) else b
    x, w = gauss_legendre(n)
    x = torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
    w = torch.as_tensor(w, dtype=ref.dtype, device=ref.device)
    a = a[..., None] if torch.is_tensor(a) else a
    b = b[..., None] if torch.is_tensor(b) else b
    half = (b - a) / 2.0
    return (a + b) / 2.0 + half * x, half * w
