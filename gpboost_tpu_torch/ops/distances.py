"""Pairwise Euclidean distances (counterpart of gpboost_tpu/ops/distances.py).

Two regimes, as in the reference: direct coordinate differences (exact, used
for parity and moderate sizes) and the |x|^2 + |y|^2 - 2<x,y> expansion (one
GEMM) when the (n, m, d) broadcast would be too large.
"""

import torch

# Above this many pairwise entries, switch to the GEMM-based formula.
_DIRECT_MAX_ENTRIES = 64_000_000


def pairwise_dist_sq(x1, x2=None, *, method="auto"):
    """Squared Euclidean distances between rows of x1 (n, d) and x2 (m, d)."""
    if x2 is None:
        x2 = x1
    n, d = x1.shape
    m = x2.shape[0]
    if method == "auto":
        method = "direct" if n * m * d <= _DIRECT_MAX_ENTRIES else "gemm"
    if method == "direct":
        diff = x1[:, None, :] - x2[None, :, :]
        return torch.sum(diff * diff, dim=-1)
    sq1 = torch.sum(x1 * x1, dim=1)
    sq2 = torch.sum(x2 * x2, dim=1)
    out = sq1[:, None] + sq2[None, :] - 2.0 * (x1 @ x2.T)
    return torch.clamp_min(out, 0.0)


def pairwise_dist(x1, x2=None, *, method="auto"):
    """Euclidean distances between rows of x1 (n, d) and x2 (m, d)."""
    return torch.sqrt(pairwise_dist_sq(x1, x2, method=method))
