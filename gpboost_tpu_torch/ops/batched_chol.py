"""Batched small-matrix Cholesky solves for the Vecchia hot path
(counterpart of gpboost_tpu/ops/batched_chol.py).

The Vecchia factors need one (m, m) SPD solve per data row. The JAX package
unrolls a column-sweep Cholesky because XLA's batched factorization is slow
on a TPU. Here the forward pass is plain torch: `torch.linalg.cholesky_ex`
plus `torch.cholesky_solve`, batched over rows (cuSOLVER / cuBLAS on the
card, LAPACK on the CPU). Rows whose matrix is not positive definite come out
as NaN, as the column sweep's sqrt of a negative pivot does in the reference.

`cho_solve_batched` is a torch.autograd.Function with the reference's custom
VJP (batched_chol.py:94-98): with x = K^-1 b and upstream gradient x̄,

    g = K^-1 x̄,   K̄ = -g xᵀ,   b̄ = g,

so autograd never differentiates through the factorization. K̄ is the
full-matrix gradient; callers build K symmetrically, so it composes to the
right total derivative.

The backward is itself differentiable when autograd builds its graph
(create_graph, as the Hessian of Newton's method does): g is then the same
solve, applied with the forward's factor, and x the saved output, so the
second derivative takes no new factorization either. Without a graph the
backward is one triangular solve pair from the saved factor.
"""

import torch


def _chol(K):
    L, info = torch.linalg.cholesky_ex(K)
    bad = (info != 0)[:, None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def _solve(L, b):
    return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)


class ChoSolveBatched(torch.autograd.Function):
    """x = K^{-1} b for K (n, m, m) SPD, b (n, m); L, when given, is K's
    Cholesky factor (no gradient)."""

    @staticmethod
    def forward(ctx, K, b, L=None):
        if L is None:
            L = _chol(K)
        x = _solve(L, b)
        ctx.save_for_backward(K, L, x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        K, L, x = ctx.saved_tensors
        if torch.is_grad_enabled():
            # create_graph: the same solve, differentiable in K and x̄
            g = ChoSolveBatched.apply(K, x_bar, L)
        else:
            g = _solve(L, x_bar)                   # K^{-1} x̄ (K symmetric)
        K_bar = -g[:, :, None] * x[:, None, :]
        return K_bar, g, None


def cho_solve_batched(K, b):
    """x = K^{-1} b for K (n, m, m) SPD, b (n, m)."""
    return ChoSolveBatched.apply(K, b)
