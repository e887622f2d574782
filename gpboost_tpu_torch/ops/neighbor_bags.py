"""A fixed (n, k) neighbour pattern as `embedding_bag` bags: products over
the pattern and over its transpose without atomics (the Vecchia factors'
A t and A' t, the tapered residual's R x, the gathers of the full-scale
engines).

For idx (n, k) and slot weights A (n, k):

    A t:   out[i] = sum_j A[i, j] t[idx[i, j]]        (bag i: row i's slots)
    A' t:  out[l] = sum_{(i, j): idx[i, j] = l} A[i, j] t[i]
                                              (bag l: the slots pointing at l)

with t a vector (n,) or columns (n, c). The transposed bags are sorted
once on the host (stable, so each bag sums its slots in row order). One
thread sums one output in the bag's order: no atomics, so every product,
its gradient and the CG counts built on it are deterministic. `_At` and
`_Att` carry the two products' gradients, each the other's product for t
(no scatter either); `gather` is a row gather whose gradient is a
transposed-bag sum.
"""

import numpy as np
import torch


def bag_sums(t, idx, offs, w):
    """out[i] = sum of w[r] t[idx[r]] over bag i's slots r, t (n,) or
    (n, k): a weighted `embedding_bag` sum, one thread an output, no
    atomics."""
    t2 = t if t.ndim == 2 else t.view(-1, 1)
    return torch.embedding_bag(t2, idx, offs, False, 0, False, w, False,
                               None)[0].view(t.shape)


class NeighborBags:
    """The bags of one (n, k) host index array, on `device`."""

    def __init__(self, idx, device):
        idx = np.asarray(idx, dtype=np.int64)
        n, k = idx.shape
        flat = idx.reshape(-1)
        order = np.argsort(flat, kind="stable")
        counts = np.bincount(flat, minlength=n)
        self._idx_shape = (n, k)
        self._flat_idx = torch.as_tensor(flat, device=device)
        self._a_offs = torch.arange(0, flat.size, k, device=device)
        self._t_order = torch.as_tensor(order, device=device)
        self._t_rows = torch.as_tensor(order // k, device=device)
        self._t_offs = torch.as_tensor(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), device=device)

    def _a_bags(self, t, w):
        """A t for A's slots w = A.reshape(-1), no graph; one column as a
        gather and a row sum (the JAX package's order, and faster than
        bags of width one)."""
        if t.ndim == 1:
            return torch.sum(w.view(self._idx_shape) * t.index_select(
                0, self._flat_idx).view(self._idx_shape), 1)
        return bag_sums(t, self._flat_idx, self._a_offs, w)

    def _at_bags(self, t, wt):
        """A' t for wt = `_t_weights(A)`, no graph."""
        return bag_sums(t, self._t_rows, self._t_offs, wt)

    def _t_weights(self, A):
        """A's slots in the transposed bags' order."""
        return A.reshape(-1).index_select(0, self._t_order)

    def gather(self, table):
        """table[idx] (n, k, c) for table (n, c), its gradient a transposed
        bag sum (no index_add_)."""
        return _GatherRows.apply(table, self)


def _slot_products(t, g, bags):
    """d/dA of g' (A t), (n, k): g[i] t[idx[i, j]] summed over columns."""
    tg = t.index_select(0, bags._flat_idx).view(bags._idx_shape
                                                + t.shape[1:])
    return g[:, None] * tg if t.ndim == 1 \
        else torch.einsum("nk,nmk->nm", g, tg)


class _At(torch.autograd.Function):
    """A t over the bags; backward: A' g for t, row slots g[i] t[idx[i, j]]
    for A."""

    @staticmethod
    def forward(ctx, A, t, bags):
        ctx.bags = bags
        ctx.save_for_backward(A, t)
        return bags._a_bags(t, A.reshape(-1))

    @staticmethod
    def backward(ctx, g):
        A, t = ctx.saved_tensors
        bags = ctx.bags
        gA = _slot_products(t, g, bags) if ctx.needs_input_grad[0] else None
        gt = _Att.apply(A, g, bags) if ctx.needs_input_grad[1] else None
        return gA, gt, None


class _Att(torch.autograd.Function):
    """A' t over the transposed bags; backward: A g for t, slots
    t[i] g[idx[i, j]] for A."""

    @staticmethod
    def forward(ctx, A, t, bags):
        ctx.bags = bags
        ctx.save_for_backward(A, t)
        return bags._at_bags(t, bags._t_weights(A))

    @staticmethod
    def backward(ctx, g):
        A, t = ctx.saved_tensors
        bags = ctx.bags
        gA = _slot_products(g, t, bags) if ctx.needs_input_grad[0] else None
        gt = _At.apply(A, g, bags) if ctx.needs_input_grad[1] else None
        return gA, gt, None


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, bags):
        ctx.bags = bags
        n, k = bags._idx_shape
        return table.index_select(0, bags._flat_idx).view(n, k, -1)

    @staticmethod
    def backward(ctx, g):
        bags = ctx.bags
        n, k = bags._idx_shape
        slots = g.reshape(n * k, -1)
        return torch.embedding_bag(slots, bags._t_order, bags._t_offs, False,
                                   0, False, None, False, None)[0], None
