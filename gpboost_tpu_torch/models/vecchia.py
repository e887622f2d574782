"""Vecchia approximation engine, Gaussian likelihood, response scale
(counterpart of gpboost_tpu/models/vecchia.py).

Sigma^-1 ~= B' D^-1 B with B = I - A unit lower triangular and at most m
off-diagonals per row, conditioning on nearest preceding neighbours in a
random ordering. The ordering and the neighbour search are the reference's
host numpy / cKDTree code (or the shared native search at n >= 20k), so both
packages condition on the same sets.

Device layout: the (n, m) neighbour indices, masks and the theta-independent
neighbour distances live on the engine's device; each NLL evaluation is a
batch of (m, m) correlation matrices -> batched Cholesky solves -> masked
reductions, differentiated by torch.autograd through the custom-VJP solve of
ops/batched_chol.py.

Ported: the ordering, neighbour search, `_bd`, the NLL with and without the
profiled nugget (value and gradient, the host wrappers of
models/gaussian_base.py), GLS and gradient coefficient steps for linear
covariates, the raw closures of the device L-BFGS, and prediction with
vecchia_pred_type='order_obs_first_cond_obs_only'. As in the reference,
Fisher scoring and Newton raise here. Weights, cluster_ids, a device mesh,
neighbour re-determination and the other prediction orderings raise
NotImplementedError.
"""

import math

import numpy as np
import torch

from .gaussian_base import GaussianEngineBase, chol
from ..ops.batched_chol import cho_solve_batched
from ..ops.cov_fcts import _safe_sqrt


def _corr_sets(cov_fn, cn, ci, alphas, d_nn=None, d_ni=None):
    """Batched neighbour-set correlations (corr_nn (B, k, k), corr_ni (B, k))
    between each row's neighbour coords cn (B, k, d) and its own point
    ci (B, d); precomputed distances may be passed."""
    if d_nn is None:
        d_nn = _safe_sqrt(
            ((cn[:, :, None, :] - cn[:, None, :, :]) ** 2).sum(-1))
        d_ni = _safe_sqrt(((cn - ci[:, None, :]) ** 2).sum(-1))
    return cov_fn.corr_from_dist(d_nn, alphas), cov_fn.corr_from_dist(d_ni,
                                                                       alphas)


def nearest_preceding_neighbors(coords, m):
    """Neighbour indices among preceding points in the ordering (a copy of
    the reference's host search, vecchia.py:77, without clusters).

    Exact kNN via cKDTree over doubling batches: for the batch [s, 2s) a tree
    on points [0, 2s) is queried with an over-allocation factor and indices
    >= i are filtered out; rare rows fall back to a brute-force pass.

    Returns (idx (n, m) int64, mask (n, m) bool). Rows i < m are padded with
    the row's own index, masked out.
    """
    from scipy.spatial import cKDTree
    n = len(coords)
    idx = np.zeros((n, m), dtype=np.int64)
    mask = np.zeros((n, m), dtype=bool)
    s = 1
    while s < n:
        e = min(2 * s, n)
        tree = cKDTree(coords[:e])
        k_query = min(e, 4 * m + 8)
        _, cand = tree.query(coords[s:e], k=k_query)
        cand = np.atleast_2d(cand)
        for r in range(s, e):
            row = cand[r - s]
            valid = row[row < r][:m]
            if len(valid) < min(m, r):
                d2 = ((coords[:r] - coords[r]) ** 2).sum(-1)
                k = min(m, r)
                valid = np.argpartition(d2, k - 1)[:k] if k < r else np.arange(r)
                valid = valid[np.argsort(d2[valid], kind="stable")]
            k = len(valid)
            idx[r, :k] = valid
            mask[r, :k] = True
            idx[r, k:] = r
        s = e
    idx[0, :] = 0
    return idx, mask


class VecchiaGaussianEngine(GaussianEngineBase):
    """Vecchia-approximated Gaussian marginal NLL, gradients and prediction.

    Parameters enter as float64 numpy on the host; the engine casts them to
    its dtype on its device. Tensor arguments named y are in the engine's
    (permuted) ordering unless a method says otherwise.
    """

    def __init__(self, components, num_data, num_neighbors=20,
                 vecchia_ordering="random", seed=0, dtype=torch.float64,
                 *, device, mesh=None, weights=None, cluster_ids=None):
        if mesh is not None or weights is not None or cluster_ids is not None:
            raise NotImplementedError(
                "mesh, weights and cluster_ids are not ported yet for "
                "gp_approx='vecchia'")
        if len(components) != 1 or components[0].kind != "gp":
            raise ValueError("gp_approx='vecchia' requires exactly one GP "
                             "component")
        comp = components[0]
        self.comp = comp
        self.components = [comp]
        self.par_offsets = [0]
        self.n = int(num_data)
        self.dtype = dtype
        self.device = torch.device(device)
        self.m = int(min(num_neighbors, self.n - 1))
        self.num_theta = comp.num_cov_par
        self.num_cov_par = self.num_theta + 1

        if vecchia_ordering in ("none", None):
            perm = np.arange(self.n)
        elif vecchia_ordering == "random":
            perm = np.random.RandomState(seed).permutation(self.n)
        else:
            raise NotImplementedError(
                f"vecchia_ordering '{vecchia_ordering}' is not ported yet "
                "(supported: 'random', 'none')")
        self.perm = perm
        self.coords_ord = comp.coords[perm]
        idx = mask = None
        if self.n >= 20000 and self.coords_ord.shape[1] == 2:
            # native cell-bucketed search, as the reference does at this size
            from ..native import nn_preceding_2d
            res = nn_preceding_2d(self.coords_ord, self.m)
            if res is not None:
                idx, mask = res
        if idx is None:
            idx, mask = nearest_preceding_neighbors(self.coords_ord, self.m)
        dev = self.device
        self._nn_idx = torch.as_tensor(idx, device=dev)
        self._nn_mask = torch.as_tensor(mask, device=dev)
        self._pair_mask = self._nn_mask[:, :, None] & self._nn_mask[:, None, :]
        self._perm = torch.as_tensor(perm, device=dev)
        self._eye = torch.eye(self.m, dtype=dtype, device=dev)[None]
        # theta-independent neighbour distances, computed once on the host
        cn = self.coords_ord[idx]                          # (n, m, d)
        d_nn = np.sqrt(np.maximum(
            ((cn[:, :, None, :] - cn[:, None, :, :]) ** 2).sum(-1), 0.0))
        d_ni = np.sqrt(np.maximum(
            ((cn - self.coords_ord[:, None, :]) ** 2).sum(-1), 0.0))
        self._d_nn = torch.as_tensor(d_nn, dtype=dtype, device=dev)
        self._d_ni = torch.as_tensor(d_ni, dtype=dtype, device=dev)

    # ------------------------------------------------------------------
    def prep_y(self, y):
        """y in data order (numpy or tensor) -> engine ordering, dtype and
        device."""
        y = torch.as_tensor(y, device=self.device)
        return y[self._perm].to(self.dtype)

    def _bd(self, theta_log, latent=False):
        """Batched Vecchia factors: A (n, m) coefficients, D (n,) diagonals
        of the response covariance C = v K + I, or with latent=True of the
        latent covariance C = v K (no nugget; the Vecchia-Laplace
        precision)."""
        v = torch.exp(theta_log[0])
        alphas = torch.exp(theta_log[1:])
        corr_nn, corr_ni = _corr_sets(self.comp.cov_fn, None, None, alphas,
                                      d_nn=self._d_nn, d_ni=self._d_ni)
        K_nn = v * corr_nn
        if not latent:
            K_nn = K_nn + self._eye
        k_ni = v * corr_ni
        # padded neighbours: identity rows/cols in K_nn, zeros in k_ni
        K_nn = torch.where(self._pair_mask, K_nn, self._eye)
        k_ni = torch.where(self._nn_mask, k_ni, torch.zeros_like(k_ni))
        A = cho_solve_batched(K_nn, k_ni)
        D = (v if latent else v + 1.0) - torch.sum(A * k_ni, dim=1)
        return A, D

    def _bd_add_diag(self, theta_log, add_diag):
        """Vecchia factors of the latent covariance plus a per-point
        diagonal add_diag (n,), in the engine's order
        (CalcVecchiaApproxLatentAddDiagonal, re_model_template.h: the
        'vecchia_response' preconditioner's factors with pseudo-nugget
        W^-1)."""
        v = torch.exp(theta_log[0])
        alphas = torch.exp(theta_log[1:])
        corr_nn, corr_ni = _corr_sets(self.comp.cov_fn, None, None, alphas,
                                      d_nn=self._d_nn, d_ni=self._d_ni)
        K_nn = v * corr_nn + add_diag[self._nn_idx][:, :, None] * self._eye
        K_nn = torch.where(self._pair_mask, K_nn, self._eye)
        k_ni = v * corr_ni
        k_ni = torch.where(self._nn_mask, k_ni, torch.zeros_like(k_ni))
        A = cho_solve_batched(K_nn, k_ni)
        D = v + add_diag - torch.sum(A * k_ni, dim=1)
        return A, D

    def _B_apply(self, A, V):
        """B V for V (n, k): a gather, no scatter."""
        return V - torch.einsum("nm,nmk->nk", A, V[self._nn_idx])

    def _quad_logdet(self, theta_log, y):
        A, D = self._bd(theta_log)
        z = y - torch.sum(A * y[self._nn_idx], dim=1)          # (B y)_i
        return torch.sum(z * z / D), torch.sum(torch.log(D))

    def _nll_parts(self, theta_log, sigma2, y):
        quad, logdet = self._quad_logdet(theta_log, y)
        n = self.n
        nll = 0.5 * (quad / sigma2 + logdet + n * torch.log(sigma2)
                     + n * math.log(2.0 * math.pi))
        return nll, quad

    def _nll_profiled(self, theta_log, y):
        quad, logdet = self._quad_logdet(theta_log, y)
        n = self.n
        return 0.5 * (logdet + n * torch.log(quad / n) + n
                      + n * math.log(2.0 * math.pi)), quad

    def _wls(self, theta_log, y, X):
        """GLS coefficients by X' Psi~^-1 X = (BX)' D^-1 (BX)."""
        A, D = self._bd(theta_log)
        U = self._B_apply(A, X)
        By = self._B_apply(A, y[:, None])[:, 0]
        Lc = chol(U.T @ (U / D[:, None]))
        return torch.cholesky_solve((U.T @ (By / D))[:, None], Lc)[:, 0]

    def _coef_grad(self, theta_log, sigma2, resid, X):
        A, D = self._bd(theta_log)
        U = self._B_apply(A, X)
        Br = self._B_apply(A, resid[:, None])[:, 0]
        return -(U.T @ (Br / D)) / sigma2

    # the raw differentiable closures for the device L-BFGS (ops/lbfgs.py)
    nll_profiled_raw = _nll_profiled
    wls_coef_raw = _wls

    def hess_full(self, u, y):
        raise NotImplementedError(
            "newton is not supported with gp_approx='vecchia' (the batched "
            "solve has a first-order custom gradient only); use "
            "gradient_descent or lbfgs")

    def fisher_transformed(self, u, include_error_var=True):
        raise NotImplementedError(
            "fisher_scoring is not supported with gp_approx='vecchia'; use "
            "gradient_descent or lbfgs")

    def fisher_original(self, pars_orig):
        """Standard-error Fisher information: the exact dense one as a
        proxy up to n = 4,000, NaN above (as the reference)."""
        if self.n > 4000:
            return np.full((self.num_cov_par, self.num_cov_par), np.nan)
        from .gaussian_gp import DenseGaussianEngine
        return DenseGaussianEngine([self.comp], self.n, dtype=self.dtype,
                                   device=self.device).fisher_original(
                                       pars_orig)

    # ------------------------------------------------------------------
    def psi_tilde_inv_mat(self, pars_internal, M):
        """Psi_tilde^-1 M for M (n, L) in data order, on the device
        (gbdt.py:2422-2434 Vecchia branch): B' D^-1 B M with the factors of
        the response covariance. The Bᵀ scatter is an index_add_, which uses
        atomics on CUDA and so sums in a run-dependent order; in float64
        that moves results by ~1e-16 relative, far inside the tolerances
        that hold the port to the reference."""
        theta_log = self._t(np.log(np.asarray(pars_internal)[1:]))
        with torch.no_grad():
            A, D = self._bd(theta_log)
        A = A.to(M.dtype)
        D = D.to(M.dtype)
        Mp = M[self._perm]                                  # (n, L)
        z = Mp - torch.einsum("nm,nml->nl", A, Mp[self._nn_idx])
        w = z / D[:, None]
        out = w.clone()
        out.index_add_(0, self._nn_idx.reshape(-1),
                       -(A[:, :, None] * w[:, None, :]).reshape(-1, M.shape[1]))
        inv = torch.empty_like(out)
        inv[self._perm] = out
        return inv

    # ------------------------------------------------------------------
    def _knn_obs(self, coords_pred, k):
        """k nearest observed points per prediction point (host cKDTree)."""
        from scipy.spatial import cKDTree
        dist, idx = cKDTree(self.coords_ord).query(np.asarray(coords_pred),
                                                   k=k)
        p = len(coords_pred)
        return idx.reshape(p, -1), dist.reshape(p, -1)

    def _pred_cond_obs(self, theta_log, cn, ci, y_nbr):
        """Batched conditional mean and variance of each prediction point
        given its k nearest observed points (vecchia.py:563)."""
        v = torch.exp(theta_log[0])
        alphas = torch.exp(theta_log[1:])
        corr_nn, corr_ni = _corr_sets(self.comp.cov_fn, cn, ci, alphas)
        k = cn.shape[1]
        K = v * corr_nn + torch.eye(k, dtype=self.dtype, device=self.device)
        kni = v * corr_ni
        a = cho_solve_batched(K, kni)
        mu = torch.sum(a * y_nbr, dim=1)
        var = v + 1.0 - torch.sum(a * kni, dim=1)
        return mu, var

    def predict(self, pars_orig, y_resid, pred_data, predict_var=False,
                predict_cov_mat=False, predict_response=False,
                vecchia_pred_type="order_obs_first_cond_obs_only",
                num_neighbors_pred=None):
        """Vecchia predictions, each prediction point conditioning on its
        k nearest observed points (CalcPredVecchiaObservedFirstOrder)."""
        if vecchia_pred_type != "order_obs_first_cond_obs_only":
            raise NotImplementedError(
                f"vecchia_pred_type '{vecchia_pred_type}' is not ported yet "
                "(supported: 'order_obs_first_cond_obs_only')")
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        sigma2 = pars_orig[0]
        t = self.transform_pars(pars_orig)
        theta_log = self._t(np.log(t[1:]))
        y_ord = np.asarray(y_resid, dtype=np.float64)[self.perm]
        coords_pred = np.asarray(pred_data["comps"][0]["coords_pred"],
                                 dtype=np.float64)
        if coords_pred.ndim == 1:
            coords_pred = coords_pred[:, None]
        n_pred = len(coords_pred)
        k = min(num_neighbors_pred or self.m, self.n)
        nn, _ = self._knn_obs(coords_pred, k)
        with torch.no_grad():
            mu, var = self._pred_cond_obs(
                theta_log, self._t(self.coords_ord[nn]), self._t(coords_pred),
                self._t(y_ord[nn]))
        mu = mu.cpu().numpy().astype(np.float64)
        # sigma2 cancels in the mean; variances were computed on the
        # nugget-scaled parameterization -> multiply by sigma2
        var = var.cpu().numpy().astype(np.float64) * sigma2
        if not predict_response:
            var = var - sigma2
        out = {"mu": mu}
        if predict_cov_mat:
            out["cov"] = np.diag(var)
        if predict_var:
            out["var"] = var
        return out
