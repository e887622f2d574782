"""Covariance tapering, full-scale tapering (FSA) and full-scale Vecchia
(VIF) as kernel adapters (counterpart of gpboost_tpu/ops/taper.py).

- gp_approx = "tapering": Sigma = T o K with T the compact-support Wendland
  taper (re_comp.h:1293-1312 apply_tapering_);
- gp_approx = "full_scale_tapering" (FSA): Sigma = U + T o (K - U) with
  U = K_fu' K_uu^-1 K_fu the predictive process over inducing points
  (re_model_template.h:9576 CalcCovFactorFITC_FSA);
- gp_approx = "full_scale_vecchia" (VIF): the training block is
  V'V + B^-1 D B^-T, V = L_uu^-1 K_uf and (B, D) the Vecchia factors of
  the residual kernel k(x, x') - V(x)'V(x') (Vecchia_utils.cpp:1476);
  cross and prediction blocks use the exact kernel.

Each adapter wraps a base CovarianceFunction (any of ops/cov_fcts.py's
kernels or the AR1 multifidelity one, evaluated from distances when it is
isotropic and from coordinates otherwise) and presents the coordinates
interface (`is_isotropic` False, `corr_from_coords`, and `corr_train` for
VIF), so the dense engines (models/gaussian_gp.py, models/laplace.py) run
every path on it unchanged: the NLL, autograd gradients, Fisher
information and the prediction blocks. The iterative engines
(models/fsa_iterative.py, models/fsva_iterative.py) read the adapter's
taper, inducing points and neighbour sets instead. Tensors are evaluated
on the device and in the dtype of the transformed ranges `alphas` they are
given; the adapters keep their data on the host as float64 numpy.
"""

import numpy as np
import torch

from .cov_fcts import _safe_sqrt, pointwise_corr
from .distances import pairwise_dist

_JITTER = 1e-10


def _like(a, ref):
    """Host array as a tensor of ref's dtype on ref's device."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64),
                           device=ref.device).to(ref.dtype)


def _tri_solve(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


class _CovAdapterBase:
    """Delegates the parameter surface of a base CovarianceFunction and
    overrides the kernel evaluation."""

    is_isotropic = False
    needs_coords = True

    def __init__(self, base):
        self.base = base

    def __getattr__(self, name):
        if name == "base":
            raise AttributeError(name)
        return getattr(self.base, name)

    @property
    def num_range_par(self):
        return self.base.num_range_par

    @property
    def num_cov_par(self):
        return self.base.num_cov_par

    def _base_corr(self, x1, x2, alphas):
        if self.base.is_isotropic:
            return self.base.corr_from_dist(pairwise_dist(x1, x2), alphas)
        return self.base.corr_from_coords(x1, x2, alphas)


class TaperedCovarianceFunction(_CovAdapterBase):
    """T o K, the elementwise Wendland taper (gp_approx 'tapering')."""

    def __init__(self, base, taper):
        super().__init__(base)
        self.taper = taper      # a CovarianceFunction("wendland", ...)

    def corr_from_coords(self, x1, x2, alphas):
        D = pairwise_dist(x1, x2)
        K = self.base.corr_from_dist(D, alphas) if self.base.is_isotropic \
            else self.base.corr_from_coords(x1, x2, alphas)
        return K * self.taper._wendland_taper(D)


class FSACovarianceFunction(_CovAdapterBase):
    """U + T o (K - U), U = k(., u) K_uu^-1 k(u, .) (full-scale tapering).
    The inducing points are fixed at construction (kmeans++ by default,
    GP_utils.h:521)."""

    def __init__(self, base, taper, inducing_points):
        super().__init__(base)
        self.taper = taper
        self.ip = np.asarray(inducing_points, dtype=np.float64)

    def _low_rank(self, x1, x2, alphas):
        ip = _like(self.ip, alphas)
        K_uu = self._base_corr(ip, ip, alphas) + _JITTER * torch.eye(
            len(ip), dtype=ip.dtype, device=ip.device)
        L = torch.linalg.cholesky(K_uu)
        V1 = _tri_solve(L, self._base_corr(ip, x1, alphas))
        V2 = _tri_solve(L, self._base_corr(ip, x2, alphas))
        return V1.T @ V2

    def corr_from_coords(self, x1, x2, alphas):
        K = self._base_corr(x1, x2, alphas)
        U = self._low_rank(x1, x2, alphas)
        T = self.taper._wendland_taper(pairwise_dist(x1, x2))
        return U + T * (K - U)


class VIFCovarianceFunction(_CovAdapterBase):
    """full_scale_vecchia: the inducing-point predictive process plus a
    Vecchia approximation of the residual process on the training rows.
    The training block is assembled densely here (the engine's Cholesky is
    O(n^3) anyway); models/fsva_iterative.py is the scale path.

    Neighbours are the nearest preceding training rows in the data order
    (the shared native search from n = 20,000 in 2-D), or with
    correlation_based those of largest |residual correlation| at the
    initial parameters (Vecchia_utils.h:192), computed on `device`."""

    def __init__(self, base, inducing_points, train_coords, num_neighbors,
                 correlation_based=False, init_alphas=None, device="cpu"):
        super().__init__(base)
        self.ip = np.asarray(inducing_points, dtype=np.float64)
        self.train_coords = np.asarray(train_coords, dtype=np.float64)
        self.n = len(self.train_coords)
        self.m_nn = int(min(num_neighbors, self.n - 1))
        if correlation_based and init_alphas is not None:
            idx, mask = self._corr_neighbors(np.asarray(init_alphas), device)
        else:
            idx = mask = None
            if self.n >= 20000 and self.train_coords.shape[1] == 2:
                from ..native import nn_preceding_2d
                res = nn_preceding_2d(self.train_coords, self.m_nn)
                if res is not None:
                    idx, mask = res
            if idx is None:
                from ..models.vecchia import nearest_preceding_neighbors
                idx, mask = nearest_preceding_neighbors(self.train_coords,
                                                        self.m_nn)
        self.nn_idx = np.asarray(idx, dtype=np.int64)
        self.nn_mask = np.asarray(mask, dtype=bool)
        self._nn_dists = {}

    def _corr_neighbors(self, init_alphas, device):
        """Per row, the preceding rows of largest |residual correlation|
        at the initial parameters."""
        ref = torch.as_tensor(np.asarray(init_alphas, dtype=np.float64),
                              device=torch.device(device))
        with torch.no_grad():
            R = self._residual_corr_dense(ref).abs().cpu().numpy()
        n, m = self.n, self.m_nn
        idx = np.zeros((n, m), dtype=np.int64)
        mask = np.zeros((n, m), dtype=bool)
        for i in range(1, n):
            k = min(m, i)
            c = R[i, :i]
            sel = np.argpartition(-c, k - 1)[:k] if k < i else np.arange(i)
            idx[i, :k] = sel
            mask[i, :k] = True
            idx[i, k:] = i
        return idx, mask

    def _V_of(self, x, alphas):
        """L_uu^-1 k(u, x), (m_ip, len(x))."""
        ip = _like(self.ip, alphas)
        K_uu = self._base_corr(ip, ip, alphas) + _JITTER * torch.eye(
            len(ip), dtype=ip.dtype, device=ip.device)
        L = torch.linalg.cholesky(K_uu)
        return _tri_solve(L, self._base_corr(ip, x, alphas))

    def _residual_corr_dense(self, alphas):
        x = _like(self.train_coords, alphas)
        V = self._V_of(x, alphas)
        return self._base_corr(x, x, alphas) - V.T @ V

    def corr_from_coords(self, x1, x2, alphas):
        # cross and prediction blocks: the exact kernel (the residual
        # Vecchia graph is anchored to the training rows)
        return self._base_corr(x1, x2, alphas)

    def _nn_dist(self, dtype, device):
        """The parameter-free distances among each row's neighbours
        (n, m, m) and from them to the row (n, m), found once for each
        dtype and device."""
        key = (dtype, torch.device(device))
        if key not in self._nn_dists:
            x = torch.as_tensor(self.train_coords, device=key[1]).to(dtype)
            cn = x[torch.as_tensor(self.nn_idx, device=key[1])]  # (n, m, d)
            self._nn_dists[key] = (
                _pair_dist(cn[:, :, None, :], cn[:, None, :, :]),
                _pair_dist(cn, x[:, None, :]))
        return self._nn_dists[key]

    def corr_train(self, alphas):
        """The VIF training-block correlation V'V + B^-1 D B^-T (called by
        GPComponent.corr)."""
        n, m = self.n, self.m_nn
        dt, dev = alphas.dtype, alphas.device
        x = _like(self.train_coords, alphas)
        V = self._V_of(x, alphas)                              # (m_ip, n)
        idx = torch.as_tensor(self.nn_idx, device=dev)
        mask = torch.as_tensor(self.nn_mask, device=dev)
        if self.base.is_isotropic:
            d_nn, d_ni = self._nn_dist(dt, dev)
            c_nn = self.base.corr_from_dist(d_nn, alphas)
            c_ni = self.base.corr_from_dist(d_ni, alphas)
        else:
            # the base kernel from coordinate pairs (taper.py:208-216)
            cn = x[idx]                                        # (n, m, d)
            c_nn = pointwise_corr(self.base, cn[:, :, None, :],
                                  cn[:, None, :, :], alphas)
            c_ni = pointwise_corr(self.base, cn, x[:, None, :], alphas)
        Vn = V.T[idx]                                          # (n, m, m_ip)
        r_nn = c_nn - torch.einsum("nik,njk->nij", Vn, Vn)
        r_ni = c_ni - torch.einsum("nik,nk->ni", Vn, V.T)
        r_ii = 1.0 - torch.sum(V.T * V.T, dim=1)
        eye = torch.eye(m, dtype=dt, device=dev)[None]
        pair = mask[:, :, None] & mask[:, None, :]
        r_nn = torch.where(pair, r_nn, eye) + 1e-10 * eye
        r_ni = torch.where(mask, r_ni, torch.zeros_like(r_ni))
        L = torch.linalg.cholesky(r_nn)
        A = torch.cholesky_solve(r_ni[..., None], L)[..., 0]
        D = torch.clamp_min(r_ii - torch.sum(A * r_ni, dim=1), 1e-12)
        # dense B = I - M from the neighbour records, R = B^-1 D B^-T. A
        # row's neighbours are distinct; its padded slots repeat the row's
        # own index with a zero coefficient, so the scatter sums nothing
        # but zeros onto one entry
        M = torch.zeros((n, n), dtype=dt, device=dev).scatter_add(
            1, idx, torch.where(mask, A, torch.zeros_like(A)))
        B = torch.eye(n, dtype=dt, device=dev) - M
        Binv = _tri_solve(B, torch.eye(n, dtype=dt, device=dev))
        R = (Binv * D[None, :]) @ Binv.T
        return V.T @ V + R


def _pair_dist(xa, xb):
    """Distances between broadcast coordinate rows, with a zero gradient
    (not NaN) at coincident points."""
    return _safe_sqrt(((xa - xb) ** 2).sum(-1))
