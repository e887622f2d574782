"""FITC / predictive-process approximation, Gaussian likelihood (counterpart
of gpboost_tpu/models/fitc.py; reference re_model_template.h:7594
CreateREComponentsFITC_FSA, :9576 CalcCovFactorFITC_FSA, :11802
CalcPredFITC_FSA; kmeans++ inducing points, GP_utils.h:521).

On the nugget-scaled parameterization

    Psi~ = Ddiag + W W',  W = sqrt(v) K_fu L_uu^-T  (n, m),
    Ddiag_i = 1/w_i + v (1 - rho_i),  rho_i = k_i' K_uu^-1 k_i,

so the NLL is a Woodbury solve through an m x m system: tall-skinny
matrix products and two m x m Cholesky factorizations on the device, no
n x n matrix. Gradients come from torch.autograd. The theta-independent
(m, m) and (m, n) distances are computed once on the device by direct
coordinate differences in float64 (the expansion |x|^2 + |y|^2 - 2<x, y>
loses digits where an inducing point coincides with a training point);
a non-isotropic kernel (ARD, space-time, the coordinate-pair and AR1
kernels) evaluates K_uu, K_uf and K_up from the coordinates instead
(fitc.py:91-95, :271-277). The inducing points are the JAX package's:
the same host kmeans++ with the same RandomState draws.
"""

import math

import numpy as np
import torch

from .gaussian_base import GaussianEngineBase, chol

JITTER = 1e-8


_KMEANS_ROWS = 4096


def _nearest_centre(coords, centers):
    """argmin_j ||x_i - c_j||^2 for every row, in row blocks. The squared
    distances are the JAX package's bits: its ((x - c) ** 2).sum(-1) adds
    the coordinates' squares left to right for d < 8 (numpy's pairwise sum
    starts pairing at 8), as the loop here does; from d = 8 the block takes
    that same expression."""
    out = np.empty(len(coords), dtype=np.int64)
    d = coords.shape[1]
    for s in range(0, len(coords), _KMEANS_ROWS):
        x = coords[s:s + _KMEANS_ROWS]
        if d < 8:
            dist = (x[:, None, 0] - centers[None, :, 0]) ** 2
            for c in range(1, d):
                dist += (x[:, None, c] - centers[None, :, c]) ** 2
        else:
            dist = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        out[s:s + _KMEANS_ROWS] = np.argmin(dist, axis=1)
    return out


def kmeanspp_indices(coords, k, seed=0, n_iter=10):
    """kmeans++ seeding and `n_iter` Lloyd iterations on the host; the k
    cluster centres (GP_utils.h:521). The JAX package's numpy code, draw
    for draw, so both packages place the same points; the assignment step
    runs in row blocks (`_nearest_centre`, the same values without the
    (n, k, d) temporary) and each cluster's rows come from one sort."""
    rng = np.random.RandomState(seed)
    n = len(coords)
    k = min(k, n)
    centers = np.empty((k, coords.shape[1]))
    idx0 = rng.randint(n)
    centers[0] = coords[idx0]
    d2 = ((coords - centers[0]) ** 2).sum(1)
    for j in range(1, k):
        probs = d2 / d2.sum()
        centers[j] = coords[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, ((coords - centers[j]) ** 2).sum(1))
    for _ in range(n_iter):
        assign = _nearest_centre(coords, centers)
        # each cluster's rows in row order (a stable sort), as the boolean
        # mask assign == j selects them, so the means are the same bits
        order = np.argsort(assign, kind="stable")
        ends = np.cumsum(np.bincount(assign, minlength=k))
        for j in range(k):
            rows = order[ends[j - 1] if j else 0:ends[j]]
            if len(rows):
                centers[j] = coords[rows].mean(0)
    return centers


def select_inducing_points(coords, num_ind_points, ind_points_selection,
                           seed):
    """The inducing points of gp_model.py:197-203: `num_ind_points`
    (default 500, at most n) random training points or kmeans++ centres."""
    m = min(num_ind_points if num_ind_points else 500, len(coords))
    if ind_points_selection == "random":
        rng = np.random.RandomState(seed)
        return coords[rng.choice(len(coords), m, replace=False)]
    return kmeanspp_indices(coords, m, seed=seed)


def device_dist(a, b, dtype, device):
    """Distances between host coordinate rows a (m, d) and b (n, d) on the
    device: direct differences in float64, one coordinate at a time (no
    (m, n, d) temporary), cast to dtype."""
    a = torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
    b = torch.as_tensor(np.asarray(b, dtype=np.float64), device=device)
    s = None
    for k in range(a.shape[1]):
        diff = a[:, k, None] - b[None, :, k]
        s = diff * diff if s is None else s + diff * diff
    return torch.sqrt(torch.clamp_min(s, 0.0)).to(dtype)


class FITCBlocks:
    """What the FITC engines share: the inducing points and the kernel
    blocks K_uu, K_uf (and K_up for new points) of one GP component."""

    def __init__(self, comp, num_data, num_ind_points, ind_points_selection,
                 seed, dtype, device):
        self.comp = comp
        self.n = int(num_data)
        self.dtype = dtype
        self.device = torch.device(device)
        self.ip = select_inducing_points(comp.coords, num_ind_points,
                                         ind_points_selection, seed)
        self.m = len(self.ip)
        if comp.cov_fn.is_isotropic:
            self._d_uu = device_dist(self.ip, self.ip, dtype, self.device)
            self._d_uf = device_dist(self.ip, comp.coords, dtype, self.device)
        else:
            # the other kernels from coordinates (fitc.py:91-95)
            self._ip_d = self._coords(self.ip)
            self._coords_d = self._coords(comp.coords)

    def _coords(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=self.device).to(self.dtype)

    def L_uu(self, alpha):
        cf = self.comp.cov_fn
        K_uu = (cf.corr_from_dist(self._d_uu, alpha) if cf.is_isotropic
                else cf.corr_from_coords(self._ip_d, self._ip_d, alpha)) \
            + JITTER * torch.eye(self.m, dtype=self.dtype, device=self.device)
        return chol(K_uu)

    def V(self, alpha):
        """(L_uu, V = L_uu^-1 K_uf (m, n))."""
        cf = self.comp.cov_fn
        L = self.L_uu(alpha)
        K_uf = cf.corr_from_dist(self._d_uf, alpha) if cf.is_isotropic \
            else cf.corr_from_coords(self._ip_d, self._coords_d, alpha)
        return L, torch.linalg.solve_triangular(L, K_uf, upper=False)

    def V_pred(self, L, alpha, coords_pred):
        """L_uu^-1 K_up (m, n_pred) for new points."""
        cf = self.comp.cov_fn
        K_up = cf.corr_from_dist(device_dist(
            self.ip, coords_pred, self.dtype, self.device), alpha) \
            if cf.is_isotropic \
            else cf.corr_from_coords(self._ip_d, self._coords(coords_pred),
                                     alpha)
        return torch.linalg.solve_triangular(L, K_up, upper=False)


class FITCGaussianEngine(GaussianEngineBase):
    """FITC-approximated Gaussian marginal NLL, gradients and prediction.
    Tensor arguments named y, X or resid are device tensors in data
    order."""

    def __init__(self, components, num_data, num_ind_points=500,
                 ind_points_selection="kmeans++", seed=0,
                 dtype=torch.float64, weights=None, *, device):
        if len(components) != 1 or components[0].kind != "gp":
            raise ValueError("gp_approx='fitc' requires exactly one GP "
                             "component")
        self.comp = components[0]
        self.components = [self.comp]
        self.par_offsets = [0]
        self.n = int(num_data)
        self.dtype = dtype
        self.device = torch.device(device)
        self.num_theta = self.comp.num_cov_par
        self.num_cov_par = self.num_theta + 1
        self.weights = None if weights is None \
            else np.asarray(weights, dtype=np.float64)
        # per-observation weights: nugget_i = sigma2 / w_i
        self._winv = None if weights is None else self._t(1.0 / self.weights)
        self._blocks = FITCBlocks(self.comp, num_data, num_ind_points,
                                  ind_points_selection, seed, dtype,
                                  self.device)
        self.ip = self._blocks.ip
        self.m = self._blocks.m

    # ------------------------------------------------------------------
    def _parts(self, theta_log):
        """(Ddiag (n,), W (n, m), L_uu) of Psi~ = Ddiag + W W'."""
        v = torch.exp(theta_log[0])
        alpha = torch.exp(theta_log[1:])
        L_uu, V = self._blocks.V(alpha)
        rho = torch.sum(V * V, dim=0)
        nug = 1.0 if self._winv is None else self._winv
        Ddiag = nug + v * torch.clamp_min(1.0 - rho, 0.0)
        return Ddiag, torch.sqrt(v) * V.T, L_uu

    def _woodbury(self, Ddiag, W):
        """(W / Ddiag, chol(I + W' Ddiag^-1 W))."""
        WD = W / Ddiag[:, None]
        A = torch.eye(self.m, dtype=self.dtype, device=self.device) \
            + W.T @ WD
        return WD, chol(A)

    def _psi_inv(self, theta_log, V):
        """Psi~^-1 V for V (n,) or (n, k) by Woodbury."""
        Ddiag, W, _ = self._parts(theta_log)
        WD, La = self._woodbury(Ddiag, W)
        V2 = V[:, None] if V.ndim == 1 else V
        DV = V2 / Ddiag[:, None]
        out = DV - WD @ torch.cholesky_solve(W.T @ DV, La)
        return out[:, 0] if V.ndim == 1 else out

    def _quad_logdet(self, theta_log, y):
        Ddiag, W, _ = self._parts(theta_log)
        WD, La = self._woodbury(Ddiag, W)
        Dy = y / Ddiag
        WtDy = W.T @ Dy
        quad = y @ Dy - WtDy @ torch.cholesky_solve(WtDy[:, None], La)[:, 0]
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(La))) \
            + torch.sum(torch.log(Ddiag))
        return quad, logdet

    def _nll_parts(self, theta_log, sigma2, y):
        quad, logdet = self._quad_logdet(theta_log, y)
        n = self.n
        return 0.5 * (quad / sigma2 + logdet + n * torch.log(sigma2)
                      + n * math.log(2.0 * math.pi)), quad

    def _nll_profiled(self, theta_log, y):
        quad, logdet = self._quad_logdet(theta_log, y)
        n = self.n
        return 0.5 * (logdet + n * torch.log(quad / n) + n
                      + n * math.log(2.0 * math.pi)), quad

    def _wls(self, theta_log, y, X):
        MiX = self._psi_inv(theta_log, X)
        Miy = self._psi_inv(theta_log, y)
        Lc = chol(X.T @ MiX)
        return torch.cholesky_solve((X.T @ Miy)[:, None], Lc)[:, 0]

    def _coef_grad(self, theta_log, sigma2, resid, X):
        return -(X.T @ self._psi_inv(theta_log, resid)) / sigma2

    # the raw differentiable closures for the device L-BFGS (ops/lbfgs.py)
    nll_profiled_raw = _nll_profiled
    wls_coef_raw = _wls

    def fisher_transformed(self, u, include_error_var=True):
        raise NotImplementedError(
            "fisher_scoring with gp_approx='fitc' is not supported; use "
            "gradient_descent or lbfgs")

    def fisher_original(self, pars_orig):
        return np.full((self.num_cov_par, self.num_cov_par), np.nan)

    def psi_tilde_inv_mat(self, pars_internal, M):
        """Psi~^-1 M for M (n, L) on the device (the FITC branch of
        gbdt.py:2395 _psi_tilde_inv_mat, the engine's psi_inv_apply)."""
        theta_log = self._t(np.log(np.asarray(pars_internal)[1:]))
        with torch.no_grad():
            out = self._psi_inv(theta_log, M.to(self.dtype))
        return out.to(M.dtype)

    # ------------------------------------------------------------------
    def predict(self, pars_orig, y_resid, pred_data, predict_var=False,
                predict_cov_mat=False, predict_response=False):
        """Predictive-process prediction (CalcPredFITC_FSA: the cross
        covariance is the low-rank part)."""
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        sigma2 = float(pars_orig[0])
        t = self.transform_pars(pars_orig)
        v = float(t[1])
        cp = np.asarray(pred_data["comps"][0]["coords_pred"],
                        dtype=np.float64)
        if cp.ndim == 1:
            cp = cp[:, None]
        n_pred = len(cp)
        with torch.no_grad():
            theta_log = self._t(np.log(t[1:]))
            alpha = torch.exp(theta_log[1:])
            Ddiag, W, L_uu = self._parts(theta_log)
            Vp = self._blocks.V_pred(L_uu, alpha, cp)
            Wp = math.sqrt(v) * Vp.T                           # (n_pred, m)
            y = self.prep_y(y_resid)
            WD, La = self._woodbury(Ddiag, W)
            Dy = y / Ddiag
            alpha_v = Dy - WD @ torch.cholesky_solve((W.T @ Dy)[:, None],
                                                     La)[:, 0]
            out = {"mu": self._host(Wp @ (W.T @ alpha_v))[0]}
            if predict_var or predict_cov_mat:
                # cov = sigma2 (Wp (I - G + G A^-1 G) Wp' + diag(v (1 -
                # rho_p))), G = W' Ddiag^-1 W, A = I + G
                WtW = W.T @ WD
                Q = torch.eye(self.m, dtype=self.dtype, device=self.device) \
                    - WtW + WtW @ torch.cholesky_solve(WtW, La)
                rho_p = torch.sum(Vp * Vp, dim=0)
                prior_diag = v * torch.clamp_min(1.0 - rho_p, 0.0)
                nugget = sigma2 if predict_response else 0.0
                if predict_cov_mat:
                    cov = (Wp @ Q @ Wp.T + torch.diag(prior_diag)) * sigma2 \
                        + nugget * torch.eye(n_pred, dtype=self.dtype,
                                             device=self.device)
                    out["cov"] = self._host(cov)[0]
                    if predict_var:
                        out["var"] = np.diagonal(out["cov"]).copy()
                else:
                    # the diagonal alone: no (n_pred, n_pred) matrix
                    var = torch.sum((Wp @ Q) * Wp, dim=1) + prior_diag
                    out["var"] = self._host(var * sigma2 + nugget)[0]
        return out
