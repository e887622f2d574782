"""Iterative covariance tapering and full-scale tapering (FSA), the n-scaling
path (counterpart of gpboost_tpu/models/fsa_iterative.py; reference
re_comp.h:1293-1312 apply_tapering_, CG_utils.h:505-975 CGFSA /
CGTridiagFSA with the "fitc" preconditioner P = diag(C_s) + C_nm C_m^-1
C_mn, CG_utils.h:491-506).

The scaled covariance is

    M(theta) = I + v (E'E + R(theta)),   E = L_uu^-1 K_un  (m, n),

with R the tapered residual: R_ij = T(d_ij) (k(d_ij) - e_i'e_j) for the
pairs inside the taper's support, R_ii = 1 - e_i'e_i. Plain tapering is
the same engine without the low-rank part. The support is a static (n, k)
neighbour array found once on the host (cKDTree radius search, at most 256
neighbours a row); R x is a weighted `embedding_bag` sum over it
(ops/neighbor_bags.py), one output per thread and no atomics, so every
product, gradient and CG count is deterministic. E'E x is two (m, n)
matrix products. Memory is O(n (m + k)).

The quadratic form rides a preconditioned CG with the implicit gradient,
the log-determinant the exact congruence SLQ of ops/iterative.py with the
FITC preconditioner as a Woodbury factor

    P = D + v E'E = D^1/2 (I + Zt'Zt) D^1/2,   Zt = sqrt(v) E D^-1/2,
    P^-1 = M_f M_f',  M_f = D^-1/2 (I - W' f(L) W),  W = Q'Zt,
    Zt Zt' = Q L Q' (an m x m eigh),  f(l) = (1 - 1/sqrt(1 + l)) / l,

so log|P| enters deterministically. The probes are the JAX package's
(RandomState(seed_rand_vec_trace)), chunked so that a chunk's batched
matvec touches about 2e8 elements.
"""

import math

import numpy as np
import torch

from .gaussian_base import GaussianEngineBase, chol
from .gaussian_gp import assemble_pred_covs
from .fitc import device_dist
from ..ops.iterative import make_cg_solve_precond, make_slq_logdet_congruence
from ..ops.neighbor_bags import NeighborBags, _At
from ..utils.log import Log

_JITTER = 1e-10
_PC_ALIASES = {"predictive_process_plus_diagonal": "fitc"}
# the most taper neighbours a row keeps (the JAX package's bound)
MAX_TAPER_NEIGHBORS = 256


def taper_neighbors(coords, taper_range, max_neighbors=MAX_TAPER_NEIGHBORS):
    """The taper's support as a static (n, k) pattern: for each point the
    other points with d < taper_range (the reference's CSC pattern,
    re_comp.h:1293); a row with more than `max_neighbors` keeps the
    nearest. Returns host (idx int32, dist float64, mask bool), padded rows
    pointing at themselves."""
    from scipy.spatial import cKDTree
    coords = np.asarray(coords, dtype=np.float64)
    n = len(coords)
    tree = cKDTree(coords)
    lists = tree.query_ball_tree(tree, r=taper_range * (1.0 - 1e-12))
    k = max(1, min(max_neighbors, max(len(l) - 1 for l in lists)))
    idx = np.zeros((n, k), dtype=np.int32)
    dist = np.zeros((n, k), dtype=np.float64)
    mask = np.zeros((n, k), dtype=bool)
    truncated = 0
    for i, l in enumerate(lists):
        nb = np.asarray([j for j in l if j != i], dtype=np.int64)
        if len(nb) == 0:
            idx[i, :] = i
            continue
        d = np.sqrt(((coords[nb] - coords[i]) ** 2).sum(1))
        if len(nb) > k:
            truncated += 1
            keep = np.argpartition(d, k - 1)[:k]
            nb, d = nb[keep], d[keep]
        idx[i, : len(nb)] = nb
        dist[i, : len(nb)] = d
        mask[i, : len(nb)] = True
        idx[i, len(nb):] = i
    if truncated:
        Log.warning(
            f"taper support truncated to the nearest {k} neighbors for "
            f"{truncated} of {n} points (cov_fct_taper_range is large "
            "relative to the point density); the tapered matrix is "
            "approximated")
    return idx, dist, mask


def fitc_pc_factor(Zt, D):
    """(W, f, log|P|) of P = D^1/2 (I + Zt'Zt) D^1/2 (see the module
    docstring); Zt (m, n), D (n,), no graph."""
    lam, Q = torch.linalg.eigh(Zt @ Zt.T)
    lam = torch.clamp_min(lam, 0.0)
    f = torch.where(lam > 1e-10,
                    (1.0 - 1.0 / torch.sqrt(1.0 + lam))
                    / torch.clamp_min(lam, 1e-10),
                    0.5 - 3.0 * lam / 8.0)
    return Q.T @ Zt, f, torch.sum(torch.log(D)) + torch.sum(torch.log1p(lam))


class IterativeGaussianBase(GaussianEngineBase):
    """What the iterative FSA and FSVA engines share: the single-GP
    parameter transforms, the CG / SLQ settings and counts, the Woodbury
    preconditioner's products, and the host API over `_nll_parts`.

    A subclass provides `_factors(theta_log) -> p` (a tuple of tensors;
    `self._PC` the index of its preconditioner's first entry, Dinvs, W,
    f, log|P|), `_matvec(p, x)`, `_solve_sigma(p, x)` (the scaled
    covariance's inverse) and `_build()`."""

    matrix_inversion_method = "iterative"

    def _init_iterative(self, components, num_data, dtype, device, name):
        if len(components) != 1 or components[0].kind != "gp":
            raise ValueError(f"iterative {name} supports a single GP "
                             "component")
        self.comp = components[0]
        self.components = [self.comp]
        self.par_offsets = [0]
        self.n = int(num_data)
        self.dtype = dtype
        self.device = torch.device(device)
        self.base = self.comp.cov_fn.base
        if not self.base.is_isotropic:
            raise NotImplementedError(
                f"iterative {name} requires an isotropic base kernel; use "
                "matrix_inversion_method='cholesky'")
        self.num_theta = self.comp.num_cov_par
        self.num_cov_par = self.num_theta + 1
        self._cg_acc = None

    def set_iterative_params(self, **kw):
        """The CG / SLQ settings (gp_model.py:576-600 rebuilds the engine's
        solvers on a change): num_rand_vec_trace, cg_max_num_it,
        cg_delta_conv, seed_rand_vec_trace and cg_preconditioner_type.
        nsim_var_pred and piv_chol_rank are accepted without effect: the
        predictions take CG columns and no preconditioner is a pivoted
        Cholesky."""
        casts = {"num_rand_vec_trace": int, "cg_max_num_it": int,
                 "cg_delta_conv": float, "seed_rand_vec_trace": int}
        for k, v in kw.items():
            if k == "cg_preconditioner_type":
                self._set_preconditioner(v)
            elif k in casts:
                setattr(self, k, casts[k](v))
            elif k not in ("nsim_var_pred", "piv_chol_rank"):
                raise ValueError(f"unknown iterative setting '{k}'")
        self._build()

    # ------------------------------------------------------------------
    def _pc_m(self, p, x):
        """M_f x (the preconditioner's factor)."""
        Dinvs, W, f = p[self._PC:self._PC + 3]
        if W.numel():
            x = x - W.T @ (_col(f, x) * (W @ x))
        return _col(Dinvs, x) * x

    def _pc_mt(self, p, x):
        """M_f' x."""
        Dinvs, W, f = p[self._PC:self._PC + 3]
        x = _col(Dinvs, x) * x
        if W.numel():
            x = x - W.T @ (_col(f, x) * (W @ x))
        return x

    def _precond(self, p):
        return lambda r: self._pc_m(p, self._pc_mt(p, r))

    def _count_cg(self, it, maxit=None):
        """Adds one solve's per-column CG iterations to `cg_stats`, without
        a host read."""
        maxit = self.cg_max_num_it if maxit is None else maxit
        it = it.reshape(-1)
        row = torch.stack([torch.full_like(it[0], it.numel()), it.sum(),
                           (it >= maxit).sum()])
        self._cg_acc = row if self._cg_acc is None else self._cg_acc + row

    def cg_stats(self, reset=False):
        """{"solves", "iterations", "at_maxit"} over every CG solve since
        the last reset: columns solved (quadratic forms, adjoint solves,
        the SLQ gradient's probes, predictions), their iterations and
        those that stopped at cg_max_num_it (one host read)."""
        acc = [0, 0, 0] if self._cg_acc is None else self._cg_acc.tolist()
        if reset:
            self._cg_acc = None
        return dict(zip(("solves", "iterations", "at_maxit"), acc))

    def _build_solvers(self, num_extra_rows):
        """The CG solve and the congruence SLQ over `_matvec` and the
        preconditioner, with the JAX package's probes and chunking."""
        n = self.n
        chunk = max(1, min(self.num_rand_vec_trace,
                           int(2e8 // max(1, n * num_extra_rows))))
        self._slq = make_slq_logdet_congruence(
            self._matvec, self._pc_m, self._pc_mt,
            lambda p: p[self._PC + 3], self._precond, n, rank=min(n, 50),
            num_probes=self.num_rand_vec_trace,
            seed=self.seed_rand_vec_trace, dtype=self.dtype,
            device=self.device, probe_chunk=chunk,
            cg_tol=max(self.cg_delta_conv, 1e-4 if n > 50_000 else 0.0),
            cg_maxit=self.cg_max_num_it, count=self._count_cg)
        self._solve = make_cg_solve_precond(
            self._matvec, self._precond, tol=self.cg_delta_conv,
            maxit=self.cg_max_num_it, count=self._count_cg)

    def _pc_parts(self, Zt, D):
        """(Dinvs, W, f, log|P|) of the Woodbury preconditioner P =
        D^1/2 (I + Zt'Zt) D^1/2, or of its diagonal part (Zt None), or
        the identity ("none"), all without a graph."""
        dt, dev = self.dtype, self.device
        empty = torch.zeros((0, self.n), dtype=dt, device=dev)
        none = torch.zeros(0, dtype=dt, device=dev)
        if self.cg_preconditioner_type == "none":
            return (torch.ones(self.n, dtype=dt, device=dev), empty, none,
                    torch.zeros((), dtype=dt, device=dev))
        Dinvs = 1.0 / torch.sqrt(D)
        if Zt is None:
            return Dinvs, empty, none, torch.sum(torch.log(D))
        W, f, ldp = fitc_pc_factor(Zt * Dinvs[None, :], D)
        return Dinvs, W, f, ldp

    # ------------------------------------------------------------------
    def _quad_logdet(self, theta_log, y):
        p = self._factors(theta_log)
        x = self._solve_sigma(p, y)
        return y @ x, self._slq(*p)

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
        p = self._factors(theta_log)
        MiX = self._solve_sigma(p, X)
        Miy = self._solve_sigma(p, y)
        La = chol(X.T @ MiX)
        return torch.cholesky_solve((X.T @ Miy)[:, None], La)[:, 0]

    def _coef_grad(self, theta_log, sigma2, resid, X):
        p = self._factors(theta_log)
        return -(X.T @ self._solve_sigma(p, resid)) / sigma2

    # the raw differentiable closures for the device L-BFGS (ops/lbfgs.py)
    nll_profiled_raw = _nll_profiled
    wls_coef_raw = _wls

    def fisher_transformed(self, u, include_error_var=True):
        raise NotImplementedError(
            f"fisher_scoring is not supported with iterative {self._name}; "
            "use lbfgs or gradient_descent")

    def hess_full(self, u, y):
        raise NotImplementedError(
            f"optimizer_cov='newton' is not supported with iterative "
            f"{self._name}; use lbfgs or gradient_descent")

    def fisher_original(self, pars_orig):
        """Standard errors: the dense engine's Fisher information of the
        same approximation up to n = 4,000, NaN above (the reference
        simulates there, re_model_template.h:5130)."""
        if self.n > 4000:
            return np.full((self.num_cov_par, self.num_cov_par), np.nan)
        from .gaussian_gp import DenseGaussianEngine
        dense = DenseGaussianEngine([self.comp], self.n, dtype=self.dtype,
                                    device=self.device)
        return dense.fisher_original(pars_orig)

    def psi_tilde_inv_mat(self, pars_internal, M):
        raise NotImplementedError(
            f"the GPBoost algorithm with iterative {self._name} is not "
            "supported (no Psi~^-1 for the Newton leaf updates); use "
            "matrix_inversion_method='cholesky'")

    # ------------------------------------------------------------------
    def predict(self, pars_orig, y_resid, pred_data, predict_var=False,
                predict_cov_mat=False, predict_response=False):
        """Posterior predictive mean and (co)variance: the cross and
        prediction blocks of the adapter's kernel (CalcPred,
        re_model_template.h:11170), the training solves by CG, each column
        stopping on its own."""
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        sigma2 = float(pars_orig[0])
        t = self.transform_pars(pars_orig)
        with torch.no_grad():
            theta_log = self._t(np.log(t[1:]))
            p = self._factors(theta_log)
            K_cross, K_pred = assemble_pred_covs(
                self.components, self.par_offsets, [pars_orig[1]],
                theta_log, pred_data, self.n, self.dtype, self.device)
            alpha_v = self._solve_sigma(p, self.prep_y(y_resid)) / sigma2
            out = {"mu": self._host(K_cross.T @ alpha_v)[0]}
            if predict_cov_mat or predict_var:
                V = self._solve_sigma(p, K_cross) / sigma2
                if predict_cov_mat:
                    cov = K_pred - K_cross.T @ V
                    if predict_response:
                        cov = cov + sigma2 * torch.eye(
                            pred_data["n_pred"], dtype=self.dtype,
                            device=self.device)
                    out["cov"] = self._host(cov)[0]
                    if predict_var:
                        out["var"] = np.diagonal(out["cov"]).copy()
                else:
                    var = torch.diagonal(K_pred) - torch.sum(K_cross * V, 0)
                    if predict_response:
                        var = var + sigma2
                    out["var"] = self._host(var)[0]
        return out


def _col(d, x):
    """d (n,) broadcast against x (n,) or columns (n, k)."""
    return d if x.ndim == 1 else d[:, None]


class FSAIterativeGaussianEngine(IterativeGaussianBase):
    """Gaussian marginal NLL, gradients and prediction for gp_approx in
    ('tapering', 'full_scale_tapering') at scale. p = (vals (n, k),
    diag_r (n,), E (m, n), v, Dinvs, W, f, log|P|)."""

    _PC = 4

    def __init__(self, components, num_data, dtype=torch.float64,
                 num_rand_vec_trace=50, cg_max_num_it=1000,
                 cg_delta_conv=1e-6, seed_rand_vec_trace=1,
                 cg_preconditioner_type="fitc", *, device):
        self._name = "tapering/FSA"
        self._init_iterative(components, num_data, dtype, device,
                             self._name)
        adapter = self.comp.cov_fn
        self.taper = adapter.taper
        self.has_ip = hasattr(adapter, "ip")
        self.num_rand_vec_trace = int(num_rand_vec_trace)
        self.cg_max_num_it = int(cg_max_num_it)
        self.cg_delta_conv = float(cg_delta_conv)
        self.seed_rand_vec_trace = int(seed_rand_vec_trace)
        self._set_preconditioner(cg_preconditioner_type)

        idx, dist, mask = taper_neighbors(self.comp.coords,
                                          float(self.taper.taper_range))
        self.k = idx.shape[1]
        dev = self.device
        self._bags = NeighborBags(idx, dev)
        self._nb_dist = torch.as_tensor(dist, device=dev).to(dtype)
        # the taper is parameter-free: evaluated once
        self._nb_taper = self.taper._wendland_taper(self._nb_dist) \
            * torch.as_tensor(mask, device=dev).to(dtype)
        self.m_ip = 0
        if self.has_ip:
            ip = np.asarray(adapter.ip, dtype=np.float64)
            self.m_ip = len(ip)
            self._d_uu = device_dist(ip, ip, dtype, dev)
            self._d_un = device_dist(ip, self.comp.coords, dtype, dev)
        self._build()

    def _set_preconditioner(self, v):
        pc = _PC_ALIASES.get(v, v)
        if pc not in ("fitc", "none"):
            raise ValueError(
                f"cg_preconditioner_type '{v}' is not supported for "
                "FSA/tapering; use 'fitc' (predictive_process_plus_diagonal) "
                "or 'none' (CG_utils.h:554)")
        self.cg_preconditioner_type = pc

    def _build(self):
        self._build_solvers(self.k + self.m_ip)

    # ------------------------------------------------------------------
    def _factors(self, theta_log):
        """The differentiable operator pieces at theta and the (graph-free)
        preconditioner factorization."""
        v = torch.exp(theta_log[0])
        alphas = torch.exp(theta_log[1:])
        c_nb = self.base.corr_from_dist(self._nb_dist, alphas)
        if self.has_ip:
            Kuu = self.base.corr_from_dist(self._d_uu, alphas) \
                + _JITTER * torch.eye(self.m_ip, dtype=self.dtype,
                                      device=self.device)
            E = torch.linalg.solve_triangular(
                chol(Kuu), self.base.corr_from_dist(self._d_un, alphas),
                upper=False)                                   # (m, n)
            ET = E.T
            u_nb = torch.einsum("nkm,nm->nk", self._bags.gather(ET), ET)
            vals = self._nb_taper * (c_nb - u_nb)
            diag_r = 1.0 - torch.sum(E * E, dim=0)
        else:
            E = torch.zeros((0, self.n), dtype=self.dtype, device=self.device)
            vals = self._nb_taper * c_nb
            diag_r = torch.ones(self.n, dtype=self.dtype, device=self.device)
        with torch.no_grad():
            D = 1.0 + v * diag_r
            Zt = torch.sqrt(v) * E if self.has_ip \
                and self.cg_preconditioner_type == "fitc" else None
            pc = self._pc_parts(Zt, D)
        return (vals, diag_r, E, v) + pc

    def _matvec(self, p, x):
        """M x = x + v (diag_r x + R_offdiag x + E'E x)."""
        vals, diag_r, E, v = p[:4]
        r = _col(diag_r, x) * x + _At.apply(vals, x, self._bags)
        if self.has_ip:
            r = r + E.T @ (E @ x)
        return x + v * r

    def _solve_sigma(self, p, x):
        return self._solve(p, x)

    def training_re(self, pars_orig, y_resid, predict_var=False):
        """Posterior mean of the GP at the training points,
        (M - I) M^-1 resid (re_model_template.h:4420)."""
        if predict_var:
            raise NotImplementedError(
                "predict_training_data_random_effects with predict_var=True "
                "is not supported with iterative tapering/FSA")
        t = self.transform_pars(pars_orig)
        with torch.no_grad():
            p = self._factors(self._t(np.log(t[1:])))
            y_aux = self._solve(p, self.prep_y(y_resid))
            mean = self._matvec(p, y_aux) - y_aux
        return self._host(mean)[0][:, None], None
