"""Iterative full-scale Vecchia (FSVA / VIF), Gaussian likelihood, the
n-scaling path (counterpart of gpboost_tpu/models/fsva_iterative.py;
reference re_model_template.h:5866 with the `vifdu` preconditioner, CG
solvers CG_utils.h:208-318). The dense small-n formulation is
ops/taper.VIFCovarianceFunction on the dense engine.

Congruence by the Vecchia factor B of the residual process (det B = 1):

    Sigma_y / sigma2 = I + v (V'V + B^-1 D B^-T),   V = L_uu^-1 K_uf,
    T := B (Sigma_y / sigma2) B' = B B' + v Vt'Vt + v diag(D),
    Vt = V B'   (Vt[:, t] = V[:, t] - sum_j A[t, j] V[:, idx[t, j]]),

so the quadratic form is (By)' T^-1 (By) and log|Sigma/sigma2| = log|T|:
no triangular solve and no Neumann series anywhere. Every CG matvec is
B'x, B x, two (m_ip, n) matrix products and a diagonal. B v and B'w are
weighted `embedding_bag` sums over the neighbour pattern and its
transpose, sorted once on the host (ops/neighbor_bags.py, the operator of
the matrix-free Vecchia-Laplace engine): no index_add_
atomics, so products, gradients and CG counts are deterministic. The
gathers of V's columns by neighbour (the residual factors' inputs) have
the transposed bags' sum as their gradient, likewise without atomics.

The `vifdu` preconditioner is the low-rank-plus-diagonal capture of T,
P = v Vt'Vt + diag(B B') + v D, applied through the same eigh-based
Woodbury factor as the FSA engine's, with its exact log-determinant in
the SLQ congruence.
"""

import numpy as np
import torch

from .fsa_iterative import IterativeGaussianBase
from .gaussian_base import chol
from .fitc import device_dist
from ..ops.batched_chol import cho_solve_batched
from ..ops.neighbor_bags import NeighborBags, _At, _Att

_JITTER = 1e-10
_PC_ALIASES = {"predictive_process_plus_diagonal": "vifdu",
               "fitc": "vifdu"}


class FSVAIterativeGaussianEngine(IterativeGaussianBase):
    """Gaussian marginal NLL, gradients and prediction for
    gp_approx='full_scale_vecchia' at scale. p = (A (n, m), D (n,),
    Vt (m_ip, n), v, Dinvs, W, f, log|P|)."""

    _PC = 4

    def __init__(self, components, num_data, dtype=torch.float64,
                 num_rand_vec_trace=50, cg_max_num_it=1000,
                 cg_delta_conv=1e-6, seed_rand_vec_trace=1,
                 cg_preconditioner_type="vifdu", *, device):
        self._name = "full_scale_vecchia"
        self._init_iterative(components, num_data, dtype, device,
                             self._name)
        self.num_rand_vec_trace = int(num_rand_vec_trace)
        self.cg_max_num_it = int(cg_max_num_it)
        self.cg_delta_conv = float(cg_delta_conv)
        self.seed_rand_vec_trace = int(seed_rand_vec_trace)
        self._set_preconditioner(cg_preconditioner_type)

        adapter = self.comp.cov_fn
        coords = np.asarray(adapter.train_coords, dtype=np.float64)
        ip = np.asarray(adapter.ip, dtype=np.float64)
        self.m_ip = len(ip)
        self.m_nn = adapter.m_nn
        idx, mask = adapter.nn_idx, adapter.nn_mask
        dev = self.device
        self._bags = NeighborBags(idx, dev)
        self._mask = torch.as_tensor(mask, device=dev)
        self._pair = self._mask[:, :, None] & self._mask[:, None, :]
        self._eye = torch.eye(self.m_nn, dtype=dtype, device=dev)[None]
        # theta-independent neighbour distances, computed once on the host
        cn = coords[idx]                                    # (n, m, d)
        d_nn = np.sqrt(np.maximum(
            ((cn[:, :, None, :] - cn[:, None, :, :]) ** 2).sum(-1), 0))
        d_ni = np.sqrt(np.maximum(((cn - coords[:, None, :]) ** 2).sum(-1),
                                  0))
        self._d_nn = torch.as_tensor(d_nn, device=dev).to(dtype)
        self._d_ni = torch.as_tensor(d_ni, device=dev).to(dtype)
        self._d_uu = device_dist(ip, ip, dtype, dev)
        self._d_un = device_dist(ip, coords, dtype, dev)
        self._build()

    def _set_preconditioner(self, v):
        pc = _PC_ALIASES.get(v, v)
        if pc not in ("vifdu", "none"):
            raise ValueError(
                f"cg_preconditioner_type '{v}' is not supported for "
                "iterative full_scale_vecchia; use 'vifdu' or 'none' "
                "(re_model_template.h:5866)")
        self.cg_preconditioner_type = pc

    def _build(self):
        self._build_solvers(self.m_nn + self.m_ip)

    # ------------------------------------------------------------------
    def _factors(self, theta_log):
        """The residual Vecchia factors (A, D), the congruence-transformed
        inducing block Vt = V B' and the (graph-free) vifdu factor."""
        dt = self.dtype
        v = torch.exp(theta_log[0])
        alphas = torch.exp(theta_log[1:])
        Kuu = self.base.corr_from_dist(self._d_uu, alphas) \
            + _JITTER * torch.eye(self.m_ip, dtype=dt, device=self.device)
        E = torch.linalg.solve_triangular(
            chol(Kuu), self.base.corr_from_dist(self._d_un, alphas),
            upper=False)                                    # (m_ip, n)
        ET = E.T
        G = self._bags.gather(ET)                           # (n, m, m_ip)
        c_nn = self.base.corr_from_dist(self._d_nn, alphas)
        c_ni = self.base.corr_from_dist(self._d_ni, alphas)
        r_nn = c_nn - torch.einsum("bik,bjk->bij", G, G)
        r_ni = c_ni - torch.einsum("bik,bk->bi", G, ET)
        r_ii = 1.0 - torch.sum(ET * ET, dim=1)
        r_nn = torch.where(self._pair, r_nn, self._eye) + _JITTER * self._eye
        r_ni = torch.where(self._mask, r_ni, torch.zeros_like(r_ni))
        A = cho_solve_batched(r_nn, r_ni)
        A = torch.where(self._mask, A, torch.zeros_like(A))
        D = torch.clamp_min(r_ii - torch.sum(A * r_ni, dim=1), 1e-12)
        Vt = (ET - torch.einsum("bj,bjk->bk", A, G)).T      # (m_ip, n)
        with torch.no_grad():
            diag_BBt = 1.0 + torch.sum(A * A, dim=1)
            Dhat = diag_BBt + v * D
            Zt = torch.sqrt(v) * Vt \
                if self.cg_preconditioner_type == "vifdu" else None
            pc = self._pc_parts(Zt, Dhat)
        return (A, D, Vt, v) + pc

    def _B(self, A, x):
        return x - _At.apply(A, x, self._bags)

    def _Bt(self, A, w):
        return w - _Att.apply(A, w, self._bags)

    def _matvec(self, p, x):
        """T x = B B'x + v Vt'(Vt x) + v D x."""
        A, D, Vt, v = p[:4]
        r = self._B(A, self._Bt(A, x))
        r = r + v * (Vt.T @ (Vt @ x))
        return r + v * (D if x.ndim == 1 else D[:, None]) * x

    def _solve_sigma(self, p, x):
        """(Sigma/sigma2)^-1 x = B' T^-1 (B x)."""
        A = p[0]
        return self._Bt(A, self._solve(p, self._B(A, x)))

    def training_re(self, pars_orig, y_resid, predict_var=False):
        """Posterior mean of the GP at the training points, resid - y_aux
        with y_aux = (Sigma/sigma2)^-1 resid (from the congruence,
        B^-1 T (T^-1 B resid) = resid)."""
        if predict_var:
            raise NotImplementedError(
                "predict_training_data_random_effects with predict_var=True "
                "is not supported with iterative full_scale_vecchia")
        t = self.transform_pars(pars_orig)
        with torch.no_grad():
            p = self._factors(self._t(np.log(t[1:])))
            r = self.prep_y(y_resid)
            mean = r - self._solve_sigma(p, r)
        return self._host(mean)[0][:, None], None
