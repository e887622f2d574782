"""FITC-Laplace: non-Gaussian likelihoods with a FITC latent GP
(counterpart of gpboost_tpu/models/fitc_laplace.py; reference
likelihoods.h:4028 FindModePostRandEffCalcMLLFITC, :7000
CalcGradNegMargLikelihoodLaplaceApproxFITC, :8200 PredictLaplaceApproxFITC).

Latent prior Sigma = diag(dd) + U U', U = sqrt(v) (L_uu^-1 K_uf)' (n, m),
dd the FITC diagonal residual. Every operation is Woodbury-structured,
O(n m^2), and no n x n matrix is formed:

    Sigma^-1 v              diagonal plus a rank-m correction;
    (Sigma^-1 + W)^-1 r     a second Woodbury with G = diag(1/dd + w);
    log|I + W Sigma|        sum log(1 + w dd) + log|I_m + U'(w/(1 + w dd))U|.

The mode b (the latent values, not the dense engine's a = Sigma^-1 b) is
found by Newton with Armijo backtracking, warm-started from the previous
mode, with ONE host read per Newton step: the objectives of the 20 step
lengths 1, 1/2, ..., 2^-19 are evaluated in one batched pass and the first
that satisfies the Armijo condition is taken, which is the reference's
sequential choice (models/laplace.py does the same). Gradients wrt the
covariance and aux parameters and the fixed effects F come from the
implicit-function `torch.autograd.Function` of models/laplace.py, as the
reference's nll_fwd / nll_bwd custom_vjp.
"""

import math

import numpy as np
import torch

from .gaussian_base import chol
from .fitc import FITCBlocks
from .laplace import LaplaceEngineBase, MAXIT_MODE_NEWTON


class FITCLaplaceEngine(LaplaceEngineBase):
    """Laplace-approximated NLL, gradients and prediction with a FITC latent
    covariance."""

    matrix_inversion_method = "cholesky"

    def __init__(self, components, num_data, likelihood, num_ind_points=500,
                 ind_points_selection="kmeans++", seed=0,
                 dtype=torch.float64, weights=None, *, device):
        if len(components) != 1 or components[0].kind != "gp":
            raise ValueError("gp_approx='fitc' requires exactly one GP "
                             "component")
        self._init_common(likelihood, num_data, dtype, device, weights)
        self.comp = components[0]
        self.components = [self.comp]
        self.par_offsets = [0]
        self.num_theta = self.comp.num_cov_par
        self.num_cov_par = self.num_theta
        self.num_par = self.num_theta + self.num_aux
        self.dim_mode = self.n
        self._blocks = FITCBlocks(self.comp, num_data, num_ind_points,
                                  ind_points_selection, seed, dtype,
                                  self.device)
        self.ip = self._blocks.ip
        self.m = self._blocks.m
        self._eye_m = torch.eye(self.m, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def _parts_latent(self, theta_log):
        """(dd (n,), U (n, m)) of the latent Sigma = diag(dd) + U U'."""
        v = torch.exp(theta_log[0])
        _, V = self._blocks.V(torch.exp(theta_log[1:]))
        rho = torch.sum(V * V, dim=0)
        dd = v * torch.clamp_min(1.0 - rho, 0.0) + 1e-10
        return dd, torch.sqrt(v) * V.T

    def _split_u(self, u):
        dd, U = self._parts_latent(u[:self.num_theta])
        return dd, U, torch.exp(u[self.num_theta:])

    def _sigma_inv(self, dd, U, v):
        """Sigma^-1 v for v (n,) or (n, k) by Woodbury."""
        v2 = v[:, None] if v.ndim == 1 else v
        e = v2 / dd[:, None]
        UD = U / dd[:, None]
        L = chol(self._eye_m + U.T @ UD)
        out = e - UD @ torch.cholesky_solve(U.T @ e, L)
        return out[:, 0] if v.ndim == 1 else out

    def _solve_H(self, dd, U, w, rhs):
        """(Sigma^-1 + diag(w))^-1 rhs for rhs (n,) or (n, k), rank m."""
        r2 = rhs[:, None] if rhs.ndim == 1 else rhs
        g = 1.0 / dd + w
        F_ = U / dd[:, None]
        Fg = F_ / g[:, None]
        S = self._eye_m + U.T @ F_ - F_.T @ Fg
        Ls = chol(S)
        t0 = r2 / g[:, None]
        out = t0 + Fg @ torch.cholesky_solve(F_.T @ t0, Ls)
        return out[:, 0] if rhs.ndim == 1 else out

    def _logdet_ImWSigma(self, dd, U, w):
        """log|I + diag(w) Sigma|."""
        s = 1.0 + w * dd
        Lw = chol(self._eye_m + U.T @ (U * (w / s)[:, None]))
        return torch.sum(torch.log(s)) \
            + 2.0 * torch.sum(torch.log(torch.diagonal(Lw)))

    # ------------------------------------------------------------------
    def _mode_solve(self, u, F, y, b_init):
        with torch.no_grad():
            dd, U, aux = self._split_u(u)
            b = b_init
            sb = self._sigma_inv(dd, U, b)
            obj = -0.5 * (b @ sb) + self._loglik(y, self._loc(b, F), aux)
            lrs = self._lrs[:, None]
            it = 0
            while it < MAXIT_MODE_NEWTON:
                d1, w = self._d1_W(y, self._loc(b, F), aux,
                                   self._fisher_mode, False)
                grad = d1 - sb
                delta = self._solve_H(dd, U, w, grad)
                gdd = grad @ delta
                b_k = b + lrs * delta
                sb_k = self._sigma_inv(dd, U, b_k.T).T
                obj_k = -0.5 * torch.sum(b_k * sb_k, -1) \
                    + self._loglik(y, self._loc(b_k, F), aux)
                k = self._armijo(obj_k, obj, gdd)
                (b_new,) = self._pick(k, b_k)
                # the chosen point's Sigma^-1 b and objective once more as
                # one vector, as the reference evaluates them: Sigma^-1 is
                # ill-conditioned (dd ~ 1e-10 where an inducing point meets
                # a data point), and the batched product rounds otherwise
                sb_new = self._sigma_inv(dd, U, b_new)
                obj_new = -0.5 * (b_new @ sb_new) \
                    + self._loglik(y, self._loc(b_new, F), aux)
                done = self._newton_done(obj_new, obj, it)
                b, sb, obj = b_new, sb_new, obj_new
                it += 1
                if done:
                    break
        return b, it

    def _g(self, u, F, b, y, create_graph, value=True):
        dd, U, aux = self._split_u(u)
        loc = self._loc(b, F)
        _, w = self._d1_W(y, loc, aux, self._fisher_det, create_graph)
        return 0.5 * (b @ self._sigma_inv(dd, U, b)) \
            - self._loglik(y, loc, aux) \
            + 0.5 * self._logdet_ImWSigma(dd, U, w)

    def _r(self, u, F, b, y):
        dd, U, aux = self._split_u(u)
        return self._sigma_inv(dd, U, b) - self._d1(y, self._loc(b, F), aux)

    def _adjoint_solve(self, u, F, b, y, g_b):
        with torch.no_grad():
            dd, U, aux = self._split_u(u)
            _, w = self._d1_W(y, self._loc(b, F), aux, self._fisher_det, False)
            return self._solve_H(dd, U, w, g_b)

    # ------------------------------------------------------------------
    # parameter transforms (sigma2 = 1 for a non-Gaussian likelihood)
    def transform_pars(self, pars_orig):
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        out = [pars_orig[0]]
        out.extend(np.atleast_1d(self.comp.cov_fn.range_to_transformed(
            pars_orig[1:], var=pars_orig[0])))
        return np.asarray(out)

    def back_transform_pars(self, t):
        t = np.asarray(t, dtype=np.float64)
        out = [t[0]]
        out.extend(np.atleast_1d(self.comp.cov_fn.range_from_transformed(
            t[1:], var=t[0])))
        return np.asarray(out)

    # ------------------------------------------------------------------
    def predict(self, pars_orig, aux_pars, y, F, pred_data, a_init=None,
                predict_var=False, predict_cov_mat=False,
                predict_response=False, F_pred=None):
        """Latent predictions (PredictLaplaceApproxFITC): the cross
        covariance through the inducing points, the posterior correction of
        rank m. With U_p = sqrt(v) (L_uu^-1 K_up)' and a = d1 at the mode,
        mu = U_p U' a and cov = prior - U_p C U_p' with the m x m core
        C = U'(W - W H^-1 W)U, H = Sigma^-1 + W (the reference solves H for
        each prediction column of K_fp = U U_p'; the core is the same
        product through m columns)."""
        t = self.transform_pars(pars_orig)
        v = float(t[0])
        u = self._u_from_pars(pars_orig, aux_pars, y)
        cp = np.asarray(pred_data["comps"][0]["coords_pred"],
                        dtype=np.float64)
        if cp.ndim == 1:
            cp = cp[:, None]
        with torch.no_grad():
            ud = self._t(u)
            theta_log = ud[:self.num_theta]
            aux_d = torch.exp(ud[self.num_theta:])
            yd = self.prep_y(y)
            Fd = self._F(F) if F is not None else torch.zeros(
                self.n * self.num_sets_fe, dtype=self.dtype,
                device=self.device)
            b, nit = self._mode_solve(ud, Fd, yd,
                                      self.zero_mode() if a_init is None
                                      else a_init)
            self._note_it(nit)
            dd, U = self._parts_latent(theta_log)
            L_uu = self._blocks.L_uu(torch.exp(theta_log[1:]))
            Vp = self._blocks.V_pred(L_uu, torch.exp(theta_log[1:]), cp)
            U_p = math.sqrt(v) * Vp.T                          # (n_pred, m)
            loc = self._loc(b, Fd)
            a = self._d1(yd, loc, aux_d).detach()
            _, w = self._d1_W(yd, loc, aux_d, self._fisher_det, False)
            mu, zeta = self._split_pred(U_p @ (U.T @ a), F_pred)
            out = {}
            var = cov = None
            if predict_var or predict_cov_mat or predict_response:
                WU = w[:, None] * U
                C = U.T @ WU - WU.T @ self._solve_H(dd, U, w, WU)
                q_diag = torch.sum(U_p * U_p, dim=1)
                if predict_cov_mat:
                    q_pp = U_p @ U_p.T
                    cov = q_pp + torch.diag(torch.clamp_min(v - q_diag, 0.0)) \
                        - U_p @ C @ U_p.T
                    var = torch.diagonal(cov)
                else:
                    var = q_diag + torch.clamp_min(v - q_diag, 0.0) \
                        - torch.sum((U_p @ C) * U_p, dim=1)
                var = torch.clamp_min(var, 0.0)
            if predict_response:
                m_, vv = self._response(mu, var, zeta, aux_d)
                out["mu"] = self._host(m_)[0]
                if predict_var or predict_cov_mat:
                    out["var"] = self._host(vv)[0]
                return out
            out["mu"] = self._host(mu)[0]
            if predict_cov_mat:
                out["cov"] = self._host(cov)[0]
            if predict_var:
                out["var"] = self._host(var)[0].copy()
            return out
