"""Dense exact-GP / mixed-effects engine, Gaussian likelihood (counterpart of
gpboost_tpu/models/gaussian_gp.py).

The Gaussian branch of REModelTemplate (re_model_template.h:2862
EvalNegLogLikelihoodGauss, :9302 CalcCovFactor, :11170 CalcPred) as one
dense covariance assembly and one n x n Cholesky (cuSOLVER on the card):

    Psi~(theta) = I + sum_j v~_j (W_j o K_j(alpha_j)),

with K_j a GP correlation matrix or all ones for a grouped random effect,
and W_j the same-group indicator (times outer(z, z) for a random slope).
A GP random coefficient with covariate z (gp_rand_coef_data) scales its
K_j's rows and columns by z on the device, and its cross and prediction
covariances by z and z_pred.
Gradients and the Hessian come from torch.autograd, the Fisher information
from forward-mode Jacobians of the assembly (torch.func.jacfwd), where the
reference used jax.grad, jax.hessian and jax.jacfwd. The façade routes every
Gaussian model with a GP component here unless gp_approx="vecchia", so a GP
combined with grouped random effects runs here at small n.

cluster_ids make the realizations of different clusters independent: every
component's W_j is multiplied by the same-cluster mask (one static masked
dense matrix for the reference's per-cluster blocks,
re_model_template.h:6067-6069). Observation weights w make the nugget of
row i sigma2 / w_i: Psi~ = diag(1/w) + sum_j v~_j (W_j o K_j).
"""

import math

import numpy as np
import torch

from .gaussian_base import GaussianEngineBase, chol
from ..ops.distances import pairwise_dist


def _dist(a, b, dtype, device):
    """Euclidean distances between host coordinate arrays, computed in
    float64 by direct differences and cast to dtype."""
    a = torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
    b = torch.as_tensor(np.asarray(b, dtype=np.float64), device=device)
    return pairwise_dist(a, b, method="direct").to(dtype)


def _on_device(x, dtype, device):
    """A host float64 array on the device in dtype."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64),
                           device=device).to(dtype)


def _pred_block(comp, pd, alphas, dtype, device):
    """One component's W_j o K_j at the prediction points (n_pred, n_pred)
    for the transformed ranges alphas of a GP: a grouped component's
    pred_W, or its level codes (the Woodbury engine's form); a GP's
    correlation, or an approximation adapter's own prediction block
    (ops/taper.py, components.py:54-84). A random coefficient without a
    pred_W scales the rows and columns by z_pred on the device (the
    reference multiplies by outer(z_pred, z_pred) built on the host,
    gaussian_gp.py:55-57)."""
    if comp.kind == "grouped":
        if pd.get("pred_W") is not None:
            return _on_device(pd["pred_W"], dtype, device)
        c = torch.as_tensor(np.asarray(pd["codes_pred"]), device=device)
        Kp = (c[:, None] == c[None, :]).to(dtype)
    else:
        cp = pd["coords_pred"]
        Kp = comp.cov_fn.corr_from_dist(_dist(cp, cp, dtype, device),
                                        alphas) \
            if comp.cov_fn.is_isotropic else comp.pred_corr(cp, alphas)
    if pd.get("z_pred") is not None:
        zp = _on_device(pd["z_pred"], dtype, device)
        Kp = Kp * zp[:, None] * zp[None, :]
    return Kp


def assemble_pred_covs(components, par_offsets, comp_vars, theta_log,
                       pred_data, n, dtype, device):
    """Cross (n, n_pred) and prediction (n_pred, n_pred) covariances on the
    original scale (AddPredCovMatrices, re_comp.h:494)."""
    n_pred = pred_data["n_pred"]
    K_cross = torch.zeros((n, n_pred), dtype=dtype, device=device)
    K_pred = torch.zeros((n_pred, n_pred), dtype=dtype, device=device)
    for comp, off, v, pd in zip(components, par_offsets, comp_vars,
                                pred_data["comps"]):
        alphas = None
        if comp.kind == "grouped":
            Kc = _on_device(pd["cross_W"], dtype, device)
        else:
            alphas = torch.exp(theta_log[off + 1: off + comp.num_cov_par])
            cp = pd["coords_pred"]
            Kc = comp.cov_fn.corr_from_dist(
                _dist(comp.coords, cp, dtype, device), alphas) \
                if comp.cov_fn.is_isotropic else comp.cross_corr(cp, alphas)
            if pd.get("z_pred") is not None:
                Kc = Kc * _on_device(comp.z, dtype, device)[:, None] \
                    * _on_device(pd["z_pred"], dtype, device)[None, :]
        K_cross = K_cross + float(v) * Kc
        K_pred = K_pred + float(v) * _pred_block(comp, pd, alphas, dtype,
                                                 device)
    if pred_data.get("cross_cluster_mask") is not None:
        K_cross = K_cross * _on_device(pred_data["cross_cluster_mask"],
                                       dtype, device)
        K_pred = K_pred * _on_device(pred_data["pred_cluster_mask"], dtype,
                                     device)
    return K_cross, K_pred


def prior_pred_cov(components, comp_pars, pred_data, dtype, device):
    """The model's covariance of the random effects at the prediction
    points, sum_j v_j (W_j o K_j), from each component's original-scale
    parameters comp_pars[j] = [variance, ranges...]: the prior that
    `GPModel.predict(sample_prior=True)` draws from, masked to the same
    cluster when pred_data holds a pred_cluster_mask."""
    n_pred = pred_data["n_pred"]
    K = torch.zeros((n_pred, n_pred), dtype=dtype, device=device)
    for comp, pars, pd in zip(components, comp_pars, pred_data["comps"]):
        alphas = None if comp.kind == "grouped" else _on_device(
            np.atleast_1d(comp.cov_fn.range_to_transformed(
                np.asarray(pars[1:]), var=pars[0])), dtype, device)
        K = K + float(pars[0]) * _pred_block(comp, pd, alphas, dtype, device)
    if pred_data.get("pred_cluster_mask") is not None:
        K = K * _on_device(pred_data["pred_cluster_mask"], dtype, device)
    return K


class DenseSigmaAssembly:
    """Sigma(theta) = sum_j v_j (W_j o K_j) over the random-effect
    components, on the device, with the same-cluster mask in every W_j when
    cluster_ids are given."""

    def __init__(self, components, num_data, dtype, device,
                 cluster_ids=None):
        self.components = list(components)
        self.n = int(num_data)
        self.dtype = dtype
        self.device = device
        self.cluster_codes = self._cluster_mask = None
        if cluster_ids is not None:
            codes = np.unique(np.asarray(cluster_ids), return_inverse=True)[1]
            self.cluster_codes = codes
            self._cluster_mask = torch.as_tensor(
                codes[:, None] == codes[None, :], device=device).to(dtype)
        self._comp_static = []
        self.par_offsets = []
        offset = 0
        for comp in self.components:
            self.par_offsets.append(offset)
            offset += comp.num_cov_par
            W = D = z = None
            if comp.kind == "grouped":
                W = comp.same_group_mask()
                if comp.z is not None:
                    W = W * np.outer(comp.z, comp.z)
                W = torch.as_tensor(W, device=device).to(dtype)
            else:
                if comp.cov_fn.is_isotropic:
                    D = _dist(comp.coords, comp.coords, dtype, device)
                if comp.z is not None:
                    # a GP random coefficient scales the kernel's rows and
                    # columns by z on the device; no n x n outer product
                    z = _on_device(comp.z, dtype, device)
            if self._cluster_mask is not None:
                W = self._cluster_mask if W is None \
                    else W * self._cluster_mask
            self._comp_static.append({"W": W, "D": D, "z": z})
        self.num_theta = offset

    def sigma(self, theta_log):
        """sum_j v_j (W_j o K_j(alpha_j)), v_j = exp(theta_log[offset_j])."""
        M = torch.zeros((self.n, self.n), dtype=self.dtype,
                        device=self.device)
        for comp, static, off in zip(self.components, self._comp_static,
                                     self.par_offsets):
            v = torch.exp(theta_log[off])
            if comp.kind == "grouped":
                K = static["W"]
            else:
                alphas = torch.exp(theta_log[off + 1: off + comp.num_cov_par])
                # without distances (an approximation adapter) the
                # component evaluates its kernel (gaussian_gp.py:119-130)
                K = comp.corr(static["D"], alphas)
                if static["z"] is not None:
                    K = K * static["z"][:, None] * static["z"][None, :]
                if static["W"] is not None:
                    K = K * static["W"]
            M = M + v * K
        return M


def report_matrices(assembly, theta_log):
    """Per-component reporting covariances R_j (n, n) divided by sigma2:
    row i is the covariance of component j's reported value at observation
    i with the total random effect at each data point. A random slope
    reports the latent coefficient, so only the column side carries z
    (re_model_template.h:4420 PredictTrainingDataRandomEffects)."""
    out = []
    for comp, static, off in zip(assembly.components, assembly._comp_static,
                                 assembly.par_offsets):
        v = torch.exp(theta_log[off])
        if comp.kind == "grouped":
            R = torch.as_tensor(comp.same_group_mask(),
                                device=assembly.device).to(assembly.dtype)
        else:
            alphas = torch.exp(theta_log[off + 1: off + comp.num_cov_par])
            R = comp.corr(static["D"], alphas)
        if assembly._cluster_mask is not None:
            R = R * assembly._cluster_mask
        if comp.z is not None:
            R = R * torch.as_tensor(comp.z, device=assembly.device).to(
                assembly.dtype)[None, :]
        out.append(v * R)
    return out


class DenseGaussianEngine(GaussianEngineBase):
    """Marginal NLL, gradients, Fisher information and prediction, dense
    path. Tensor arguments named y, X or resid are device tensors in data
    order."""

    def __init__(self, components, num_data, dtype=torch.float64, *, device,
                 cluster_ids=None, weights=None):
        self.device = torch.device(device)
        self.dtype = dtype
        self.weights = None if weights is None \
            else np.asarray(weights, dtype=np.float64)
        self._assembly = DenseSigmaAssembly(components, num_data, dtype,
                                            self.device, cluster_ids)
        self.cluster_codes = self._assembly.cluster_codes
        self.components = self._assembly.components
        self.n = self._assembly.n
        self.par_offsets = self._assembly.par_offsets
        self.num_theta = self._assembly.num_theta
        self.num_cov_par = self.num_theta + 1

    # ------------------------------------------------------------------
    def psi_tilde(self, theta_log):
        """Scaled covariance diag(1/w) + sum_j v~_j (W_j o K_j) (the
        identity without weights)."""
        if self.weights is None:
            eye = torch.eye(self.n, dtype=self.dtype, device=self.device)
        else:
            eye = torch.diag(torch.as_tensor(1.0 / self.weights,
                                             device=self.device).to(
                                                 self.dtype))
        return eye + self._assembly.sigma(theta_log)

    def psi_original(self, pars_orig):
        """sigma2 I + sum_j v_j (W_j o K_j(rho_j)) from original pars."""
        theta_log, sigma2 = self._orig_to_internal(pars_orig)
        return sigma2 * self.psi_tilde(theta_log)

    def _solve(self, theta_log, b):
        """(L, Psi~^-1 b)."""
        L = chol(self.psi_tilde(theta_log))
        x = torch.cholesky_solve(b[:, None] if b.ndim == 1 else b, L)
        return L, (x[:, 0] if b.ndim == 1 else x)

    def _quad_logdet(self, theta_log, y):
        L, alpha_v = self._solve(theta_log, y)
        return y @ alpha_v, 2.0 * torch.sum(torch.log(torch.diagonal(L)))

    def _nll_parts(self, theta_log, sigma2, y):
        quad, logdet = self._quad_logdet(theta_log, y)
        n = self.n
        nll = 0.5 * (quad / sigma2 + logdet + n * torch.log(sigma2)
                     + n * math.log(2.0 * math.pi))
        return nll, quad

    def _nll_profiled(self, theta_log, y):
        """NLL with the nugget profiled out, sigma2_hat = quad / n
        (optim_utils.h:243 EvalLLforLBFGSpp); quad comes back as aux."""
        quad, logdet = self._quad_logdet(theta_log, y)
        n = self.n
        return 0.5 * (logdet + n * torch.log(quad / n) + n
                      + n * math.log(2.0 * math.pi)), quad

    def _wls(self, theta_log, y, X):
        """GLS coefficients (re_model_template.h:9942 UpdateCoefGLS)."""
        L = chol(self.psi_tilde(theta_log))
        MiX = torch.cholesky_solve(X, L)
        Miy = torch.cholesky_solve(y[:, None], L)[:, 0]
        La = chol(X.T @ MiX)
        return torch.cholesky_solve((X.T @ Miy)[:, None], La)[:, 0]

    def _coef_grad(self, theta_log, sigma2, resid, X):
        _, Pr = self._solve(theta_log, resid)
        return -(X.T @ Pr) / sigma2

    # the raw differentiable closures for the device L-BFGS (ops/lbfgs.py)
    nll_profiled_raw = _nll_profiled
    wls_coef_raw = _wls

    # ------------------------------------------------------------------
    def fisher_transformed(self, u, include_error_var=True):
        """Fisher information on the transformed (log) scale
        (CalcFisherInformation, transf_scale=true): FI[0,0] = n/2,
        FI[0,j] = tr(M^-1 dM_j)/2, FI[j,k] = tr(M^-1 dM_j M^-1 dM_k)/2."""
        with torch.no_grad():
            theta_log = self._t(u)[1:]
            L = chol(self.psi_tilde(theta_log))
            dM = torch.func.jacfwd(self.psi_tilde)(theta_log)   # (n, n, p)
            p = self.num_theta
            dM = torch.movedim(dM, -1, 0)
            A = torch.cholesky_solve(dM, L.expand(p, -1, -1))   # M^-1 dM_j
            FI_cc = 0.5 * torch.einsum("pij,qji->pq", A, A)
            if not include_error_var:
                return self._host(FI_cc)[0]
            FI = FI_cc.new_zeros((p + 1, p + 1))
            FI[0, 0] = self.n / 2.0
            tr = 0.5 * torch.diagonal(A, dim1=1, dim2=2).sum(-1)
            FI[0, 1:] = tr
            FI[1:, 0] = tr
            FI[1:, 1:] = FI_cc
            return self._host(FI)[0]

    def fisher_original(self, pars_orig):
        """Fisher information wrt the original-scale parameters
        (CalcFisherInformation, transf_scale=false)."""
        with torch.no_grad():
            pars = self._t(pars_orig)
            L = chol(self.psi_original(pars))
            dPsi = torch.movedim(torch.func.jacfwd(self.psi_original)(pars),
                                 -1, 0)
            A = torch.cholesky_solve(dPsi, L.expand(len(pars), -1, -1))
            return self._host(0.5 * torch.einsum("pij,qji->pq", A, A))[0]

    # ------------------------------------------------------------------
    def predict(self, pars_orig, y_resid, pred_data, predict_var=False,
                predict_cov_mat=False, predict_response=False):
        """Posterior predictive mean and (co)variance of the random part
        (re_model_template.h:3392 Predict, :11170 CalcPred)."""
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        sigma2 = pars_orig[0]
        t = self.transform_pars(pars_orig)
        with torch.no_grad():
            theta_log = self._t(np.log(t[1:]))
            L = chol(self.psi_tilde(theta_log))
            K_cross, K_pred = assemble_pred_covs(
                self.components, self.par_offsets,
                [pars_orig[1 + off] for off in self.par_offsets], theta_log,
                pred_data, self.n, self.dtype, self.device)
            r = self.prep_y(y_resid)
            alpha_v = torch.cholesky_solve(r[:, None], L)[:, 0] / sigma2
            out = {"mu": self._host(K_cross.T @ alpha_v)[0]}
            if predict_cov_mat or predict_var:
                V = torch.cholesky_solve(K_cross, L) / sigma2
                cov = K_pred - K_cross.T @ V
                if predict_response:
                    cov = cov + sigma2 * torch.eye(
                        pred_data["n_pred"], dtype=self.dtype,
                        device=self.device)
                cov = self._host(cov)[0]
                if predict_cov_mat:
                    out["cov"] = cov
                if predict_var:
                    out["var"] = np.diagonal(cov).copy()
        return out

    def training_re(self, pars_orig, y_resid, predict_var=False):
        """Per-component posterior means (and variances) of the random
        effects at the training points: mean_j = R_j Psi~^-1 resid,
        var_j = sigma2 (v~_j - diag(R_j Psi~^-1 R_j'))
        (re_model_template.h:4420)."""
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        sigma2 = pars_orig[0]
        t = self.transform_pars(pars_orig)
        with torch.no_grad():
            theta_log = self._t(np.log(t[1:]))
            L, y_aux = self._solve(theta_log, self.prep_y(y_resid))
            Rs = report_matrices(self._assembly, theta_log)
            means = self._host(torch.stack([R @ y_aux for R in Rs], 1))[0]
            if not predict_var:
                return means, None
            vs = []
            for R, off in zip(Rs, self.par_offsets):
                PiRt = torch.cholesky_solve(R.T, L)
                vs.append(sigma2 * (t[1 + off] - torch.sum(R * PiRt.T, 1)))
            return means, self._host(torch.stack(vs, 1))[0]

    def psi_tilde_inv_mat(self, pars_internal, M):
        """Psi~^-1 M for M (n, L) on the device (gbdt.py:2401-2404 dense
        branch)."""
        theta_log = self._t(np.log(np.asarray(pars_internal)[1:]))
        with torch.no_grad():
            _, out = self._solve(theta_log, M.to(self.dtype))
        return out.to(M.dtype)
