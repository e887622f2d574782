"""Woodbury-identity engine for Gaussian models whose random effects are all
grouped (counterpart of gpboost_tpu/models/grouped_re.py, Cholesky branch).

Reference semantics: re_model_template.h:7129
InitializeMatricesForUseWoodburyIdentity, :9691 CalcYAux, :9837 CalcYtilde.
With q the total number of levels over all components,

    Psi~  = I_n + Z Sigma Z',   Sigma = blockdiag(v~_j I_{m_j}),
    A     = Sigma^-1 + Z'Z      (q x q),
    y' Psi~^-1 y = y'y - (Z'y)' A^-1 (Z'y),
    log|Psi~|    = log|A| + sum_j m_j log v~_j,

so every evaluation is one dense q x q Cholesky (cuSOLVER on the card).

Device layout: Z'Z is built once on the host (its entries summed in row
order) and kept on the device as a dense (q, q) matrix. The data-sized
statistics Z'v, v'v, Z'X and X'X are computed on the device, because in
GPBoost the residual changes every round and is a device tensor: Z'v is a
deterministic segment sum (`SegmentSum`: rows sorted by level once, then
two padded gathers and row sums, no atomics), so two runs give the same
bits. The statistics of the last response and the last X are cached by
tensor identity. Gradients come from torch.autograd through the q x q
Cholesky; the Fisher information is the reference's closed form.

Ported: NLL, profiled NLL and gradients, the Fisher information on the
transformed and the original scale, GLS and gradient coefficient steps,
`training_re`, `predict`, and `psi_tilde_inv_mat` on the device (the
Woodbury branch of gbdt.py:2405-2419, which the reference runs in host
scipy). matrix_inversion_method="iterative" (the reference's branch above
q = 20,000, grouped_re.py:135-155 there; CG_utils.h:977 CGRandomEffects,
:384 LogDetStochTridiag) takes the NLL's A^-1 Z'y by CG (tol 1e-8) and
log|A| by SLQ (rank min(q, 100), num_rand_vec_trace probes), both with
their implicit gradients (ops/iterative.py); the standard errors, GLS
steps and predictions keep the Cholesky, as there.

Observation weights w (the nugget of row i is sigma2 / w_i, Psi~ =
diag(1/w) + Z Sigma Z') replace Z'Z, Z'v, v'v, Z'X and X'X by Z'WZ, Z'Wv,
v'Wv, Z'WX and X'WX, and add -sum log w to log|Psi~|. The GLS and the
coefficient gradient use X'WX, X'Wy and X'Wr, the closed form
(X' Psi~^-1 X)^-1 X' Psi~^-1 y: the reference's grouped_re.py:124, :283 and
:300 keep the unweighted X'X, X'y and X'r there, which gives other
coefficients (NaN in a test case of tests/test_torch_weights_clusters.py).
"""

import math

import numpy as np
import torch

from ..ops.iterative import make_cg_solve, make_slq_logdet
from .gaussian_base import GaussianEngineBase, chol


def pred_incidence(pred_data, block_sizes, level_off, variances):
    """The prediction rows' incidence in sparse form: (cols (J, n_pred)
    int64, each row's column of Z_pred per component, -1 for a level not
    seen in training; zp (J, n_pred) float64, its value (1, or the random
    slope's covariate); prior (n_pred,), the prior variance of the unseen
    levels, sum_j variances[j] zp_j^2). Z_pred has one entry per row and
    component, and the components' columns are disjoint, so the diagonal
    of Z_pred S Z_pred' is sum_{j,k} zp_j zp_k S[cols_j, cols_k]."""
    n_pred = pred_data["n_pred"]
    J = len(pred_data["comps"])
    cols = np.full((J, n_pred), -1, dtype=np.int64)
    zps = np.ones((J, n_pred))
    prior = np.zeros(n_pred)
    for j, pd in enumerate(pred_data["comps"]):
        codes = np.asarray(pd["codes_pred"])
        if pd.get("z_pred") is not None:
            zps[j] = np.asarray(pd["z_pred"], dtype=np.float64)
        seen = codes < block_sizes[j]
        cols[j, seen] = level_off[j] + codes[seen]
        prior = prior + np.where(seen, 0.0, variances[j] * zps[j] ** 2)
    return cols, zps, prior


def zsz_diag(S, cols, zps):
    """diag(Z_pred S Z_pred') from `pred_incidence`'s cols and zp, for S
    a (q, q) numpy array or tensor and cols, zp of the same kind."""
    out = 0.0
    for j in range(len(cols)):
        for k in range(len(cols)):
            seen = (cols[j] >= 0) & (cols[k] >= 0)
            sjk = S[cols[j].clip(0), cols[k].clip(0)] if isinstance(
                cols, np.ndarray) else S[cols[j].clamp_min(0),
                                         cols[k].clamp_min(0)]
            out = out + zps[j] * zps[k] * sjk * seen
    return out


class SegmentSum:
    """out[g] = sum of v[r] over the rows r with codes[r] == g, for g < q,
    without atomics: rows sorted by code once; level 1 sums chunks of up to
    W1 = ceil(sqrt(max count)) consecutive rows of one group, level 2 sums
    each group's chunks. Both are gathers into zero-padded matrices and a
    row sum, so the order of every sum is fixed."""

    def __init__(self, codes, q, device):
        codes = np.asarray(codes, dtype=np.int64)
        n = len(codes)
        order = np.argsort(codes, kind="stable")
        counts = np.bincount(codes, minlength=q)
        w1 = max(1, int(math.ceil(math.sqrt(max(int(counts.max(initial=0)),
                                                 1)))))
        nchunk = -(-counts // w1)
        chunk_start = np.concatenate([[0], np.cumsum(nchunk)])
        group_start = np.concatenate([[0], np.cumsum(counts)])
        sorted_codes = codes[order]
        pos = np.arange(n) - group_start[sorted_codes]
        idx1 = np.full((int(chunk_start[-1]), w1), n, dtype=np.int64)
        idx1[chunk_start[sorted_codes] + pos // w1, pos % w1] = order
        w2 = max(1, int(nchunk.max(initial=0)))
        idx2 = np.full((q, w2), int(chunk_start[-1]), dtype=np.int64)
        g_of_chunk = np.repeat(np.arange(q), nchunk)
        k_of_chunk = np.arange(int(chunk_start[-1])) - chunk_start[g_of_chunk]
        idx2[g_of_chunk, k_of_chunk] = np.arange(int(chunk_start[-1]))
        self._idx1 = torch.as_tensor(idx1, device=device)
        self._idx2 = torch.as_tensor(idx2, device=device)

    def __call__(self, v):
        pad = v.new_zeros((1,) + tuple(v.shape[1:]))
        s1 = torch.cat([v, pad])[self._idx1].sum(1)
        return torch.cat([s1, pad])[self._idx2].sum(1)


class WoodburyGaussianEngine(GaussianEngineBase):
    """Marginal NLL, gradients, Fisher information and prediction for
    models with grouped random effects only. Tensor arguments named y, X,
    resid or M are device tensors in data order."""

    def __init__(self, components, num_data, dtype=torch.float64,
                 matrix_inversion_method="cholesky", *, device,
                 weights=None, num_rand_vec_trace=200, seed_rand_vec_trace=1,
                 cg_max_num_it=1000):
        self.weights = None if weights is None \
            else np.asarray(weights, dtype=np.float64)
        self.components = list(components)
        if not all(c.kind == "grouped" for c in self.components):
            raise ValueError("the Woodbury engine takes grouped random "
                             "effects only")
        self.n = int(num_data)
        self.dtype = dtype
        self.device = torch.device(device)
        self.matrix_inversion_method = matrix_inversion_method
        self.num_theta = len(self.components)
        self.num_cov_par = self.num_theta + 1
        self.par_offsets = list(range(self.num_theta))

        # flat level indexing: component j holds [level_off[j], level_off[j+1])
        self.block_sizes = [c.num_groups for c in self.components]
        self.level_off = np.concatenate([[0], np.cumsum(self.block_sizes)])
        self.q = int(self.level_off[-1])
        self._idx = np.stack([c.group_codes.astype(np.int64)
                              + self.level_off[j]
                              for j, c in enumerate(self.components)])
        self._w = np.stack([np.ones(self.n) if c.z is None else c.z
                            for c in self.components])
        # Z'WZ, each entry summed over the rows in row order
        q = self.q
        wvec = np.ones(self.n) if self.weights is None else self.weights
        G = np.zeros(q * q)
        for j in range(self.num_theta):
            for k in range(self.num_theta):
                G += np.bincount(self._idx[j] * q + self._idx[k],
                                 weights=wvec * self._w[j] * self._w[k],
                                 minlength=q * q)
        self._logdet_R = float(-np.sum(np.log(wvec)))      # log|diag(1/w)|
        dev = self.device
        self._G = torch.as_tensor(G.reshape(q, q), device=dev).to(dtype)
        block_id = np.repeat(np.arange(self.num_theta), self.block_sizes)
        oneh = np.zeros((q, self.num_theta))
        oneh[np.arange(q), block_id] = 1.0
        self._oneh = torch.as_tensor(oneh, device=dev).to(dtype)
        self._m_sizes = self._t(np.asarray(self.block_sizes, dtype=float))
        self._idx_d = torch.as_tensor(self._idx, device=dev)
        self._w_d = [None if c.z is None else self._t(c.z)
                     for c in self.components]
        self._wvec_d = None if self.weights is None else self._t(self.weights)
        self._seg = [SegmentSum(c.group_codes, c.num_groups, dev)
                     for c in self.components]
        self._y_cache = (None, None)
        self._X_cache = (None, None)
        self._iter_fns = None
        self.num_rand_vec_trace = int(num_rand_vec_trace)
        self.seed_rand_vec_trace = int(seed_rand_vec_trace)
        self.cg_max_num_it = int(cg_max_num_it)

    def set_iterative_params(self, **kw):
        """The iterative branch's settings: num_rand_vec_trace,
        seed_rand_vec_trace and cg_max_num_it (the other CG keys do not
        apply here)."""
        for k in ("num_rand_vec_trace", "seed_rand_vec_trace",
                  "cg_max_num_it"):
            if k in kw:
                setattr(self, k, int(kw[k]))
        self._iter_fns = None

    def _a_matvec(self, theta_log, v):
        """A v = Z'Z v + Sigma^-1 v for v (q,) or columns (q, k)."""
        d = self._oneh @ (1.0 / torch.exp(theta_log))
        return self._G @ v + (d if v.ndim == 1 else d[:, None]) * v

    def _iterative(self):
        """(CG solve, SLQ log|A|) of the iterative branch."""
        if self._iter_fns is None:
            self._iter_fns = (
                make_cg_solve(self._a_matvec, tol=1e-8,
                              maxit=self.cg_max_num_it),
                make_slq_logdet(self._a_matvec, self.q,
                                rank=min(self.q, 100),
                                num_probes=self.num_rand_vec_trace,
                                seed=self.seed_rand_vec_trace,
                                dtype=self.dtype, device=self.device))
        return self._iter_fns

    # ------------------------------------------------------------------
    # device-side sufficient statistics
    def _weigh(self, v):
        """W v for v (n,) or (n, L) (v itself without weights)."""
        if self._wvec_d is None:
            return v
        return self._wvec_d * v if v.ndim == 1 else self._wvec_d[:, None] * v

    def _zt(self, v):
        """Z'W v for v (n,) or (n, L) on the device: (q,) or (q, L)."""
        v = self._weigh(v)
        parts = []
        for w, seg in zip(self._w_d, self._seg):
            wv = v if w is None else (w * v if v.ndim == 1
                                      else w[:, None] * v)
            parts.append(seg(wv))
        return torch.cat(parts)

    def _stats_y(self, y):
        """(Z'Wy, y'Wy), cached for the last y tensor."""
        ref, val = self._y_cache
        if ref is y:
            return val
        val = (self._zt(y), y @ self._weigh(y))
        self._y_cache = (y, val)
        return val

    def _stats_X(self, X):
        """(Z'WX, X'WX), cached for the last X tensor."""
        ref, val = self._X_cache
        if ref is X:
            return val
        val = (self._zt(X), X.T @ self._weigh(X))
        self._X_cache = (X, val)
        return val

    # ------------------------------------------------------------------
    def _A(self, theta_log):
        return self._G + torch.diag(self._oneh @ (1.0 / torch.exp(theta_log)))

    def _cho_solve(self, L, b):
        if b.ndim == 1:
            return torch.cholesky_solve(b[:, None], L)[:, 0]
        return torch.cholesky_solve(b, L)

    def _core(self, theta_log, y):
        Zty, yty = self._stats_y(y)
        if self.matrix_inversion_method == "iterative":
            solve, logdet_A = self._iterative()
            quad = yty - Zty @ solve(theta_log, Zty)
            return quad, logdet_A(theta_log) + torch.sum(
                self._m_sizes * theta_log) + self._logdet_R
        L = chol(self._A(theta_log))
        quad = yty - Zty @ self._cho_solve(L, Zty)
        logdet = (2.0 * torch.sum(torch.log(torch.diagonal(L)))
                  + torch.sum(self._m_sizes * theta_log) + self._logdet_R)
        return quad, logdet

    def _nll_parts(self, theta_log, sigma2, y):
        quad, logdet = self._core(theta_log, y)
        n = self.n
        nll = 0.5 * (quad / sigma2 + logdet + n * torch.log(sigma2)
                     + n * math.log(2.0 * math.pi))
        return nll, quad

    def _nll_profiled(self, theta_log, y):
        quad, logdet = self._core(theta_log, y)
        n = self.n
        return 0.5 * (logdet + n * torch.log(quad / n) + n
                      + n * math.log(2.0 * math.pi)), quad

    def _wls(self, theta_log, y, X):
        """GLS coefficients in q-space: (X'P X) beta = X'P y with
        X'P X = X'WX - (Z'WX)' A^-1 (Z'WX)."""
        ZtX, XtX = self._stats_X(X)
        Zty, _ = self._stats_y(y)
        L = chol(self._A(theta_log))
        AinvZtX = self._cho_solve(L, ZtX)
        XtPX = XtX - ZtX.T @ AinvZtX
        XtPy = X.T @ self._weigh(y) - AinvZtX.T @ Zty
        return self._cho_solve(chol(XtPX), XtPy)

    def _coef_grad(self, theta_log, sigma2, resid, X):
        ZtX, _ = self._stats_X(X)
        L = chol(self._A(theta_log))
        AinvZtr = self._cho_solve(L, self._zt(resid))
        return -(X.T @ self._weigh(resid) - ZtX.T @ AinvZtr) / sigma2

    # ------------------------------------------------------------------
    def _blocks(self, M):
        """Per-(component j, component k) block sums of a (q, q) matrix."""
        return self._oneh.T @ M @ self._oneh

    def fisher_transformed(self, u, include_error_var=True):
        """Fisher information on the transformed (log) scale by q x q trace
        identities; with P = Psi~^-1 and C = Z'PZ:
        tr(P dPsi_j) = v_j sum(diag(C)[block j]),
        tr(P dPsi_j P dPsi_k) = v_j v_k ||C[b_j, b_k]||_F^2."""
        with torch.no_grad():
            theta_log = self._t(u)[1:]
            vt = torch.exp(theta_log)
            L = chol(self._A(theta_log))
            C = self._G - self._G @ self._cho_solve(L, self._G)
            tr = vt * (self._oneh.T @ torch.diagonal(C))
            FI_cc = 0.5 * (vt[:, None] * vt[None, :]) * self._blocks(C * C)
            if not include_error_var:
                return self._host(FI_cc)[0]
            p = self.num_theta
            FI = FI_cc.new_zeros((p + 1, p + 1))
            FI[0, 0] = self.n / 2.0
            FI[0, 1:] = 0.5 * tr
            FI[1:, 0] = 0.5 * tr
            FI[1:, 1:] = FI_cc
            return self._host(FI)[0]

    def fisher_original(self, pars_orig):
        """Fisher information wrt the original [sigma2, v_j], in q-space."""
        with torch.no_grad():
            pars = self._t(pars_orig)
            sigma2 = pars[0]
            theta_log = torch.log(pars[1:] / sigma2)
            L = chol(self._A(theta_log))
            G = self._G
            AinvG = self._cho_solve(L, G)
            C = G - G @ AinvG
            C2 = G - 2.0 * G @ AinvG + AinvG.T @ (G @ AinvG)
            tr_psi2 = (self.n - 2.0 * torch.trace(AinvG)
                       + torch.sum(AinvG * AinvG.T))
            diag_C2 = self._oneh.T @ torch.diagonal(C2)
            p = self.num_theta
            FI = G.new_zeros((p + 1, p + 1))
            FI[0, 0] = tr_psi2
            FI[0, 1:] = diag_C2
            FI[1:, 0] = diag_C2
            FI[1:, 1:] = self._blocks(C * C)
            return self._host(0.5 * FI / (sigma2 * sigma2))[0]

    # ------------------------------------------------------------------
    def _posterior(self, pars_orig, y_resid):
        """(Cholesky factor of A, posterior mean A^-1 Z' resid) on the
        device."""
        t = self.transform_pars(pars_orig)
        L = chol(self._A(self._t(np.log(t[1:]))))
        r = self.prep_y(y_resid)
        return L, self._cho_solve(L, self._zt(r))

    def training_re(self, pars_orig, y_resid, predict_var=False):
        """Per-component posterior means (and variances) of the random
        effects at the training points: column j = bhat_j[codes_j], with
        bhat = A^-1 Z' resid and Var(b | y) = sigma2 A^-1
        (re_model_template.h:4420; random coefficients report the latent
        slope)."""
        with torch.no_grad():
            L, bhat = self._posterior(pars_orig, y_resid)
            means = bhat[self._idx_d].T
            if not predict_var:
                return self._host(means)[0], None
            sigma2 = float(pars_orig[0])
            Ainv_diag = torch.diagonal(torch.cholesky_inverse(L))
            return tuple(self._host(means,
                                    sigma2 * Ainv_diag[self._idx_d].T))

    def predict(self, pars_orig, y_resid, pred_data, predict_var=False,
                predict_cov_mat=False, predict_response=False):
        """Posterior mean and covariance at prediction incidences;
        pred_data["comps"][j] holds "codes_pred" (codes >= m_j are unseen
        levels) and an optional "z_pred". Without predict_cov_mat the mean
        and the variances are gathers from A^-1 Z' resid and A^-1
        (`pred_incidence`), with no (n_pred, q) or (n_pred, n_pred)
        matrix."""
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        sigma2 = pars_orig[0]
        n_pred = pred_data["n_pred"]
        if not predict_cov_mat:
            cols, zps, prior = pred_incidence(
                pred_data, self.block_sizes, self.level_off, pars_orig[1:])
            with torch.no_grad():
                L, bhat = self._posterior(pars_orig, y_resid)
                up = torch.as_tensor(np.concatenate([cols, zps, prior[None]]),
                                     device=self.device)
                J = len(cols)
                cols_d, zps_d = up[:J].long(), up[J:2 * J].to(self.dtype)
                mu = sum(torch.where(cols_d[j] >= 0, zps_d[j]
                                     * bhat[cols_d[j].clamp_min(0)], 0.0)
                         for j in range(J))
                if not predict_var:
                    return {"mu": self._host(mu)[0]}
                var = sigma2 * zsz_diag(torch.cholesky_inverse(L), cols_d,
                                        zps_d) + up[-1].to(self.dtype)
                if predict_response:
                    var = var + sigma2
                mu, var = self._host(mu, var)
            return {"mu": mu, "var": var}
        Zp = np.zeros((n_pred, self.q))
        prior_var = np.zeros((n_pred, n_pred))
        for j, pd in enumerate(pred_data["comps"]):
            codes = pd["codes_pred"]
            zp = pd.get("z_pred")
            zp = np.ones(n_pred) if zp is None \
                else np.asarray(zp, dtype=np.float64)
            rows = np.where(codes < self.block_sizes[j])[0]
            Zp[rows, self.level_off[j] + codes[rows]] += zp[rows]
            # unseen levels: prior variance v_j, shared among equal codes
            un = np.where(codes >= self.block_sizes[j])[0]
            if len(un):
                same = codes[un][:, None] == codes[un][None, :]
                prior_var[np.ix_(un, un)] += pars_orig[1 + j] * same * \
                    np.outer(zp[un], zp[un])
        with torch.no_grad():
            L, bhat = self._posterior(pars_orig, y_resid)
            Zp_d = self._t(Zp)
            out = {"mu": self._host(Zp_d @ bhat)[0]}
            cov = sigma2 * (Zp_d @ self._cho_solve(L, Zp_d.T)) \
                + self._t(prior_var)
            if predict_response:
                cov = cov + sigma2 * torch.eye(
                    n_pred, dtype=cov.dtype, device=cov.device)
            cov = self._host(cov)[0]
            out["cov"] = cov
            if predict_var:
                out["var"] = np.diagonal(cov).copy()
        return out

    def psi_tilde_inv_mat(self, pars_internal, M):
        """Psi~^-1 M for M (n, L) on the device: W M - W Z A^-1 Z'W M
        (gbdt.py:2405-2419 Woodbury branch)."""
        theta_log = self._t(np.log(np.asarray(pars_internal)[1:]))
        with torch.no_grad():
            Mt = M.to(self.dtype)
            w = self._cho_solve(chol(self._A(theta_log)), self._zt(Mt))
            out = self._weigh(Mt)
            for j, wz in enumerate(self._w_d):
                g = w[self._idx_d[j]]
                if wz is not None:
                    g = wz[:, None] * g
                out = out - self._weigh(g)
        return out.to(M.dtype)
