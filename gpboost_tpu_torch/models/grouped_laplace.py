"""Laplace engine on the random-effects scale for models whose random effects
are all grouped (counterpart of gpboost_tpu/models/grouped_laplace.py;
reference likelihoods.h:2959 FindModePostRandEffCalcMLLGroupedRE, :3223
...OnlyOneGroupedRECalculationsOnREScale, :4469/:5069 the gradients,
:7253ff the grouped predictions).

The latent vector is b in R^q (q levels over all components) with prior
N(0, Sigma_b), Sigma_b = blockdiag(v_j I_{m_j}), and design Zb (an indicator
per row and component, times the covariate for a random slope):

    nll = 0.5 b' Sigma_b^-1 b - loglik(y, Zb + F)
          + 0.5 log|I_q + Sigma_b Z'WZ|,
    mode: H db = Z'd1 - Sigma_b^-1 b,  H = Sigma_b^-1 + Z'WZ  (q x q).

Two mode finders, chosen as the reference chooses (one grouping, no tkc,
and q * s_max <= 4 n with s_max the largest group), but for two predictor
sets, which the reference sends to the rows finder and which take the
padded one here too (the same mode, summed in another order):

  * padded by group: the rows regrouped once into a (q, s_max) layout, so
    every Newton step is dense masked row reductions with a diagonal H;
  * rows: Zb by gathers, Z'v and Z'WZ by deterministic segment sums
    (`SegmentSum` of models/grouped_re.py: rows sorted by level once, padded
    gathers and row sums, no atomics), with a q x q Cholesky of H when
    there is more than one component (its off-diagonal blocks summed over
    the occupied (level, level) pairs, which are sorted once on the host).

Both run Newton with Armijo backtracking as the dense engine does: one
batched pass over the 20 step lengths and one host read per Newton step.
The gradients come from the implicit-function `autograd.Function` of
models/laplace.py. Observation weights multiply the log-likelihood.
"""

import numpy as np
import torch

from .gaussian_base import chol
from .grouped_re import SegmentSum, pred_incidence, zsz_diag
from .laplace import MAXIT_MODE_NEWTON, LaplaceEngineBase


class GroupedRELaplaceEngine(LaplaceEngineBase):
    """Laplace-approximated NLL, gradients and prediction on the RE
    scale."""

    # the device L-BFGS is auto-enabled for this engine from n = 20,000
    device_opt_auto = True

    def __init__(self, components, num_data, likelihood, cluster_ids=None,
                 dtype=torch.float64, weights=None, *, device):
        self.components = list(components)
        assert all(c.kind == "grouped" for c in self.components)
        if cluster_ids is not None:
            # independence across clusters == each grouping refined by the
            # cluster id (re_model_template.h:6775 SetUpClusterIds)
            for comp in self.components:
                comp.refine_by_cluster(np.asarray(cluster_ids))
        self._init_common(likelihood, num_data, dtype, device, weights)
        self.num_theta = len(self.components)
        self.num_cov_par = self.num_theta
        self.par_offsets = list(range(self.num_theta))
        self.num_par = self.num_theta + self.num_aux
        self.block_sizes = [c.num_groups for c in self.components]
        self.level_off = np.concatenate([[0], np.cumsum(self.block_sizes)])
        self.q = int(self.level_off[-1])
        self.dim_mode = self.q
        self.diag_path = self.num_theta == 1
        dev = self.device

        n, q = self.n, self.q
        self._idx_np = np.stack([c.group_codes.astype(np.int64)
                                 + self.level_off[j]
                                 for j, c in enumerate(self.components)])
        self._w_np = np.stack([np.ones(n) if c.z is None
                               else np.asarray(c.z, dtype=np.float64)
                               for c in self.components])
        self._idx = torch.as_tensor(self._idx_np, device=dev)
        self._wmat = self._t(self._w_np)
        self._seg = [SegmentSum(c.group_codes, c.num_groups, dev)
                     for c in self.components]
        # off-diagonal blocks of Z'WZ: one segment per occupied
        # (level_j, level_k) pair, j < k
        self._pairs = []
        if not self.diag_path:
            for j in range(self.num_theta):
                for k in range(j + 1, self.num_theta):
                    key = self._idx_np[j] * q + self._idx_np[k]
                    uniq, code = np.unique(key, return_inverse=True)
                    self._pairs.append((
                        j, k, SegmentSum(code, len(uniq), dev),
                        torch.as_tensor(uniq // q, device=dev),
                        torch.as_tensor(uniq % q, device=dev)))
        block_id = np.repeat(np.arange(self.num_theta), self.block_sizes)
        oneh = np.zeros((q, self.num_theta))
        oneh[np.arange(q), block_id] = 1.0
        self._oneh = self._t(oneh)
        self._m_sizes = self._t(np.asarray(self.block_sizes, dtype=float))

        # the padded-by-group layout (one grouping, at most 4x the cells;
        # not for the tkc curvature, whose search shifts the rows layout's
        # location)
        self._padded = None
        if self.diag_path and likelihood.approx_type != "tkc":
            codes = self._idx_np[0]
            counts = np.bincount(codes, minlength=q)
            s_max = int(counts.max()) if len(counts) else 0
            if s_max > 0 and q * s_max <= 4 * n:
                order = np.argsort(codes, kind="stable")
                start = np.concatenate([[0], np.cumsum(counts)])
                pos = np.arange(n) - start[codes[order]]
                pad_idx = np.zeros((q, s_max), dtype=np.int64)
                pad_mask = np.zeros((q, s_max))
                pad_idx[codes[order], pos] = order
                pad_mask[codes[order], pos] = 1.0
                self._padded = {"idx": torch.as_tensor(pad_idx, device=dev),
                                "mask": self._t(pad_mask), "s_max": s_max}
                w_pad = self._t(self._w_np[0][pad_idx] * pad_mask)
                wo = self.weights
                self._padded["w"] = w_pad
                self._padded["wll"] = self._padded["mask"] if wo is None \
                    else wo[self._padded["idx"]] * self._padded["mask"]

    # ------------------------------------------------------------------
    # Z operators
    def _Zb(self, b):
        """Z b for b (q,) or a batch (k, q)."""
        out = None
        for j in range(self.num_theta):
            g = b[..., self._idx[j]] * self._wmat[j]
            out = g if out is None else out + g
        return out

    def _Zt(self, v):
        return torch.cat([seg(self._wmat[j] * v)
                          for j, seg in enumerate(self._seg)])

    def _ZtWZ_diag(self, W):
        """The diagonal of Z'WZ (all of it on the diagonal path)."""
        return torch.cat([seg(self._wmat[j] * self._wmat[j] * W)
                          for j, seg in enumerate(self._seg)])

    def _H(self, theta_log, W):
        """H = Sigma_b^-1 + Z'WZ, dense q x q."""
        H = torch.diag(self._sbinv(theta_log) + self._ZtWZ_diag(W))
        for j, k, seg, r, c in self._pairs:
            vals = seg(self._wmat[j] * self._wmat[k] * W)
            H = H.index_put((r, c), vals).index_put((c, r), vals)
        return H

    def _sbinv(self, theta_log):
        return self._oneh @ torch.exp(-theta_log)

    def _split_u(self, u):
        nt = self.num_theta
        return u[:nt], torch.exp(u[nt:])

    def _half_logdet(self, theta_log, W):
        """0.5 log|I + Sigma_b Z'WZ| (differentiable, no sqrt(W))."""
        if self.diag_path:
            h = self._sbinv(theta_log) + self._ZtWZ_diag(W)
            return 0.5 * (torch.sum(torch.log(h))
                          + torch.sum(self._m_sizes * theta_log))
        L = chol(self._H(theta_log, W))
        return (torch.sum(torch.log(torch.diagonal(L)))
                + 0.5 * torch.sum(self._m_sizes * theta_log))

    # ------------------------------------------------------------------
    # mode finding
    def _mode_solve(self, u, F, y, b_init):
        with torch.no_grad():
            theta_log, aux = self._split_u(u)
            if self._padded is not None:
                return self._mode_solve_padded(theta_log, aux, y, F, b_init)
            return self._mode_solve_rows(theta_log, aux, y, F, b_init)

    def _pad_parts(self, F, y):
        """(y, F, the slope weights and the likelihood weights) in the
        (q, s_max) layout; with two predictor sets F_pad is (q, 2 s_max),
        each block padded on its own."""
        P = self._padded
        idx, mask = P["idx"], P["mask"]
        F_pad = F[idx] * mask if self.num_sets_fe == 1 else torch.cat(
            [F[:self.n][idx] * mask, F[self.n:][idx] * mask], -1)
        return y[idx], F_pad, P["w"], P["wll"]

    def _pad_loc(self, b, F_pad, w_pad):
        """The padded location for b (q,) or a batch (k, q), both blocks
        for two predictor sets (see LaplaceEngineBase._loc)."""
        x = w_pad * b[..., None]
        if self.num_sets_fe == 1:
            return x + F_pad
        s = w_pad.shape[-1]
        F2 = F_pad[:, s:]
        return torch.cat([x + F_pad[:, :s], F2.expand(x.shape)], -1)

    def _mode_solve_padded(self, theta_log, aux, y, F, b):
        y_pad, F_pad, w_pad, wll = self._pad_parts(F, y)
        sbinv = self._sbinv(theta_log)
        lrs = self._lrs[:, None]

        def obj_of(bb):
            loc = self._pad_loc(bb, F_pad, w_pad)
            return -0.5 * torch.sum(sbinv * bb * bb, -1) \
                + self._loglik(y_pad, loc, aux, wll).sum(-1)

        obj = obj_of(b)
        it = 0
        while it < MAXIT_MODE_NEWTON:
            loc = self._pad_loc(b, F_pad, w_pad)
            d1, W = self._d1_W(y_pad, loc, aux, self._fisher_mode, False,
                               w=wll)
            grad = torch.sum(w_pad * d1, 1) - sbinv * b
            h = sbinv + torch.sum(w_pad * w_pad * W, 1)
            delta = grad / torch.clamp(torch.abs(h), min=1e-10)
            gdd = grad @ delta
            b_k = b + lrs * delta
            obj_k = obj_of(b_k)
            k = self._armijo(obj_k, obj, gdd)
            b_new, obj_new = self._pick(k, b_k, obj_k)
            done = self._newton_done(obj_new, obj, it)
            b, obj = b_new, obj_new
            it += 1
            if done:
                break
        return b, it

    def _mode_solve_rows(self, theta_log, aux, y, F, b):
        sbinv = self._sbinv(theta_log)
        lrs = self._lrs[:, None]

        def obj_of(bb):
            return -0.5 * torch.sum(sbinv * bb * bb, -1) \
                + self._loglik(y, self._loc(self._Zb(bb), F), aux)

        obj = obj_of(b)
        it = 0
        while it < MAXIT_MODE_NEWTON:
            d1, W = self._d1_W(y, self._loc(self._Zb(b), F), aux,
                               self._fisher_mode, False)
            grad = self._Zt(d1) - sbinv * b
            if self.diag_path:
                # |h| keeps the step ascent-aligned where an observed W
                # makes a level's curvature non-positive
                h = sbinv + self._ZtWZ_diag(W)
                delta = grad / torch.clamp(torch.abs(h), min=1e-10)
            else:
                L = chol(self._H(theta_log, W))
                delta = torch.cholesky_solve(grad[:, None], L)[:, 0]
                # an indefinite H (NaN factor) or a non-ascent step: take
                # the gradient
                bad = ~torch.all(torch.isfinite(delta)) | (grad @ delta <= 0)
                delta = torch.where(bad, grad, delta)
            gdd = grad @ delta
            b_k = b + lrs * delta
            obj_k = obj_of(b_k)
            k = self._armijo(obj_k, obj, gdd)
            b_new, obj_new = self._pick(k, b_k, obj_k)
            done = self._newton_done(obj_new, obj, it)
            b, obj = b_new, obj_new
            it += 1
            if done:
                break
        return b, it

    # ------------------------------------------------------------------
    # objective and residual at a fixed mode
    def _g(self, u, F, b, y, create_graph, value=True):
        theta_log, aux = self._split_u(u)
        sbinv = self._sbinv(theta_log)
        quad = 0.5 * torch.sum(sbinv * b * b)
        if self._padded is not None:
            y_pad, F_pad, w_pad, wll = self._pad_parts(F, y)
            loc = self._pad_loc(b, F_pad, w_pad)
            _, W = self._d1_W(y_pad, loc, aux, self._fisher_det,
                              create_graph, w=wll)
            h = sbinv + torch.sum(w_pad * w_pad * W, 1)
            half_logdet = 0.5 * (torch.sum(torch.log(h))
                                 + torch.sum(self._m_sizes * theta_log))
            return quad - self._loglik(y_pad, loc, aux, wll).sum(-1) \
                + half_logdet
        loc = self._loc(self._Zb(b), F)
        _, W = self._d1_W(y, loc, aux, self._fisher_det, create_graph)
        return quad - self._loglik(y, loc, aux) \
            + self._half_logdet(theta_log, W)

    def _r(self, u, F, b, y):
        theta_log, aux = self._split_u(u)
        if self._padded is not None:
            y_pad, F_pad, w_pad, wll = self._pad_parts(F, y)
            loc = self._pad_loc(b, F_pad, w_pad)
            d1 = self._d1(y_pad, loc, aux, w=wll)
            return self._sbinv(theta_log) * b - torch.sum(w_pad * d1, 1)
        return self._sbinv(theta_log) * b \
            - self._Zt(self._d1(y, self._loc(self._Zb(b), F), aux))

    def _W_at(self, u, F, b, y):
        """The determinant curvature W at the mode, data order."""
        theta_log, aux = self._split_u(u)
        return self._d1_W(y, self._loc(self._Zb(b), F), aux,
                          self._fisher_det, False)[1]

    def _adjoint_solve(self, u, F, b, y, g_b):
        with torch.no_grad():
            theta_log, _ = self._split_u(u)
            W = self._W_at(u, F, b, y)
            if self.diag_path:
                return g_b / (self._sbinv(theta_log) + self._ZtWZ_diag(W))
            L = chol(self._H(theta_log, W))
            return torch.cholesky_solve(g_b[:, None], L)[:, 0]

    # ------------------------------------------------------------------
    # grouped components are variance-only, no nugget: identity transforms
    def transform_pars(self, pars_orig):
        return np.asarray(pars_orig, dtype=np.float64).copy()

    def back_transform_pars(self, pars_internal):
        return np.asarray(pars_internal, dtype=np.float64).copy()

    def training_re(self, u, a_state, predict_var=False):
        """Posterior (Laplace) means of the random effects at the training
        points: column j = b_hat[codes_j] (re_model_template.h:4420; a
        random slope reports the latent slope)."""
        if predict_var:
            raise ValueError("predict_training_data_random_effects with "
                             "predict_var=True is not implemented for "
                             "non-Gaussian likelihoods; use predict()")
        b = self._host(a_state)[0]
        return np.column_stack([b[self._idx_np[j]]
                                for j in range(self.num_theta)]), None

    def predict(self, pars_orig, aux_pars, y, F, pred_data, a_init=None,
                predict_var=False, predict_cov_mat=False,
                predict_response=False, F_pred=None):
        """Laplace predictions on the RE scale: the posterior of b is
        N(b_hat, H^-1); a level not seen in training has latent mean 0 and
        the prior variance (likelihoods.h:7253ff, grouped variants). The
        mode and W come from the device; the q-sized algebra runs on the
        host in float64, as in the reference."""
        import scipy.linalg as sla
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        u = self._u_from_pars(pars_orig, aux_pars, y)
        with torch.no_grad():
            ud = self._t(u)
            aux_d = torch.exp(ud[self.num_theta:])
            yd, Fd = self.prep_y(y), self._F(F)
            if a_init is None:
                a_init = self.zero_mode()
            b_hat, nit = self._mode_solve(ud, Fd, yd, a_init)
            self._note_it(nit)
            b_np, W_np = self._host(b_hat, self._W_at(ud, Fd, b_hat, yd))
        sbinv = np.concatenate([np.full(m, 1.0 / pars_orig[j])
                                for j, m in enumerate(self.block_sizes)])
        # predictive-variance correction of the information
        # (CalcInformationLogLik, likelihoods.h:12736-12786); the reference's
        # "learning_rate" version multiplies W by a likelihood learning rate
        # that it never sets, so by 1
        var_cor = getattr(self.likelihood, "var_correction", None)
        fi_np = None
        if var_cor == "freq_asymptotic":
            if self.likelihood.name != "asymmetric_laplace":
                raise ValueError(
                    "var_cor_pred_version 'freq_asymptotic' is not "
                    "implemented for this likelihood")
            qq = self.likelihood.q
            sigma = float(np.exp(u[self.num_theta]))
            fi_np = np.full(self.n, qq * (1.0 - qq) / (sigma * sigma))
        wz = self._w_np * W_np[None, :]
        if self.diag_path:
            zt_w = np.bincount(self._idx_np.reshape(-1),
                               weights=(self._w_np * wz).reshape(-1),
                               minlength=self.q)
            if fi_np is not None:
                zt_fi = np.bincount(
                    self._idx_np.reshape(-1),
                    weights=np.broadcast_to(
                        fi_np, self._idx_np.shape).reshape(-1).copy(),
                    minlength=self.q)
                zt_w = zt_w * zt_w / np.maximum(zt_fi, 1e-300)
            h_diag = sbinv + zt_w

            def h_solve(rhs):
                return rhs / (h_diag[:, None] if rhs.ndim == 2 else h_diag)
        else:
            if fi_np is not None:
                W_np = W_np * W_np / fi_np
                wz = self._w_np * W_np[None, :]
            H = np.diag(sbinv)
            for j in range(self.num_theta):
                for k in range(self.num_theta):
                    np.add.at(H, (self._idx_np[j], self._idx_np[k]),
                              self._w_np[j] * wz[k])
            cho = sla.cho_factor(H, lower=True)

            def h_solve(rhs):
                return sla.cho_solve(cho, rhs)

        cov = var = None
        if predict_cov_mat:
            n_pred = pred_data["n_pred"]
            Zp = np.zeros((n_pred, self.q))
            prior_var = np.zeros((n_pred, n_pred))
            for j, pd in enumerate(pred_data["comps"]):
                codes = pd["codes_pred"]
                zp = pd.get("z_pred")
                zp = np.ones(n_pred) if zp is None \
                    else np.asarray(zp, dtype=np.float64)
                seen = codes < self.block_sizes[j]
                rows = np.where(seen)[0]
                Zp[rows, self.level_off[j] + codes[rows]] += zp[rows]
                un = np.where(~seen)[0]
                if len(un):
                    same = codes[un][:, None] == codes[un][None, :]
                    prior_var[np.ix_(un, un)] += pars_orig[j] * same * \
                        np.outer(zp[un], zp[un])
            mu = Zp @ b_np
            cov = Zp @ h_solve(Zp.T) + prior_var
            var = np.diagonal(cov).copy()
        else:
            # the mean and the variances as gathers from b_hat and H^-1,
            # with no (n_pred, q) matrix
            cols, zps, prior = pred_incidence(
                pred_data, self.block_sizes, self.level_off, pars_orig)
            mu = sum(np.where(cols[j] >= 0, zps[j] * b_np[cols[j].clip(0)],
                              0.0) for j in range(len(cols)))
            if predict_var or predict_response:
                if self.diag_path:
                    # H is diagonal and the components' columns disjoint
                    var = prior + sum(
                        np.where(cols[j] >= 0, zps[j] ** 2
                                 / h_diag[cols[j].clip(0)], 0.0)
                        for j in range(len(cols)))
                else:
                    var = zsz_diag(h_solve(np.eye(self.q)), cols, zps) \
                        + prior
        # the two predictor blocks and the response on the host, as mu
        mu_tot, zeta = self._split_pred(torch.as_tensor(mu), F_pred)
        out = {}
        if predict_response:
            m, v = self._response(mu_tot, torch.as_tensor(var), zeta,
                                  aux_d.cpu().to(torch.float64))
            out["mu"] = m.numpy()
            if predict_var or predict_cov_mat:
                out["var"] = v.numpy()
        else:
            out["mu"] = mu_tot.numpy()
            if predict_cov_mat:
                out["cov"] = cov
            if predict_var:
                out["var"] = var
        return out
