"""Laplace approximation for non-Gaussian likelihoods: what the engines share
and the dense engine (counterpart of gpboost_tpu/models/laplace.py;
reference likelihoods.h:2808 FindModePostRandEffCalcMLLStable, :4230
CalcGradNegMargLikelihoodLaplaceApproxStable, :7253 PredictLaplaceApprox*,
:9581 PredictResponse).

Approximate negative marginal log-likelihood of the dense engine, with the
mode parameterised as b = Sigma a (Rasmussen & Williams' stable form):

    nll(theta, aux) = 0.5 a' Sigma a - loglik(Sigma a + F)
                      + sum log diag chol(I + sqrt(W) Sigma sqrt(W)),
    a solves a = d1(Sigma a + F).

Mode finding is Newton with Armijo backtracking (c = 1e-4, at most 20
halvings, relative change 1e-8; likelihoods.h:17261-17277), warm-started
from the previous mode. The reference runs it as nested lax.while_loops on
the device. Here it is a host loop over device tensors with ONE host read
per Newton step: the objectives of all 20 step lengths 1, 1/2, ...,
2^-19 are evaluated in one batched pass, and the first one that satisfies
the Armijo condition is taken, which is the sequential loop's choice (or
the last one, as there, when none does).

Gradients wrt the covariance and auxiliary parameters u and the fixed
effects F come from one implicit-function-theorem `torch.autograd.Function`
around the solved mode (the reference's custom_vjp): `forward` runs the mode
finder without a graph; `backward` differentiates the objective g at the
fixed mode, where W depends on the mode through the log-determinant (so
third derivatives of the log-likelihood enter, by autograd with
create_graph), solves the adjoint system with the mode's curvature and
subtracts the vector-Jacobian product of the mode residual r.

The W+/W- split-Cholesky path of the reference (for curvatures that can be
negative or zero), two predictor sets (num_sets_fe = 2) and two random-effect
sets (num_sets_re = 2) serve only likelihoods of likelihoods/families.py,
which `get_likelihood` refuses. The dense engine takes cluster_ids through
the same-cluster mask of models/gaussian_gp.py's assembly.
"""

import numpy as np
import torch

from .gaussian_base import GaussianEngineBase, chol
from .gaussian_gp import (DenseSigmaAssembly, assemble_pred_covs,
                          report_matrices)

DELTA_CONV_MODE = 1e-8
MAXIT_MODE_NEWTON = 1000
MAX_LR_SHRINK_MODE = 20
C_ARMIJO = 1e-4


class _LaplaceNLL(torch.autograd.Function):
    """nll(u, F) at the Laplace mode, with the implicit-function gradient
    (the reference's nll_fn custom_vjp)."""

    @staticmethod
    def forward(ctx, u, F, engine, y, b_init, value=True):
        b, nit = engine._mode_solve(u, F, y, b_init)
        # a caller that wants the gradient alone skips the value
        nll = engine._g(u, F, b, y, create_graph=False) if value \
            else u.new_zeros(())
        engine._note_it(nit)
        ctx.engine, ctx.y = engine, y
        ctx.save_for_backward(u, F, b)
        ctx.mark_non_differentiable(b)
        return nll.detach(), b

    @staticmethod
    def backward(ctx, ct, _ct_b):
        u, F, b = ctx.saved_tensors
        eng, y = ctx.engine, ctx.y
        need_F = ctx.needs_input_grad[1]
        with torch.enable_grad():
            uu = u.detach().requires_grad_(True)
            FF = F.detach().requires_grad_(need_F)
            bb = b.detach().requires_grad_(True)
            g = eng._g(uu, FF, bb, y, create_graph=True, value=False)
            ins = (uu, FF, bb) if need_F else (uu, bb)
            gr = torch.autograd.grad(g, ins, allow_unused=True)
            gr = [torch.zeros_like(x) if d is None else d
                  for d, x in zip(gr, ins)]
            lam = eng._adjoint_solve(u.detach(), F.detach(), b.detach(), y,
                                     gr[-1])
            r = eng._r(uu, FF, b.detach(), y)
            rins = (uu, FF) if need_F else (uu,)
            rg = torch.autograd.grad(r, rins, grad_outputs=lam,
                                     allow_unused=True)
            rg = [torch.zeros_like(x) if d is None else d
                  for d, x in zip(rg, rins)]
        du = (gr[0] - rg[0]) * ct
        dF = (gr[1] - rg[1]) * ct if need_F else None
        return du, dF, None, None, None, None


class LaplaceEngineBase:
    """Host wrappers shared by the Laplace engines. A subclass provides, on
    its device and in its dtype:

        _mode_solve(u, F, y, b_init) -> (mode state, Newton steps)
        _g(u, F, b, y, create_graph, value=True)
                                      -> nll at a fixed mode state; with
                                         value=False only its gradient is
                                         read, and the engine may leave out
                                         of the value a term whose
                                         gradient it keeps
        _r(u, F, b, y)                -> the mode residual
        _adjoint_solve(u, F, b, y, v) -> H^-1 v at the mode

    with u = [log transformed covariance parameters, log internal aux]."""

    device_opt_auto = False

    def _init_common(self, likelihood, num_data, dtype, device, weights):
        self.likelihood = likelihood
        self.n = int(num_data)
        self.dtype = dtype
        self.device = torch.device(device)
        self.weights = None if weights is None else self._t(weights)
        self.num_aux = likelihood.num_aux
        lik = likelihood
        has_fisher = hasattr(lik, "fisher_W")
        # Laplace variants (likelihoods.h:327-369): Fisher curvature for
        # mode finding with "fisher_laplace" and "combined", for the
        # determinant with "fisher_laplace" only
        self._fisher_mode = has_fisher and lik.approx_type in (
            "fisher_laplace", "combined")
        self._fisher_det = has_fisher and lik.approx_type == "fisher_laplace"
        self._lrs = self._t(0.5 ** np.arange(MAX_LR_SHRINK_MODE))

    # ------------------------------------------------------------------
    # uploads through pinned memory and one-read downloads, as the
    # Gaussian engines do
    _t = GaussianEngineBase._t
    _host = staticmethod(GaussianEngineBase._host)

    def prep_y(self, y):
        """y (numpy or tensor, data order) on the device in the engine's
        dtype; numpy goes up through pinned memory without a sync."""
        if torch.is_tensor(y):
            return y.to(device=self.device, dtype=self.dtype)
        return self._t(y)

    def zero_mode(self):
        return torch.zeros(self.dim_mode, dtype=self.dtype,
                           device=self.device)

    def _note_it(self, nit):
        self.last_num_mode_it = int(nit)
        self.total_num_mode_it = getattr(self, "total_num_mode_it", 0) \
            + int(nit)

    # ------------------------------------------------------------------
    # the log-likelihood and its derivatives in the location
    def _loglik(self, y, loc, aux, w=None):
        """Sum over the last axis of the (weighted) log-likelihood; loc may
        carry leading batch axes."""
        ll = self.likelihood.log_lik(y, loc, aux)
        w = self.weights if w is None else w
        if w is not None:
            ll = w * ll
        return ll.sum(-1)

    def _d1_W(self, y, loc, aux, fisher, create_graph, w=None):
        """(d1, W) at loc: the gradient of the log-likelihood and the
        curvature W (-d2, or the Fisher information), from autograd of the
        summed log-likelihood. With create_graph both stay differentiable
        in loc and aux (the third derivative enters through W)."""
        w = self.weights if w is None else w
        with torch.enable_grad():
            loc_g, d1 = self._grad_ll(y, loc, aux, w,
                                      create_graph or not fisher)
            if fisher:
                W = self.likelihood.fisher_W(y, loc_g, aux)
                if w is not None:
                    W = w * W
            else:
                (d2,) = torch.autograd.grad(d1.sum(), loc_g,
                                            create_graph=create_graph)
                W = -d2
        if not create_graph:
            d1, W = d1.detach(), W.detach()
        return d1, W

    def _grad_ll(self, y, loc, aux, w, create_graph):
        """(loc as differentiated, d1 at loc)."""
        with torch.enable_grad():
            loc_g = loc if loc.requires_grad else \
                loc.detach().requires_grad_(True)
            s = torch.sum(self._loglik(y, loc_g, aux, w))
            (d1,) = torch.autograd.grad(s, loc_g, create_graph=create_graph)
        return loc_g, d1

    def _d1(self, y, loc, aux, w=None):
        """d1 at loc, differentiable in loc and aux (the mode residual)."""
        return self._grad_ll(y, loc, aux, w, True)[1]

    # ------------------------------------------------------------------
    def _armijo(self, obj_k, obj, gdd):
        """Index of the step length the sequential backtracking loop would
        take: the first of lr = 1, 1/2, ... whose objective is finite and
        satisfies obj_k >= obj + c lr gdd, else the last."""
        ok = (obj_k >= obj + C_ARMIJO * self._lrs * gdd) \
            & torch.isfinite(obj_k)
        first = torch.argmax(ok.to(torch.int32))
        return torch.where(ok.any(), first,
                           torch.full_like(first, MAX_LR_SHRINK_MODE - 1))

    @staticmethod
    def _pick(k, *batches):
        """Row k of each batch, k a 0-dim device index: index_select keeps
        it on the device (indexing by a 0-dim tensor would read it back)."""
        k = k.reshape(1)
        return [t.index_select(0, k)[0] for t in batches]

    @staticmethod
    def _newton_done(obj_new, obj, it):
        """The mode finder's stopping rule, read back: one host sync."""
        rel = DELTA_CONV_MODE * torch.abs(obj)
        conv = torch.abs(obj_new - obj) < rel if it == 0 \
            else (obj_new - obj) < rel
        return bool(conv | ~torch.isfinite(obj_new))

    # ------------------------------------------------------------------
    # host-facing API (the reference's laplace_nll / _vag / _vag_F)
    def _nll_raw(self, u, F, y, b_init, value=True):
        """(nll, (mode state, Newton steps)) for device tensors u, F, y;
        differentiable in u and F. value=False: the gradient alone (nll
        is 0)."""
        nll, b = _LaplaceNLL.apply(u, F, self, y, b_init, value)
        return nll, (b, self.last_num_mode_it)

    def _F(self, F):
        return F.to(self.dtype) if torch.is_tensor(F) else self._t(F)

    def laplace_nll(self, u, y, F, a_init):
        with torch.no_grad():
            nll, (b, _) = self._nll_raw(self._t(u), self._F(F),
                                        self.prep_y(y), a_init)
        return float(self._host(nll)[0]), b

    def laplace_vag(self, u, y, F, a_init):
        ut = self._t(u).requires_grad_(True)
        nll, (b, _) = self._nll_raw(ut, self._F(F), self.prep_y(y), a_init)
        (gu,) = torch.autograd.grad(nll, ut)
        v, g = self._host(nll, gu)
        return float(v), g, b

    def laplace_grad(self, u, y, F, a_init):
        """(g_u, mode state) without the NLL's value."""
        ut = self._t(u).requires_grad_(True)
        nll, (b, _) = self._nll_raw(ut, self._F(F), self.prep_y(y), a_init,
                                    value=False)
        (gu,) = torch.autograd.grad(nll, ut)
        return self._host(gu)[0], b

    def vag_F_device(self, u, y, F, a_init, value=True):
        """(nll, g_u, g_F, mode state) as device tensors (nll 0 with
        value=False)."""
        ut = self._t(u).requires_grad_(True)
        Ft = self._F(F).detach().requires_grad_(True)
        nll, (b, _) = self._nll_raw(ut, Ft, self.prep_y(y), a_init, value)
        gu, gF = torch.autograd.grad(nll, (ut, Ft))
        return nll.detach(), gu, gF, b

    def laplace_vag_F(self, u, y, F, a_init):
        nll, gu, gF, b = self.vag_F_device(u, y, F, a_init)
        v, gu, gF = self._host(nll, gu, gF)
        return float(v), gu, gF, b

    def _u_from_pars(self, pars_orig, aux_pars, y):
        u = np.log(self.transform_pars(pars_orig))
        if self.num_aux:
            if aux_pars is None:
                aux_pars = self.likelihood.init_aux(np.asarray(y))
            else:
                aux_pars = self.likelihood.aux_to_internal(aux_pars)
            u = np.concatenate([u, np.log(np.asarray(aux_pars,
                                                     dtype=np.float64))])
        return u

    def neg_log_likelihood(self, pars_orig, y, aux_pars=None,
                           fixed_effects=None):
        u = self._u_from_pars(pars_orig, aux_pars, y)
        F = np.zeros(self.n) if fixed_effects is None \
            else np.asarray(fixed_effects, dtype=np.float64)
        if len(F) != self.n:
            raise ValueError(f"fixed_effects must have length {self.n}, "
                             f"got {len(F)}")
        nll, _ = self.laplace_nll(u, y, F, self.zero_mode())
        return nll



class LaplaceDenseEngine(LaplaceEngineBase):
    """Laplace-approximated marginal NLL, gradients and prediction with a
    dense covariance Sigma(theta) = sum_j v_j (W_j o K_j)."""

    def __init__(self, components, num_data, likelihood, cluster_ids=None,
                 dtype=torch.float64, weights=None, *, device):
        self._init_common(likelihood, num_data, dtype, device, weights)
        self._assembly = DenseSigmaAssembly(components, num_data, dtype,
                                            self.device, cluster_ids)
        self.components = self._assembly.components
        self.par_offsets = self._assembly.par_offsets
        self.num_theta = self._assembly.num_theta
        self.num_cov_par = self.num_theta
        self.num_par = self.num_theta + self.num_aux
        self.dim_mode = self.n
        self._eye = torch.eye(self.n, dtype=dtype, device=self.device)

    def _split_u(self, u):
        nt = self.num_theta
        return self._assembly.sigma(u[:nt]), torch.exp(u[nt:])

    def _B_chol(self, Sigma, W):
        """(sqrt(W), chol(I + sqrt(W) Sigma sqrt(W)))."""
        sW = torch.sqrt(torch.clamp(W, min=0.0))
        return sW, chol(self._eye + (sW[:, None] * Sigma) * sW[None, :])

    @staticmethod
    def _cho(L, b):
        return torch.cholesky_solve(b[:, None] if b.ndim == 1 else b,
                                    L).reshape(b.shape)

    # ------------------------------------------------------------------
    def _mode_solve(self, u, F, y, a_init):
        with torch.no_grad():
            Sigma, aux = self._split_u(u)
            a = a_init
            mode = Sigma @ a
            obj = -0.5 * (a @ mode) + self._loglik(y, mode + F, aux)
            lrs = self._lrs[:, None]
            it = 0
            while it < MAXIT_MODE_NEWTON:
                d1, W = self._d1_W(y, mode + F, aux, self._fisher_mode,
                                   False)
                rhs = W * mode + d1
                sW, L = self._B_chol(Sigma, W)
                a_upd = rhs - sW * self._cho(L, sW * (Sigma @ rhs))
                mode_upd = Sigma @ a_upd
                direction = mode_upd - mode
                gdd = direction @ (a_upd - a + W * direction)
                a_k = lrs * a_upd + (1.0 - lrs) * a
                mode_k = lrs * mode_upd + (1.0 - lrs) * mode
                obj_k = -0.5 * torch.sum(a_k * mode_k, -1) \
                    + self._loglik(y, mode_k + F, aux)
                k = self._armijo(obj_k, obj, gdd)
                a_new, mode_new, obj_new = self._pick(k, a_k, mode_k, obj_k)
                done = self._newton_done(obj_new, obj, it)
                a, mode, obj = a_new, mode_new, obj_new
                it += 1
                if done:
                    break
        return a, it

    def _g(self, u, F, a, y, create_graph, value=True):
        Sigma, aux = self._split_u(u)
        mode = Sigma @ a
        loc = mode + F
        _, W = self._d1_W(y, loc, aux, self._fisher_det, create_graph)
        _, L = self._B_chol(Sigma, W)
        half_logdet = torch.sum(torch.log(torch.diagonal(L)))
        return 0.5 * (a @ mode) - self._loglik(y, loc, aux) + half_logdet

    def _r(self, u, F, a, y):
        Sigma, aux = self._split_u(u)
        return a - self._d1(y, Sigma @ a + F, aux)

    def _adjoint_solve(self, u, F, a, y, g_a):
        """(I + Sigma W)^-1 g_a = g_a - Sigma sW B^-1 sW g_a."""
        with torch.no_grad():
            Sigma, aux = self._split_u(u)
            _, W = self._d1_W(y, Sigma @ a + F, aux, self._fisher_det, False)
            sW, L = self._B_chol(Sigma, W)
            return g_a - Sigma @ (sW * self._cho(L, sW * g_a))

    # ------------------------------------------------------------------
    # parameter transforms (no nugget: sigma2 = 1, cov_fcts.h:501)
    def transform_pars(self, pars_orig):
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        out = []
        for comp, off in zip(self.components, self.par_offsets):
            out.append(pars_orig[off])
            if comp.num_cov_par > 1:
                rho = pars_orig[off + 1: off + comp.num_cov_par]
                out.extend(np.atleast_1d(comp.cov_fn.range_to_transformed(
                    rho, var=pars_orig[off])))
        return np.asarray(out)

    def back_transform_pars(self, pars_internal):
        t = np.asarray(pars_internal, dtype=np.float64)
        out = []
        for comp, off in zip(self.components, self.par_offsets):
            out.append(t[off])
            if comp.num_cov_par > 1:
                alphas = t[off + 1: off + comp.num_cov_par]
                out.extend(np.atleast_1d(comp.cov_fn.range_from_transformed(
                    alphas, var=t[off])))
        return np.asarray(out)

    def training_re(self, u, a_state, predict_var=False):
        """Per-component posterior means of the random effects at the
        training points: at the mode a = Sigma^-1 b, so component j's part
        is R_j a (re_model_template.h:4420, non-Gaussian branch)."""
        if predict_var:
            raise ValueError("predict_training_data_random_effects with "
                             "predict_var=True is not implemented for "
                             "non-Gaussian likelihoods; use predict()")
        with torch.no_grad():
            theta_log = self._t(np.asarray(u)[:self.num_theta])
            Rs = report_matrices(self._assembly, theta_log)
            return self._host(torch.stack([R @ a_state for R in Rs],
                                          1))[0], None

    def predict(self, pars_orig, aux_pars, y, F, pred_data, a_init=None,
                predict_var=False, predict_cov_mat=False,
                predict_response=False, F_pred=None):
        """Laplace-approximate predictions (PredictLaplaceApproxStable,
        likelihoods.h:7253; PredictResponse, :9581)."""
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        t = self.transform_pars(pars_orig)
        u = self._u_from_pars(pars_orig, aux_pars, y)
        with torch.no_grad():
            ud = self._t(u)
            theta_log = ud[:self.num_theta]
            aux_d = torch.exp(ud[self.num_theta:])
            K_cross, K_pred = assemble_pred_covs(
                self.components, self.par_offsets,
                [t[off] for off in self.par_offsets], theta_log, pred_data,
                self.n, self.dtype, self.device)
            yd, Fd = self.prep_y(y), self._F(F)
            if a_init is None:
                a_init = self.zero_mode()
            a, nit = self._mode_solve(ud, Fd, yd, a_init)
            self._note_it(nit)
            Sigma = self._assembly.sigma(theta_log)
            _, W = self._d1_W(yd, Sigma @ a + Fd, aux_d, self._fisher_det,
                              False)
            sW, L = self._B_chol(Sigma, W)
            mu = K_cross.T @ a
            V = self._cho(L, sW[:, None] * K_cross)
            cov = None
            if predict_cov_mat:
                cov = K_pred - (sW[:, None] * K_cross).T @ V
                var = torch.diagonal(cov)
            else:
                var = torch.diagonal(K_pred) \
                    - torch.sum((sW[:, None] * K_cross) * V, 0)
            if F_pred is not None:
                mu = mu + self._F(F_pred)
            out = {}
            if predict_response:
                m, v = self.likelihood.response_mean_var(
                    mu, torch.clamp(var, min=0.0), aux_d)
                out["mu"] = self._host(m)[0]
                if predict_var or predict_cov_mat:
                    out["var"] = self._host(v)[0]
                return out
            out["mu"] = self._host(mu)[0]
            if predict_cov_mat:
                out["cov"] = self._host(cov)[0]
            if predict_var:
                out["var"] = self._host(var)[0].copy()
            return out
