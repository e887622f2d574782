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

What the engines share also covers the likelihoods of
likelihoods/families.py:

  * two predictor sets (num_sets_fe = 2): F is (2n,), the random effects
    attach to the first block and the second (zeta) enters log_lik2 as an
    argument. The engines form the location as [latent + F1, F2] (`_loc`),
    so autograd reaches zeta, and read d1 and W of the first block;
  * the curvature of the approximation: the observed Hessian, the Fisher
    information (fisher_W, fisher_W2) or the triangular-kernel curvature of
    likelihoods/tkc.py ("tkc", one constant from a device search);

and the dense engine also has

  * the W+/W- split Cholesky of the reference for a curvature that can be
    negative or exactly zero (W_may_be_negative / W_may_be_zero: the
    zero-inflated counts' observed Hessian, the hurdle families at y = 0),
    whose half log-determinant is a `torch.autograd.Function` with the
    exact gradient at W = 0 and a backward that autograd can differentiate
    again;
  * two random-effect sets (num_sets_re = 2,
    gaussian_heteroscedastic_fixed_and_random): the mode is 2n, Sigma the
    block diagonal of the same structure twice with covariance parameters
    of its own, as the reference forms it.

The dense engine takes cluster_ids through the same-cluster mask of
models/gaussian_gp.py's assembly.
"""

import numpy as np
import torch

from ..likelihoods.tkc import tkc_neg_curvature
from .gaussian_base import GaussianEngineBase, chol
from .gaussian_gp import (DenseSigmaAssembly, assemble_pred_covs,
                          report_matrices)

DELTA_CONV_MODE = 1e-8
MAXIT_MODE_NEWTON = 1000
MAX_LR_SHRINK_MODE = 20
C_ARMIJO = 1e-4


# ----------------------------------------------------------------------
# Cholesky-only operators for a diagonal W that can be negative or zero
# (the reference's models/laplace.py:40-112). With W = W+ - W-:
#   B+ = I + sqrt(W+) Sigma sqrt(W+),  T = (I + Sigma W+)^-1 Sigma,
#   D = I - sqrt(W-) T sqrt(W-),
#   log|I + Sigma W| = log|B+| + log|D|,
#   (I + Sigma W)^-1 = (I - T W-)^-1 (I + Sigma W+)^-1,
#   (I + W Sigma)^-1 = (I + W+ Sigma)^-1 (I - W- T)^-1.
# D is SPD exactly when Sigma^-1 + W is (at any proper Laplace mode).
def _cho(L, b):
    return torch.cholesky_solve(b[:, None] if b.ndim == 1 else b,
                                L).reshape(b.shape)


def _scale(v, X):
    return v[:, None] * X if X.ndim == 2 else v * X


def _negw_factors(Sigma, W):
    eye = torch.eye(Sigma.shape[0], dtype=Sigma.dtype, device=Sigma.device)
    sp = torch.sqrt(torch.clamp(W, min=0.0))
    sm = torch.sqrt(torch.clamp(-W, min=0.0))
    Lp = chol(eye + (sp[:, None] * Sigma) * sp[None, :])
    SW = Sigma * sp[None, :]                   # Sigma sqrt(W+)
    T = Sigma - SW @ _cho(Lp, SW.T)
    Ld = chol(eye - (sm[:, None] * T) * sm[None, :])
    return Lp, Ld, SW, T, sp, sm


def _negw_solve_IpSW(factors, g):
    """(I + Sigma W)^-1 g for (n,) or (n, p) g."""
    Lp, Ld, SW, T, sp, sm = factors
    h = g - SW @ _cho(Lp, _scale(sp, g))
    return h + T @ _scale(sm, _cho(Ld, _scale(sm, h)))


def _negw_solve_IpWS(factors, rhs, Sigma):
    """(I + W Sigma)^-1 rhs for (n,) or (n, p) rhs."""
    Lp, Ld, SW, T, sp, sm = factors
    h = rhs + _scale(sm, _cho(Ld, _scale(sm, T @ rhs)))
    return h - _scale(sp, _cho(Lp, _scale(sp, Sigma @ h)))


class _IpSWInv(torch.autograd.Function):
    """G = (I + Sigma diag(W))^-1 from the split factors. The backward is
    the analytic one of a matrix inverse, -G' Gbar G', in products of G,
    Sigma and W only: it holds at W = 0 and autograd can differentiate it
    again (G's own graph is this Function)."""

    @staticmethod
    def forward(ctx, Sigma, W):
        eye = torch.eye(Sigma.shape[0], dtype=Sigma.dtype,
                        device=Sigma.device)
        G = _negw_solve_IpSW(_negw_factors(Sigma, W), eye)
        ctx.save_for_backward(Sigma, W, G)
        return G

    @staticmethod
    def backward(ctx, Gbar):
        Sigma, W, G = ctx.saved_tensors
        Abar = -G.T @ Gbar @ G.T
        return Abar * W[None, :], torch.sum(Abar * Sigma, 0)


class _NegwHalfLogdet(torch.autograd.Function):
    """0.5 log|I + Sigma W| for a W that can be negative or zero. The
    sqrt(max(W, 0)) split gives the value but no gradient at W = 0, so the
    backward is the exact one: 0.5 diag((I + Sigma W)^-1 Sigma) in W and
    0.5 (I + Sigma W)^-T diag(W) in Sigma, through `_IpSWInv` (the
    reference's custom VJP)."""

    @staticmethod
    def forward(ctx, Sigma, W):
        Lp, Ld = _negw_factors(Sigma, W)[:2]
        ctx.save_for_backward(Sigma, W)
        return torch.sum(torch.log(torch.diagonal(Lp))) \
            + torch.sum(torch.log(torch.diagonal(Ld)))

    @staticmethod
    def backward(ctx, ct):
        Sigma, W = ctx.saved_tensors
        G = _IpSWInv.apply(Sigma, W)
        dW = 0.5 * ct * torch.sum(G * Sigma.T, 1)
        dSigma = 0.5 * ct * (G.T * W[None, :])
        return dSigma, dW


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
        self.num_sets_fe = 2 if getattr(lik, "num_sets_fe", 1) == 2 else 1
        self.num_sets_re = getattr(lik, "num_sets_re", 1)
        two = self.num_sets_fe == 2
        has_fisher = hasattr(lik, "fisher_W2") if two \
            else hasattr(lik, "fisher_W")
        # Laplace variants (likelihoods.h:327-369): Fisher curvature for
        # mode finding with "fisher_laplace" and "combined", for the
        # determinant with "fisher_laplace" only; the triangular-kernel
        # curvature ("tkc") for the determinant, and for the mode with
        # '_not_fisher_mode_finding' (likelihoods.h:449-451, :13097-13111)
        self._fisher_mode = has_fisher and lik.approx_type in (
            "fisher_laplace", "combined")
        self._fisher_det = has_fisher and lik.approx_type == "fisher_laplace"
        if lik.approx_type == "tkc":
            self._fisher_mode = "tkc" if lik.mode_finding == "not_fisher" \
                else True
            self._fisher_det = "tkc"
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
    def _loc(self, x, F):
        """The location from the latent x (..., dim_mode) and F: x + F, or
        with two predictor sets and one random-effect set [x + F1, F2]
        (..., 2n), the second block broadcast over x's batch axes."""
        if self.num_sets_fe == 1 or self.num_sets_re == 2:
            return x + F
        n = x.shape[-1]
        F2 = F[n:]
        return torch.cat([x + F[:n], F2.expand(x.shape[:-1] + F2.shape)], -1)

    def _loglik(self, y, loc, aux, w=None):
        """Sum over the last axis of the (weighted) log-likelihood; loc may
        carry leading batch axes (and both predictor blocks, see _loc)."""
        if self.num_sets_fe == 2:
            n = y.shape[-1]
            ll = self.likelihood.log_lik2(y, loc[..., :n], loc[..., n:], aux)
        else:
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
        lik = self.likelihood
        n = y.shape[-1]
        # the first block's derivatives when zeta rides in loc's 2nd half
        fe2 = self.num_sets_fe == 2 and self.num_sets_re == 1
        with torch.enable_grad():
            loc_g, d1 = self._grad_ll(y, loc, aux, w,
                                      create_graph or fisher is not True)
            if fisher == "tkc":
                W = self._W_tkc(y, loc_g, aux, w)
            elif fisher:
                if self.num_sets_re == 2:
                    W = lik.fisher_W_stacked(y, loc_g[..., :n],
                                             loc_g[..., n:], aux)
                    if w is not None:
                        W = torch.cat([w, w]) * W
                else:
                    W = lik.fisher_W2(y, loc_g[..., :n], loc_g[..., n:],
                                      aux) if fe2 \
                        else lik.fisher_W(y, loc_g, aux)
                    if w is not None:
                        W = w * W
            else:
                (d2,) = torch.autograd.grad(
                    (d1[..., :n] if fe2 else d1).sum(), loc_g,
                    create_graph=create_graph)
                W = -(d2[..., :n] if fe2 else d2)
        if fe2:
            d1 = d1[..., :n]
        if not create_graph:
            d1, W = d1.detach(), W.detach()
        return d1, W

    def _W_tkc(self, y, loc, aux, w):
        """The triangular-kernel curvature: one constant times the weights
        (likelihoods.h:13097-13111), differentiable in loc with delta
        fixed."""
        c = tkc_neg_curvature(lambda s: self._loglik(y, loc + s, aux, w),
                              self.n, loc)
        return (torch.ones_like(loc) if w is None else w) * c

    def _grad_ll(self, y, loc, aux, w, create_graph):
        """(loc as differentiated, d1 at loc)."""
        with torch.enable_grad():
            loc_g = loc if loc.requires_grad else \
                loc.detach().requires_grad_(True)
            s = torch.sum(self._loglik(y, loc_g, aux, w))
            (d1,) = torch.autograd.grad(s, loc_g, create_graph=create_graph)
        return loc_g, d1

    def _d1(self, y, loc, aux, w=None):
        """d1 at loc (the first block's with two predictor sets),
        differentiable in loc and aux (the mode residual)."""
        d1 = self._grad_ll(y, loc, aux, w, True)[1]
        if self.num_sets_fe == 2 and self.num_sets_re == 1:
            return d1[..., :y.shape[-1]]
        return d1

    # ------------------------------------------------------------------
    # predictions: F_pred's layout and the response moments
    def _split_pred(self, mu, F_pred):
        """(mu + F1_pred, zeta_pred or None) for the latent means mu (m,):
        with two predictor sets F_pred carries both blocks stacked, and a
        missing F_pred is 0 in both. F_pred comes to mu's device and
        dtype (a host mu takes it in float64)."""
        Fp = None
        if F_pred is not None:
            Fp = (torch.as_tensor(np.asarray(F_pred, dtype=np.float64))
                  if mu.device.type == "cpu" else self._F(F_pred))
            Fp = Fp.to(mu.dtype)
        zeta = None
        if self.num_sets_fe == 2:
            m = mu.shape[0]
            zeta = torch.zeros_like(mu) if Fp is None else Fp[m:]
            Fp = None if Fp is None else Fp[:m]
        return (mu if Fp is None else mu + Fp), zeta

    def _response(self, mu, var, zeta, aux):
        """The response mean and variance at the latent means mu and
        variances var (clamped at 0); zeta from _split_pred."""
        lik, var = self.likelihood, torch.clamp(var, min=0.0)
        if zeta is None:
            return lik.response_mean_var(mu, var, aux)
        return lik.response_mean_var2(mu, var, zeta, aux)

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
        nf = self.n * self.num_sets_fe
        F = np.zeros(nf) if fixed_effects is None \
            else np.asarray(fixed_effects, dtype=np.float64)
        if len(F) != nf:
            raise ValueError(
                f"fixed_effects must have length {nf} "
                f"(num_sets_fe = {self.num_sets_fe}), got {len(F)}")
        nll, _ = self.laplace_nll(u, y, F, self.zero_mode())
        return nll



class LaplaceDenseEngine(LaplaceEngineBase):
    """Laplace-approximated marginal NLL, gradients and prediction with a
    dense covariance Sigma(theta) = sum_j v_j (W_j o K_j) (block diagonal,
    the same structure twice, for two random-effect sets)."""

    def __init__(self, components, num_data, likelihood, cluster_ids=None,
                 dtype=torch.float64, weights=None, *, device):
        self._init_common(likelihood, num_data, dtype, device, weights)
        self._assembly = DenseSigmaAssembly(components, num_data, dtype,
                                            self.device, cluster_ids)
        self.components = self._assembly.components
        self.par_offsets = self._assembly.par_offsets
        self.num_theta = self._assembly.num_theta * self.num_sets_re
        self.num_cov_par = self.num_theta
        self.num_par = self.num_theta + self.num_aux
        self.dim_mode = self.n * self.num_sets_re
        self._eye = torch.eye(self.dim_mode, dtype=dtype, device=self.device)
        lik = likelihood
        # the split-Cholesky paths (the reference's laplace.py:213-221): a
        # curvature that can be negative takes them in every solve, one that
        # can be exactly zero in the differentiated determinant (sqrt(W)
        # has no derivative at 0)
        self._w_neg = bool(getattr(lik, "W_may_be_negative", False))
        self._w_det_general = self._w_neg or bool(
            getattr(lik, "W_may_be_zero", False))
        self._w_neg_mode = self._w_neg and self._fisher_mode is not True

    def _sigma(self, theta_log):
        if self.num_sets_re == 1:
            return self._assembly.sigma(theta_log)
        kb = self._assembly.num_theta
        return torch.block_diag(self._assembly.sigma(theta_log[:kb]),
                                self._assembly.sigma(theta_log[kb:]))

    def _split_u(self, u):
        nt = self.num_theta
        return self._sigma(u[:nt]), torch.exp(u[nt:])

    def _B_chol(self, Sigma, W):
        """(sqrt(W), chol(I + sqrt(W) Sigma sqrt(W)))."""
        sW = torch.sqrt(torch.clamp(W, min=0.0))
        return sW, chol(self._eye + (sW[:, None] * Sigma) * sW[None, :])

    _cho = staticmethod(_cho)

    def _solve_IpSW(self, Sigma, W, g):
        """(I + Sigma W)^-1 g (n,) or (n, p)."""
        if self._w_neg:
            return _negw_solve_IpSW(_negw_factors(Sigma, W), g)
        sW, L = self._B_chol(Sigma, W)
        return g - Sigma @ _scale(sW, _cho(L, _scale(sW, g)))

    # ------------------------------------------------------------------
    def _mode_solve(self, u, F, y, a_init):
        with torch.no_grad():
            Sigma, aux = self._split_u(u)
            a = a_init
            mode = Sigma @ a
            obj = -0.5 * (a @ mode) + self._loglik(y, self._loc(mode, F), aux)
            lrs = self._lrs[:, None]
            it = 0
            while it < MAXIT_MODE_NEWTON:
                d1, W = self._d1_W(y, self._loc(mode, F), aux,
                                   self._fisher_mode, False)
                rhs = W * mode + d1
                if self._w_neg_mode:
                    a_upd = _negw_solve_IpWS(_negw_factors(Sigma, W), rhs,
                                             Sigma)
                else:
                    sW, L = self._B_chol(Sigma, W)
                    a_upd = rhs - sW * self._cho(L, sW * (Sigma @ rhs))
                mode_upd = Sigma @ a_upd
                direction = mode_upd - mode
                gdd = direction @ (a_upd - a + W * direction)
                a_k = lrs * a_upd + (1.0 - lrs) * a
                mode_k = lrs * mode_upd + (1.0 - lrs) * mode
                obj_k = -0.5 * torch.sum(a_k * mode_k, -1) \
                    + self._loglik(y, self._loc(mode_k, F), aux)
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
        loc = self._loc(mode, F)
        _, W = self._d1_W(y, loc, aux, self._fisher_det, create_graph)
        if self._w_det_general:
            half_logdet = _NegwHalfLogdet.apply(Sigma, W)
        else:
            _, L = self._B_chol(Sigma, W)
            half_logdet = torch.sum(torch.log(torch.diagonal(L)))
        return 0.5 * (a @ mode) - self._loglik(y, loc, aux) + half_logdet

    def _r(self, u, F, a, y):
        Sigma, aux = self._split_u(u)
        return a - self._d1(y, self._loc(Sigma @ a, F), aux)

    def _adjoint_solve(self, u, F, a, y, g_a):
        """(I + Sigma W)^-1 g_a, W the determinant's curvature."""
        with torch.no_grad():
            Sigma, aux = self._split_u(u)
            _, W = self._d1_W(y, self._loc(Sigma @ a, F), aux,
                              self._fisher_det, False)
            return self._solve_IpSW(Sigma, W, g_a)

    # ------------------------------------------------------------------
    # parameter transforms (no nugget: sigma2 = 1, cov_fcts.h:501), once
    # per random-effect set
    def _transform_half(self, pars_orig):
        out = []
        for comp, off in zip(self.components, self.par_offsets):
            out.append(pars_orig[off])
            if comp.num_cov_par > 1:
                rho = pars_orig[off + 1: off + comp.num_cov_par]
                out.extend(np.atleast_1d(comp.cov_fn.range_to_transformed(
                    rho, var=pars_orig[off])))
        return np.asarray(out)

    def _back_transform_half(self, t):
        out = []
        for comp, off in zip(self.components, self.par_offsets):
            out.append(t[off])
            if comp.num_cov_par > 1:
                alphas = t[off + 1: off + comp.num_cov_par]
                out.extend(np.atleast_1d(comp.cov_fn.range_from_transformed(
                    alphas, var=t[off])))
        return np.asarray(out)

    def _per_set(self, fn, pars):
        pars = np.asarray(pars, dtype=np.float64)
        if self.num_sets_re == 1:
            return fn(pars)
        k = len(pars) // 2
        return np.concatenate([fn(pars[:k]), fn(pars[k:])])

    def transform_pars(self, pars_orig):
        return self._per_set(self._transform_half, pars_orig)

    def back_transform_pars(self, pars_internal):
        return self._per_set(self._back_transform_half, pars_internal)

    def training_re(self, u, a_state, predict_var=False):
        """Per-component posterior means of the random effects at the
        training points: at the mode a = Sigma^-1 b, so component j's part
        is R_j a (re_model_template.h:4420, non-Gaussian branch)."""
        if predict_var:
            raise ValueError("predict_training_data_random_effects with "
                             "predict_var=True is not implemented for "
                             "non-Gaussian likelihoods; use predict()")
        if self.num_sets_re == 2:
            raise NotImplementedError(
                "predict_training_data_random_effects is not implemented "
                "for num_sets_re = 2 likelihoods; use predict()")
        with torch.no_grad():
            theta_log = self._t(np.asarray(u)[:self.num_theta])
            Rs = report_matrices(self._assembly, theta_log)
            return self._host(torch.stack([R @ a_state for R in Rs],
                                          1))[0], None

    def _pred_covs(self, t, theta_log, pred_data):
        """Cross and prediction covariances; for two random-effect sets
        block diagonal, one block per set."""
        kb = self._assembly.num_theta
        Kc, Kp = [], []
        for s in range(self.num_sets_re):
            ts = t[s * kb:(s + 1) * kb]
            kc, kp = assemble_pred_covs(
                self.components, self.par_offsets,
                [ts[off] for off in self.par_offsets],
                theta_log[s * kb:(s + 1) * kb], pred_data, self.n,
                self.dtype, self.device)
            Kc.append(kc)
            Kp.append(kp)
        if self.num_sets_re == 1:
            return Kc[0], Kp[0]
        return torch.block_diag(*Kc), torch.block_diag(*Kp)

    def predict(self, pars_orig, aux_pars, y, F, pred_data, a_init=None,
                predict_var=False, predict_cov_mat=False,
                predict_response=False, F_pred=None):
        """Laplace-approximate predictions (PredictLaplaceApproxStable,
        likelihoods.h:7253; PredictResponse, :9581)."""
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        t = self.transform_pars(pars_orig)
        u = self._u_from_pars(pars_orig, aux_pars, y)
        lik = self.likelihood
        with torch.no_grad():
            ud = self._t(u)
            theta_log = ud[:self.num_theta]
            aux_d = torch.exp(ud[self.num_theta:])
            K_cross, K_pred = self._pred_covs(t, theta_log, pred_data)
            yd, Fd = self.prep_y(y), self._F(F)
            if a_init is None:
                a_init = self.zero_mode()
            a, nit = self._mode_solve(ud, Fd, yd, a_init)
            self._note_it(nit)
            Sigma = self._sigma(theta_log)
            _, W = self._d1_W(yd, self._loc(Sigma @ a, Fd), aux_d,
                              self._fisher_det, False)
            mu = K_cross.T @ a
            if self._w_neg:
                # (Sigma + W^-1)^-1 K = W (I + Sigma W)^-1 K
                M = W[:, None] * self._solve_IpSW(Sigma, W, K_cross)
                SK, V = K_cross, M
            else:
                sW, L = self._B_chol(Sigma, W)
                SK = sW[:, None] * K_cross
                V = self._cho(L, SK)
            cov = None
            if predict_cov_mat:
                cov = K_pred - SK.T @ V
                var = torch.diagonal(cov)
            else:
                var = torch.diagonal(K_pred) - torch.sum(SK * V, 0)
            out = {}
            if self.num_sets_re == 2:
                # both blocks latent: the mean process (block 0) and the
                # log-variance process (block 1)
                m_pred = mu.shape[0] // 2
                if F_pred is not None:
                    mu = mu + self._F(F_pred)
                mu1, mu2 = mu[:m_pred], mu[m_pred:]
                var1, var2 = var[:m_pred], var[m_pred:]
                if predict_response:
                    mm, vv = lik.response_mean_var_2re(
                        mu1, torch.clamp(var1, min=0.0), mu2,
                        torch.clamp(var2, min=0.0), aux_d)
                    out["mu"] = self._host(mm)[0]
                    if predict_var or predict_cov_mat:
                        out["var"] = self._host(vv)[0]
                    return out
                out["mu"] = self._host(mu1)[0]
                if predict_cov_mat:
                    out["cov"] = self._host(cov[:m_pred, :m_pred])[0]
                if predict_var:
                    out["var"] = self._host(var1)[0].copy()
                return out
            mu, zeta = self._split_pred(mu, F_pred)
            if predict_response:
                m, v = self._response(mu, var, zeta, aux_d)
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
