"""Covariance-parameter estimation for Gaussian models (counterpart of
gpboost_tpu/models/optimize.py, REModelTemplate::OptimLinRegrCoefCovPar,
re_model_template.h:969).

  * internal optimizers (`_optimize_internal`): gradient descent with
    Nesterov acceleration and Armijo backtracking with permanent learning-
    rate halving (re_model_template.h:8621 UpdateCovAuxPars), the nugget
    profiled out (:2605 ProfileOutSigma2); Fisher scoring and Newton with
    the step clipped at log(100) (:8661-8669); all on the log-transformed
    parameters, as host loops with one host read per evaluation;
  * linear covariates X on every path: GLS coefficients (`wls`) or a
    gradient step with the reference's covariate scaling and learning-rate
    cap (`gradient_descent`, :9106 UpdateLinCoef);
  * external optimizers (`_optimize_external`) on the nugget-profiled
    objective (optim_utils.h:243, :562 OptimExternal): scipy L-BFGS-B and
    Nelder-Mead on the host, and adam (`_adam`, optax.adam(1e-2) by hand
    in float64), one value-and-gradient pass on the device per
    evaluation;
  * the device L-BFGS (`_optimize_external_device`, ops/lbfgs.py), taken,
    as in the reference (optimize.py:1077-1090), for an lbfgs-family
    optimizer other than lbfgs_not_profile_out_nugget with the nugget
    estimated, when the engine exposes a raw profiled objective (dense and
    Vecchia) and `use_device_optimizer` is True, or None and n >= 20,000;
  * fixed parameters (estimate_cov_par_index) and standard errors from the
    inverse Fisher information (std_dev=True);
  * for non-Gaussian likelihoods (`optimize_laplace`, the Laplace engines):
    gradient descent with and without Nesterov and separate covariance /
    aux learning rates, coefficient gradient steps with X, scipy L-BFGS-B,
    Nelder-Mead and adam with the mode warm-started across evaluations,
    and the
    state-threaded device L-BFGS (ops/lbfgs.py `lbfgs_run_state`), taken
    for an lbfgs-family optimizer with use_device_optimizer True, or None
    and n >= 20,000 on an engine marked device_opt_auto (the grouped one);
    fisher_scoring and newton raise ValueError, as in the reference.

y enters as a device tensor in the engine's ordering and dtype; X, when
given, as float64 numpy in the same row order.

Constants are the reference's (re_model_template.h:5682-5796).
"""

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

LR_SHRINKAGE_FACTOR = 0.5
C_ARMIJO = 1e-4
C_ARMIJO_MOM = 1e-4
MAX_NUM_LR_SHRINKAGE_STEPS = 30
MAX_GRADIENT_UPDATE_LOG_SCALE = math.log(100.0)
C_MAX_CHANGE_COEF = 10.0
DEVICE_OPTIMIZER_MIN_N = 20000


@dataclass
class OptimConfig:
    optimizer_cov: str = "lbfgs"
    optimizer_coef: str = "wls"
    lr_cov: float = -999.0          # -999 -> default (0.1 gd, 1.0 otherwise)
    lr_coef: float = 0.1
    use_nesterov_acc: bool = True
    acc_rate_cov: float = 0.5
    acc_rate_coef: float = 0.5
    momentum_offset: int = 2
    nesterov_schedule_version: int = 0
    delta_rel_conv: float = -999.0  # -999 -> 1e-6 (1e-8 for nelder_mead)
    convergence_criterion: str = "relative_change_in_log_likelihood"
    max_iter: int = 1000
    init_cov_pars: Optional[np.ndarray] = None
    estimate_cov_par_index: Optional[list] = None
    std_dev: bool = False
    maxit: Optional[int] = None     # alias used by reference tests for lbfgs
    # None -> the device L-BFGS from n = 20,000; True / False force it
    use_device_optimizer: Optional[bool] = None
    # non-Gaussian likelihoods: aux parameters on the user's scale
    init_aux_pars: Optional[np.ndarray] = None
    estimate_aux_pars: bool = True

    def resolved_lr_cov(self):
        if self.lr_cov < 0:
            return 0.1 if self.optimizer_cov == "gradient_descent" else 1.0
        return self.lr_cov

    def resolved_delta_rel_conv(self):
        if self.delta_rel_conv < 0:
            return 1e-8 if self.optimizer_cov == "nelder_mead" else 1e-6
        return self.delta_rel_conv


@dataclass
class OptimResult:
    cov_pars: np.ndarray = None          # original scale
    num_it: int = 0
    neg_log_likelihood: float = np.nan
    std_dev_cov_pars: Optional[np.ndarray] = None
    coef: Optional[np.ndarray] = None
    std_dev_coef: Optional[np.ndarray] = None
    converged: bool = False
    optimizer: str = ""                  # which loop ran: internal,
                                         # scipy or device_lbfgs
    aux_pars: Optional[np.ndarray] = None   # user scale (Laplace engines)
    mode_state: object = None               # the Laplace mode, a tensor


def nesterov_mu(it, version, acc_rate, momentum_offset):
    """re_model_template.h:6098 NesterovSchedule."""
    if it < momentum_offset:
        return 0.0
    if version == 0:
        return acc_rate
    if version == 1:
        return 1.0 - (3.0 / (6.0 + it))
    raise ValueError(f"nesterov_schedule_version {version}")


_INTERNAL = ("gradient_descent", "fisher_scoring", "newton")
_EXTERNAL = ("lbfgs", "lbfgs_linesearch_nocedal_wright",
             "lbfgs_not_profile_out_nugget", "nelder_mead", "bfgs_optim_lib")


def optimize_gaussian(engine, y, config: OptimConfig, X=None) -> OptimResult:
    """Estimate the covariance parameters (and, with X, the linear
    coefficients) for Gaussian y, a device tensor in the engine's
    ordering."""
    opt = config.optimizer_cov
    if opt in _INTERNAL:
        res = _optimize_internal(engine, y, config, X)
    elif opt in _EXTERNAL + ("adam",):
        res = _optimize_external(engine, y, config, X)
    else:
        raise ValueError(f"optimizer_cov '{opt}' is not supported")
    if config.std_dev:
        FI = engine.fisher_original(res.cov_pars)
        std = np.full(len(res.cov_pars), np.nan)
        try:
            d = np.diagonal(np.linalg.inv(FI))
            ok = np.isfinite(d) & (d >= 0)
            std[ok] = np.sqrt(d[ok])
        except np.linalg.LinAlgError:
            pass
        res.std_dev_cov_pars = std
        if X is not None and res.coef is not None \
                and hasattr(engine, "psi_tilde"):
            # CalcStdDevCoef (re_model_template.h:10753):
            # sqrt diag (X' Psi^-1 X)^-1
            t = engine.transform_pars(res.cov_pars)
            with torch.no_grad():
                Xd = engine._t(X)
                L = torch.linalg.cholesky(
                    engine.psi_tilde(engine._t(np.log(t[1:]))))
                XtPX = engine._host(Xd.T @ torch.cholesky_solve(Xd, L))[0] \
                    / t[0]
            res.std_dev_coef = np.sqrt(np.diagonal(np.linalg.inv(XtPX)))
    return res


def _est_mask(engine, config):
    m = np.ones(engine.num_cov_par, dtype=bool)
    if config.estimate_cov_par_index is not None:
        m = np.asarray(config.estimate_cov_par_index) > 0
    return m


class CovariateHandler:
    """Covariate scaling, intercept detection and initialisation, and the
    coefficient learning-rate cap (re_model_template.h:1206-1278, :5393
    MaximalLearningRateCoef)."""

    def __init__(self, X, scale):
        self.X_orig = np.asarray(X, dtype=np.float64)
        n, k = self.X_orig.shape
        self.k = k
        self.intercept_col = None
        for icol in range(k):
            if np.all(self.X_orig[:, icol] == self.X_orig[0, icol]):
                self.intercept_col = icol
                break
        self.scale = scale and not (self.intercept_col is not None and k == 1)
        if self.scale:
            self.loc = np.zeros(k)
            self.sd = np.ones(k)
            self.X = self.X_orig.copy()
            for icol in range(k):
                if icol == self.intercept_col:
                    continue
                self.loc[icol] = self.X_orig[:, icol].mean()
                centered = self.X_orig[:, icol] - self.loc[icol]
                self.sd[icol] = np.sqrt(np.mean(centered ** 2))
                self.X[:, icol] = centered / self.sd[icol]
        else:
            self.X = self.X_orig

    def init_beta(self, y, likelihood=None, tot_var=None, F=None):
        """Zero, but the intercept: the response mean, or for a
        non-Gaussian likelihood its data-driven intercept
        (likelihoods.h:1435)."""
        beta = np.zeros(self.k)
        if self.intercept_col is not None:
            c = float(np.mean(y)) if likelihood is None \
                else likelihood.init_intercept(y, tot_var, F)
            beta[self.intercept_col] = c / self.X_orig[0, self.intercept_col]
        return beta

    def back_transform(self, beta):
        """Scaled-X coefficients -> original-X coefficients."""
        if not self.scale:
            return beta
        out = beta.copy()
        shift = 0.0
        for icol in range(self.k):
            if icol == self.intercept_col:
                continue
            out[icol] = beta[icol] / self.sd[icol]
            shift += self.loc[icol] * out[icol]
        if self.intercept_col is not None:
            out[self.intercept_col] = beta[self.intercept_col] \
                - shift / self.X_orig[0, self.intercept_col]
        return out

    def max_lr(self, beta, neg_step, C_mu, C_sigma2):
        lp_change = self.X @ neg_step
        lp_lag1 = self.X @ beta
        mean_c = lp_change.mean()
        var_c = np.mean(lp_change ** 2) - mean_c ** 2
        cov_lc = np.mean(lp_change * lp_lag1) - mean_c * lp_lag1.mean()
        out = np.inf
        if abs(mean_c) > 0:
            out = C_mu * C_MAX_CHANGE_COEF / abs(mean_c)
        if var_c > 0:
            max_lr_var = (abs(cov_lc) + np.sqrt(
                cov_lc * cov_lc + 4 * var_c * C_sigma2 * C_MAX_CHANGE_COEF)) \
                / 2.0 / var_c
            out = min(out, max_lr_var)
        return out


def _max_iter(config):
    return config.maxit if config.maxit else config.max_iter


def _optimize_internal(engine, y, config: OptimConfig, X=None) -> OptimResult:
    n = engine.n
    opt = config.optimizer_cov
    profile_out = opt == "gradient_descent"
    est = _est_mask(engine, config)
    est_theta = est[1:]
    use_nesterov = config.use_nesterov_acc and opt == "gradient_descent"
    delta_rel_conv = config.resolved_delta_rel_conv()
    has_covariates = X is not None
    handler = None
    C_mu = C_sigma2 = 1.0
    beta = beta_after_grad = beta_after_grad_lag1 = None
    Xd = None
    if has_covariates:
        y_host = y.detach().to(torch.float64).cpu().numpy()
        handler = CovariateHandler(
            X, scale=(config.optimizer_coef == "gradient_descent"))
        Xd = engine._t(handler.X)
        C_mu = abs(float(np.mean(y_host)))
        C_sigma2 = float(np.var(y_host))
        beta = (handler.init_beta(y_host)
                if config.optimizer_coef == "gradient_descent"
                else np.zeros(handler.k))
        beta_after_grad = beta.copy()
        beta_after_grad_lag1 = beta.copy()
    lr_coef = config.lr_coef

    t = engine.transform_pars(np.asarray(config.init_cov_pars,
                                         dtype=np.float64))
    u = np.log(t)                   # [log s2, log v~, log alpha ...]
    resid = y - Xd @ engine._t(beta) if has_covariates else y
    nll, quad = engine.nll_parts(u[1:], math.exp(u[0]), resid)

    lr_cov = config.resolved_lr_cov()
    theta_after_grad = np.exp(u[1:]).copy()
    theta_after_grad_lag1 = np.exp(u[1:]).copy()
    max_iter = _max_iter(config)
    num_it = max_iter
    converged = False

    for it in range(max_iter):
        nll_lag1 = nll
        u_lag1 = u.copy()

        # ---- regression coefficients ----------------------------------
        if has_covariates:
            if config.optimizer_coef == "wls":
                beta = engine.wls_coef(u[1:], y, Xd)
                resid = y - Xd @ engine._t(beta)
                nll_after_coef, quad = engine.nll_parts(
                    u[1:], math.exp(u[0]), resid)
            elif config.optimizer_coef == "gradient_descent":
                beta, resid, nll_after_coef, quad, lr_coef, beta_after_grad, \
                    beta_after_grad_lag1 = _update_coef_gd(
                        engine, y, Xd, beta, u, lr_coef, it, config,
                        nll_lag1, beta_after_grad, beta_after_grad_lag1,
                        handler, C_mu, C_sigma2)
            else:
                raise ValueError(f"optimizer_coef '{config.optimizer_coef}'")
        else:
            nll_after_coef = nll_lag1

        # ---- profile out the nugget (gradient_descent): quad is
        # sigma2-free, so sigma2_hat = quad / n
        if profile_out and est[0]:
            u[0] = np.log(quad / n)
            u = np.log(engine.apply_nugget_lower_bound(np.exp(u)))
        sigma2 = np.exp(u[0])

        # ---- gradient / step direction ---------------------------------
        if opt == "gradient_descent":
            _, g = engine.grad_profiled(u[1:], sigma2, resid)
            g = np.array(g)
            g[~est_theta] = 0.0
            neg_step = g
            # AvoidTooLargeLearningRatesCovAuxPars (permanent cap)
            max_abs = np.max(np.abs(neg_step)) if neg_step.size else 0.0
            if max_abs > 0:
                lr_cov = min(lr_cov, MAX_GRADIENT_UPDATE_LOG_SCALE / max_abs)
            grad_for_armijo = g
        elif opt == "fisher_scoring":
            _, g_full = engine.vag_full(u, resid)
            FI = engine.fisher_transformed(u, True)
            neg_step = np.linalg.solve(FI, g_full)
            grad_for_armijo = g_full
        else:   # newton
            _, g_full = engine.vag_full(u, resid)
            H = engine.hess_full(u, resid)
            try:
                neg_step = np.linalg.solve(H, g_full)
            except np.linalg.LinAlgError:
                neg_step = g_full
            grad_for_armijo = g_full

        dir_deriv = -float(grad_for_armijo @ neg_step)
        if use_nesterov:
            mom_dir_deriv = float(grad_for_armijo
                                  @ (u[1:] - np.log(theta_after_grad)))
        else:
            mom_dir_deriv = 0.0

        # ---- update with learning-rate backtracking --------------------
        lr = lr_cov
        acc_rate = config.acc_rate_cov
        halving_done = False
        for _ in range(MAX_NUM_LR_SHRINKAGE_STEPS):
            step = lr * neg_step
            if opt in ("fisher_scoring", "newton"):
                step = np.clip(step, -MAX_GRADIENT_UPDATE_LOG_SCALE,
                               MAX_GRADIENT_UPDATE_LOG_SCALE)
                u_cand = u - np.where(est, step, 0.0)
                theta_grad_cand = np.exp(u_cand[1:])
                theta_cand = theta_grad_cand
                u0_cand = u_cand[0]
            else:
                theta_grad_cand = np.exp(u[1:] - np.where(est_theta, step,
                                                          0.0))
                u0_cand = u[0]
                if use_nesterov:
                    mu = nesterov_mu(it, config.nesterov_schedule_version,
                                     acc_rate, config.momentum_offset)
                    theta_cand = np.exp(
                        (1.0 + mu) * np.log(theta_grad_cand)
                        - mu * np.log(theta_after_grad_lag1))
                else:
                    theta_cand = theta_grad_cand
            cand_full = engine.apply_nugget_lower_bound(
                np.concatenate([[np.exp(u0_cand)], theta_cand]))
            nll_new, quad_new = engine.nll_parts(
                np.log(cand_full[1:]), cand_full[0], resid)
            mu = (nesterov_mu(it, config.nesterov_schedule_version, acc_rate,
                              config.momentum_offset) if use_nesterov
                  else 0.0)
            bound = (nll_after_coef + C_ARMIJO * lr * dir_deriv
                     + C_ARMIJO_MOM * mu * mom_dir_deriv)
            if nll_new <= bound:
                break
            halving_done = True
            lr *= LR_SHRINKAGE_FACTOR
            acc_rate *= 0.5
        if halving_done and opt == "gradient_descent":
            lr_cov = lr             # permanent decrease (:8757)

        theta_after_grad_lag1 = theta_grad_cand.copy()
        theta_after_grad = theta_grad_cand.copy()
        u = np.log(cand_full)
        nll = nll_new
        quad = quad_new

        # ---- convergence check -----------------------------------------
        if config.convergence_criterion == "relative_change_in_log_likelihood":
            if (nll_lag1 - nll) <= delta_rel_conv * max(abs(nll_lag1), 1.0):
                converged = True
        elif config.convergence_criterion == "relative_change_in_parameters":
            t_now, t_lag = np.exp(u), np.exp(u_lag1)
            if np.linalg.norm(t_now - t_lag) \
                    <= delta_rel_conv * np.linalg.norm(t_lag):
                converged = True
        else:
            raise ValueError(config.convergence_criterion)
        if not np.all(np.isfinite(u)) or not np.isfinite(nll):
            converged = True        # NA/Inf guard: stop
        if converged:
            num_it = it + 1
            break

    result = OptimResult(
        cov_pars=engine.back_transform_pars(np.exp(u)), num_it=num_it,
        neg_log_likelihood=nll, converged=converged, optimizer="internal")
    if has_covariates:
        result.coef = handler.back_transform(beta)
    return result


def _update_coef_gd(engine, y, Xd, beta, u, lr_coef, it, config,
                    nll_lag1, beta_after_grad, beta_after_grad_lag1,
                    handler, C_mu, C_sigma2):
    """One gradient-descent step for the linear coefficients
    (re_model_template.h:9106 UpdateLinCoef)."""
    sigma2 = np.exp(u[0])
    resid = y - Xd @ engine._t(beta)
    g_beta = engine.coef_grad(u[1:], sigma2, resid, Xd)
    # AvoidTooLargeLearningRateCoef (re_model_template.h:5393)
    lr_coef = min(lr_coef, handler.max_lr(beta, g_beta, C_mu, C_sigma2))
    dir_deriv = -float(g_beta @ g_beta)
    use_acc = config.use_nesterov_acc \
        and config.optimizer_coef == "gradient_descent"
    mom_dir_deriv = float(g_beta @ (beta - beta_after_grad)) if use_acc \
        else 0.0

    lr = lr_coef
    acc_rate = config.acc_rate_coef
    halving_done = False
    for _ in range(MAX_NUM_LR_SHRINKAGE_STEPS):
        beta_grad_new = beta - lr * g_beta
        if use_acc:
            mu = nesterov_mu(it, config.nesterov_schedule_version, acc_rate,
                             config.momentum_offset)
            beta_new = (1.0 + mu) * beta_grad_new - mu * beta_after_grad_lag1
        else:
            mu = 0.0
            beta_new = beta_grad_new
        resid_new = y - Xd @ engine._t(beta_new)
        nll_new, quad_new = engine.nll_parts(u[1:], sigma2, resid_new)
        bound = (nll_lag1 + C_ARMIJO * lr * dir_deriv
                 + C_ARMIJO_MOM * mu * mom_dir_deriv)
        if nll_new <= bound:
            break
        halving_done = True
        lr *= LR_SHRINKAGE_FACTOR
        acc_rate *= 0.5
    if halving_done:
        lr_coef = lr
    return (beta_new, resid_new, nll_new, quad_new, lr_coef,
            beta_grad_new, beta_grad_new.copy())


# ----------------------------------------------------------------------
def _use_device_lbfgs(engine, config, est, X):
    """The reference's dispatch (optimize.py:1077-1090)."""
    use_device = config.use_device_optimizer
    if use_device is None:
        use_device = engine.n >= DEVICE_OPTIMIZER_MIN_N
    return bool(use_device and config.optimizer_cov.startswith("lbfgs")
                and config.optimizer_cov != "lbfgs_not_profile_out_nugget"
                and est[0] and hasattr(engine, "nll_profiled_raw")
                and (X is None or hasattr(engine, "wls_coef_raw")))


def _optimize_external_device(engine, y, config: OptimConfig, X, est):
    """The whole L-BFGS fit on the device (ops/lbfgs.py): the profiled
    objective, with the closed-form GLS coefficients when X is given, and
    one host read per line-search trial."""
    from ..ops.lbfgs import lbfgs_run

    n = engine.n
    est_theta = est[1:]
    Xd = None if X is None else engine._t(X)
    t0 = engine.transform_pars(np.asarray(config.init_cov_pars,
                                          dtype=np.float64))
    theta0 = np.log(t0[1:])
    free_idx = np.where(est_theta)[0]
    theta0_d = engine._t(theta0)
    free_d = torch.as_tensor(free_idx, device=engine.device)
    partial = len(free_idx) < len(theta0)

    def vag(x):
        x = x.detach().requires_grad_(True)
        theta = theta0_d.index_put((free_d,), x) if partial else x
        if Xd is not None:
            beta = engine.wls_coef_raw(theta, y, Xd)
            resid = y - Xd @ beta
        else:
            beta = y.new_zeros((0,))
            resid = y
        val, quad = engine.nll_profiled_raw(theta, resid)
        (g,) = torch.autograd.grad(val, x)
        # quad and beta ride along as aux: the final state needs no extra
        # evaluation after the run
        return val.detach(), g, (quad.detach(), beta.detach())

    max_iter = config.maxit if config.maxit else min(config.max_iter, 1000)
    # stop at the configured relative change of the objective (LBFGSpp's
    # delta = delta_rel_conv, optim_utils.h:653-674)
    ftol = config.resolved_delta_rel_conv()
    x, nll, (quad, beta), k, _ = lbfgs_run(vag, theta0_d[free_d], max_iter,
                                           ftol=ftol, has_aux=True)
    x, nll, quad, beta = engine._host(x, nll, quad, beta)
    theta = theta0.copy()
    theta[free_idx] = x
    internal = engine.apply_nugget_lower_bound(
        np.concatenate([[float(quad) / n], np.exp(theta)]))
    return OptimResult(
        cov_pars=engine.back_transform_pars(internal), num_it=int(k),
        neg_log_likelihood=float(nll), converged=True,
        coef=beta if X is not None else None, optimizer="device_lbfgs")


ADAM_LR, ADAM_B1, ADAM_B2, ADAM_EPS = 1e-2, 0.9, 0.999, 1e-8


def _adam(obj, x0, num_steps, drc):
    """Adam as the reference runs it (optax.adam(1e-2), optimize.py:777-791,
    :1145-1160), by hand in float64 and in optax's order of operations:
    the moments m = (1 - b1) g + b1 m and v = (1 - b2) g^2 + b2 v, their
    bias corrections by 1 - b^k, the step -lr m^ / (sqrt(v^) + eps). It
    stops when the objective's change from the step before is at most
    drc max(|f_prev|, 1) after step 51. Returns (x, the number of steps
    when it stopped, None when it ran all num_steps)."""
    x = np.array(x0, dtype=np.float64)
    m, v = np.zeros_like(x), np.zeros_like(x)
    f_prev = np.inf
    for i in range(num_steps):
        f, g = obj(x)
        m = (1 - ADAM_B1) * g + ADAM_B1 * m
        v = (1 - ADAM_B2) * g ** 2 + ADAM_B2 * v
        m_hat = m / (1 - ADAM_B1 ** (i + 1))
        v_hat = v / (1 - ADAM_B2 ** (i + 1))
        x = x + -ADAM_LR * (m_hat / (np.sqrt(v_hat) + ADAM_EPS))
        if abs(f_prev - f) <= drc * max(abs(f_prev), 1.0) and i > 50:
            return x, i + 1
        f_prev = f
    return x, None


def _optimize_external(engine, y, config: OptimConfig, X=None) -> OptimResult:
    """L-BFGS-B, Nelder-Mead or adam on the profiled objective
    (optim_utils.h:562), or the device L-BFGS where the reference takes
    it."""
    from scipy import optimize as sopt

    n = engine.n
    est = _est_mask(engine, config)
    if _use_device_lbfgs(engine, config, est, X):
        return _optimize_external_device(engine, y, config, X, est)
    est_theta = est[1:]
    has_covariates = X is not None
    Xd = engine._t(X) if has_covariates else None

    t0 = engine.transform_pars(np.asarray(config.init_cov_pars,
                                          dtype=np.float64))
    theta0 = np.log(t0[1:])
    s2_fixed = math.exp(math.log(t0[0]))
    profile_sigma2 = bool(est[0])

    def resid_at(theta):
        if not has_covariates:
            return y, None
        beta = engine.wls_coef(theta, y, Xd)
        return y - Xd @ engine._t(beta), beta

    def obj_and_grad(theta_free):
        theta = theta0.copy()
        theta[est_theta] = theta_free
        r, _ = resid_at(theta)
        if profile_sigma2:
            (val, _), grad = engine.nll_profiled_vag(theta, r)
        else:
            val, grad = engine.grad_profiled(theta, s2_fixed, r)
        return float(val), np.asarray(grad)[est_theta]

    x0 = theta0[est_theta]
    opt = config.optimizer_cov
    max_iter = _max_iter(config)
    if x0.size == 0:
        res_x, nit = x0, 0
    elif opt == "nelder_mead":
        drc = config.resolved_delta_rel_conv()
        f0 = obj_and_grad(x0)[0]
        r = sopt.minimize(lambda x: obj_and_grad(x)[0], x0,
                          method="Nelder-Mead",
                          options={"maxiter": max_iter * 10,
                                   "fatol": drc * max(abs(f0), 1.0),
                                   "xatol": 1e-12})
        res_x, nit = r.x, r.nit
    elif opt == "adam":
        res_x, nit = _adam(obj_and_grad, x0, max_iter * 10,
                           config.resolved_delta_rel_conv())
        nit = max_iter * 10 if nit is None else nit
    else:
        r = sopt.minimize(obj_and_grad, x0, jac=True, method="L-BFGS-B",
                          options={"maxiter": max_iter, "ftol": 1e-16,
                                   "gtol": 1e-12, "maxcor": 20})
        res_x, nit = r.x, r.nit

    theta = theta0.copy()
    theta[est_theta] = res_x
    r, beta = resid_at(theta)
    if profile_sigma2:
        # the profiled objective returns quad: sigma2_hat = quad / n, and
        # the NLL at (theta, sigma2_hat) equals the profiled value
        (nll, quad), _ = engine.nll_profiled_vag(theta, r)
        sigma2 = quad / n
    else:
        nll, _ = engine.grad_profiled(theta, s2_fixed, r)
        sigma2 = s2_fixed
    internal = engine.apply_nugget_lower_bound(
        np.concatenate([[sigma2], np.exp(theta)]))
    cov_pars_out = engine.back_transform_pars(internal)
    # fixed variances are reported at their original-scale values although
    # the nugget-scaled coordinate was held fixed (re_model_template.h:7836
    # MaybeKeepVarianceConstant)
    if config.estimate_cov_par_index is not None and est[0]:
        variance_idx = np.asarray([1 + off for off in engine.par_offsets])
        fixed_var = variance_idx[~est[variance_idx]]
        init_orig = np.asarray(config.init_cov_pars, dtype=np.float64)
        cov_pars_out[fixed_var] = init_orig[fixed_var]
    return OptimResult(
        cov_pars=cov_pars_out, num_it=int(nit), neg_log_likelihood=float(nll),
        converged=True, coef=beta, optimizer="scipy")


# ----------------------------------------------------------------------
# non-Gaussian likelihoods: the Laplace engines (optimize.py:467-937 of the
# reference, OptimLinRegrCoefCovPar's non-Gaussian branch)
def optimize_laplace(engine, y, config: OptimConfig, X=None,
                     offset=None) -> OptimResult:
    """Estimate covariance parameters, aux parameters and, with X, the
    linear coefficients by the Laplace approximation; y and X float64
    numpy in data order, offset the fixed effects F."""
    opt = config.optimizer_cov
    if opt == "gradient_descent":
        if getattr(engine, "num_sets_fe", 1) == 2:
            raise ValueError(
                "optimizer_cov='gradient_descent' is not supported for "
                "two-predictor likelihoods; use 'lbfgs' (the default)")
        return _optimize_laplace_gd(engine, y, config, X, offset)
    if opt in ("lbfgs", "lbfgs_linesearch_nocedal_wright", "nelder_mead",
               "adam", "bfgs_optim_lib"):
        use_device = config.use_device_optimizer
        if use_device is None:
            # auto-enabled only for engines validated with the device
            # L-BFGS (device_opt_auto); True forces it for any engine
            use_device = (engine.n >= DEVICE_OPTIMIZER_MIN_N
                          and getattr(engine, "device_opt_auto", False))
        if use_device and opt.startswith("lbfgs"):
            return _optimize_laplace_device(engine, y, config, X, offset)
        return _optimize_laplace_external(engine, y, config, X, offset)
    if opt in ("fisher_scoring", "newton"):
        raise ValueError(f"optimizer_cov '{opt}' is not supported for "
                         "non-Gaussian likelihoods")
    raise ValueError(f"optimizer_cov '{opt}' is not supported")


def _laplace_u0(engine, y, config):
    """Initial internal vector [log transformed cov pars, log aux]."""
    t = engine.transform_pars(np.asarray(config.init_cov_pars,
                                         dtype=np.float64))
    u = np.log(t)
    if engine.num_aux:
        if config.init_aux_pars is not None:
            aux0 = engine.likelihood.aux_to_internal(
                np.asarray(config.init_aux_pars, dtype=np.float64))
        else:
            aux0 = engine.likelihood.init_aux(np.asarray(y))
        u = np.concatenate([u, np.log(aux0)])
    return u


def _laplace_est_mask(engine, config):
    est = np.ones(engine.num_par, dtype=bool)
    if config.estimate_cov_par_index is not None:
        idx = np.asarray(config.estimate_cov_par_index)
        est[:engine.num_theta] = idx > 0
    if engine.num_aux and not config.estimate_aux_pars:
        est[engine.num_theta:] = False
    return est


def _laplace_offsets(engine, offset):
    """The offsets as F of length n * num_sets_fe (an offset of length n
    for a two-predictor likelihood is the first block's)."""
    n, K = engine.n, engine.num_sets_fe
    if offset is None:
        return np.zeros(n * K)
    offs = np.asarray(offset, dtype=np.float64)
    if K == 2 and len(offs) == n:
        offs = np.concatenate([offs, np.zeros(n)])
    return offs


def _laplace_covariates(engine, y, config, X, offs, scale):
    """(handler, initial beta) for X, or (None, None); with two predictor
    sets beta stacks one coefficient vector per set, the second set's
    intercept from init_intercept2 (FindInitialIntercept ind_set_re = 1)."""
    if X is None:
        return None, None
    handler = CovariateHandler(X, scale=scale)
    tot_var = float(np.sum(np.asarray(config.init_cov_pars)[
        list(engine.par_offsets)]))
    lik = engine.likelihood
    beta = handler.init_beta(np.asarray(y), lik, tot_var,
                             None if offs is None else offs[:engine.n])
    if engine.num_sets_fe == 2:
        beta2 = np.zeros(handler.k)
        ic = handler.intercept_col
        if ic is not None and hasattr(lik, "init_intercept2"):
            beta2[ic] = lik.init_intercept2(np.asarray(y), tot_var, offs) \
                / handler.X_orig[0, ic]
        beta = np.concatenate([beta, beta2])
    return handler, beta


def _fixed_effects(X, beta, K):
    """X beta per predictor set, stacked (numpy or torch)."""
    if K == 1:
        return X @ beta
    k = X.shape[1]
    parts = [X @ beta[:k], X @ beta[k:]]
    return torch.cat(parts) if torch.is_tensor(X) else np.concatenate(parts)


def _coef_grad(X, gF, K):
    """X' g_F per predictor set, stacked."""
    if K == 1:
        return X.T @ gF
    n = X.shape[0]
    return np.concatenate([X.T @ gF[:n], X.T @ gF[n:]])


def _back_transform(handler, beta, K):
    if K == 1:
        return handler.back_transform(beta)
    k = handler.k
    return np.concatenate([handler.back_transform(beta[:k]),
                           handler.back_transform(beta[k:])])


def _laplace_result(engine, u, nll, num_it, converged, beta, a_state,
                    optimizer):
    p_cov = engine.num_theta
    return OptimResult(
        cov_pars=engine.back_transform_pars(np.exp(u[:p_cov])),
        num_it=int(num_it), neg_log_likelihood=float(nll),
        converged=bool(converged), coef=beta, optimizer=optimizer,
        aux_pars=(engine.likelihood.aux_from_internal(np.exp(u[p_cov:]))
                  if engine.num_aux else None),
        mode_state=a_state)


def _optimize_laplace_gd(engine, y, config: OptimConfig, X=None,
                         offset=None):
    """Gradient descent, with or without Nesterov acceleration, on the log
    parameters with separate learning rates for the covariance and aux
    parameters, and gradient steps for the coefficients (the reference's
    _optimize_laplace_gd, line for line)."""
    n = engine.n
    est = _laplace_est_mask(engine, config)
    p_cov = engine.num_theta
    use_nesterov = config.use_nesterov_acc
    delta_rel_conv = config.resolved_delta_rel_conv()
    yd = engine.prep_y(y)
    has_covariates = X is not None
    offs = np.zeros(n) if offset is None \
        else np.asarray(offset, dtype=np.float64)
    u = _laplace_u0(engine, y, config)
    handler, beta = _laplace_covariates(
        engine, y, config, X, None if offset is None else offs, True)
    C_mu = C_sigma2 = 1.0
    if has_covariates:
        X = handler.X
        C_mu, C_sigma2 = engine.likelihood.cap_constants(np.asarray(y), offs)
    beta_after_grad = beta.copy() if has_covariates else None
    beta_after_grad_lag1 = beta.copy() if has_covariates else None
    lr_coef = config.lr_coef

    def F_of(beta_):
        F = offs.copy()
        if has_covariates and beta_ is not None:
            F = F + X @ beta_
        return engine._t(F)

    a_state = engine.zero_mode()
    nll, a_state = engine.laplace_nll(u, yd, F_of(beta), a_state)
    lr_cov = config.resolved_lr_cov()
    lr_aux = lr_cov
    pars_after_grad = np.exp(u).copy()
    pars_after_grad_lag1 = np.exp(u).copy()
    max_iter = _max_iter(config)
    num_it = max_iter
    converged = False

    for it in range(max_iter):
        nll_lag1 = nll
        u_lag1 = u.copy()

        # ---- coefficient gradient-descent step --------------------------
        if has_covariates:
            _, _, gF, _ = engine.laplace_vag_F(u, yd, F_of(beta), a_state)
            g_beta = X.T @ gF
            lr_coef = min(lr_coef, handler.max_lr(beta, g_beta, C_mu,
                                                  C_sigma2))
            dird_b = -float(g_beta @ g_beta)
            mom_b = float(g_beta @ (beta - beta_after_grad)) \
                if use_nesterov else 0.0
            lr_b = lr_coef
            acc_b = config.acc_rate_coef
            halved = False
            for _ in range(MAX_NUM_LR_SHRINKAGE_STEPS):
                beta_grad_new = beta - lr_b * g_beta
                mu = (nesterov_mu(it, config.nesterov_schedule_version,
                                  acc_b, config.momentum_offset)
                      if use_nesterov else 0.0)
                beta_new = (1.0 + mu) * beta_grad_new \
                    - mu * beta_after_grad_lag1
                nll_new_b, a_cand = engine.laplace_nll(
                    u, yd, F_of(beta_new), a_state)
                if nll_new_b <= (nll_lag1 + C_ARMIJO * lr_b * dird_b
                                 + C_ARMIJO_MOM * mu * mom_b):
                    break
                halved = True
                lr_b *= LR_SHRINKAGE_FACTOR
                acc_b *= 0.5
            if halved:
                lr_coef = lr_b
            beta = beta_new
            beta_after_grad = beta_grad_new
            beta_after_grad_lag1 = beta_grad_new.copy()
            a_state = a_cand
            nll_after_coef = nll_new_b
        else:
            nll_after_coef = nll_lag1
        Fd = F_of(beta)

        # ---- covariance / aux parameter step ---------------------------
        g, a_state = engine.laplace_grad(u, yd, Fd, a_state)
        g = np.array(g)
        g[~est] = 0.0
        g_cov, g_aux = g[:p_cov], g[p_cov:]
        if np.max(np.abs(g_cov), initial=0.0) > 0:
            lr_cov = min(lr_cov, MAX_GRADIENT_UPDATE_LOG_SCALE
                         / np.max(np.abs(g_cov)))
        if g_aux.size and np.max(np.abs(g_aux), initial=0.0) > 0:
            lr_aux = min(lr_aux, MAX_GRADIENT_UPDATE_LOG_SCALE
                         / np.max(np.abs(g_aux)))
        dir_cov = -float(g_cov @ g_cov)
        dir_aux = -float(g_aux @ g_aux) if g_aux.size else 0.0
        if use_nesterov:
            delta_log = u - np.log(pars_after_grad)
            mom_cov = float(g_cov @ delta_log[:p_cov])
            mom_aux = float(g_aux @ delta_log[p_cov:]) if g_aux.size else 0.0
        else:
            mom_cov = mom_aux = 0.0

        lrc, lra = lr_cov, lr_aux
        acc_rate = config.acc_rate_cov
        halving_done = False
        for _ in range(MAX_NUM_LR_SHRINKAGE_STEPS):
            step = np.concatenate([lrc * g_cov, lra * g_aux])
            u_grad_new = u - np.where(est, step, 0.0)
            if use_nesterov:
                mu = nesterov_mu(it, config.nesterov_schedule_version,
                                 acc_rate, config.momentum_offset)
                u_cand = (1.0 + mu) * u_grad_new \
                    - mu * np.log(pars_after_grad_lag1)
            else:
                mu = 0.0
                u_cand = u_grad_new
            nll_new, a_cand = engine.laplace_nll(u_cand, yd, Fd, a_state)
            ok = nll_new <= (nll_after_coef + C_ARMIJO * lrc * dir_cov
                             + C_ARMIJO_MOM * mu * mom_cov)
            if g_aux.size:
                ok = ok and nll_new <= (nll_after_coef
                                        + C_ARMIJO * lra * dir_aux
                                        + C_ARMIJO_MOM * mu * mom_aux)
            if ok:
                break
            halving_done = True
            lrc *= LR_SHRINKAGE_FACTOR
            lra *= LR_SHRINKAGE_FACTOR
            acc_rate *= 0.5
        if halving_done:
            lr_cov, lr_aux = lrc, lra
        pars_after_grad_lag1 = np.exp(u_grad_new).copy()
        pars_after_grad = np.exp(u_grad_new).copy()
        u = u_cand
        nll = nll_new
        a_state = a_cand

        # ---- convergence ------------------------------------------------
        if config.convergence_criterion == \
                "relative_change_in_log_likelihood":
            if (nll_lag1 - nll) <= delta_rel_conv * max(abs(nll_lag1), 1.0):
                converged = True
        elif config.convergence_criterion == "relative_change_in_parameters":
            t_now, t_lag = np.exp(u), np.exp(u_lag1)
            if np.linalg.norm(t_now - t_lag) \
                    <= delta_rel_conv * np.linalg.norm(t_lag):
                converged = True
        if not np.all(np.isfinite(u)) or not np.isfinite(nll):
            converged = True
        if converged:
            num_it = it + 1
            break

    beta_out = handler.back_transform(beta) if has_covariates else None
    return _laplace_result(engine, u, nll, num_it, converged, beta_out,
                           a_state, "internal")


def _optimize_laplace_external(engine, y, config: OptimConfig, X=None,
                               offset=None):
    """scipy L-BFGS-B (or Nelder-Mead) on the host, the mode warm-started
    across evaluations; a non-finite evaluation keeps the previous mode and
    returns a large value so that the line search backs off
    (ResetLaplaceApproxModeToPreviousValue, re_model_template.h:2593)."""
    from scipy import optimize as sopt

    est = _laplace_est_mask(engine, config)
    yd = engine.prep_y(y)
    has_covariates = X is not None
    K = engine.num_sets_fe
    offs = _laplace_offsets(engine, offset)
    u0 = _laplace_u0(engine, y, config)
    handler, beta0 = _laplace_covariates(
        engine, y, config, X, None if offset is None else offs,
        config.optimizer_cov in ("lbfgs", "bfgs_optim_lib",
                                 "lbfgs_linesearch_nocedal_wright"))
    if has_covariates:
        X = handler.X

    def F_of(beta):
        return offs if not has_covariates \
            else offs + _fixed_effects(X, beta, K)

    state = {"a": engine.zero_mode()}
    ne = int(est.sum())

    def unpack(x):
        u = u0.copy()
        u[est] = x[:ne]
        return u, (x[ne:] if has_covariates else None)

    def obj(x):
        u, beta = unpack(x)
        F = F_of(beta)
        if has_covariates:
            nll, gu, gF, a = engine.laplace_vag_F(u, yd, F, state["a"])
            g = np.concatenate([gu[est], _coef_grad(X, gF, K)])
        else:
            nll, gu, a = engine.laplace_vag(u, yd, F, state["a"])
            g = gu[est]
        if not (np.isfinite(nll) and np.all(np.isfinite(g))):
            return 1e12, np.zeros_like(g)
        state["a"] = a
        return nll, g

    x0 = u0[est]
    if has_covariates:
        x0 = np.concatenate([x0, beta0])
    max_iter = _max_iter(config)
    if config.optimizer_cov == "nelder_mead":
        r = sopt.minimize(lambda x: obj(x)[0], x0, method="Nelder-Mead",
                          options={"maxiter": max_iter * 10, "xatol": 1e-10,
                                   "fatol": config.resolved_delta_rel_conv()})
        x, nit = r.x, r.nit
    elif config.optimizer_cov == "adam":
        x, nit = _adam(obj, x0, max_iter * 10,
                       config.resolved_delta_rel_conv())
        nit = max_iter * 10 if nit is None else nit
    else:
        r = sopt.minimize(obj, x0, jac=True, method="L-BFGS-B",
                          options={"maxiter": max_iter, "ftol": 1e-16,
                                   "gtol": 1e-10, "maxcor": 20})
        x, nit = r.x, r.nit
    u, beta = unpack(x)
    nll, a = engine.laplace_nll(u, yd, F_of(beta), state["a"])
    beta_out = _back_transform(handler, beta, K) if has_covariates else None
    return _laplace_result(engine, u, nll, nit, True, beta_out, a,
                           "scipy")


def _optimize_laplace_device(engine, y, config: OptimConfig, X=None,
                             offset=None):
    """The Laplace L-BFGS fit with its state on the device
    (ops/lbfgs.py `lbfgs_run_state`): the implicit-function NLL with its
    Newton mode finder inside the state-threaded L-BFGS, the mode
    warm-started across every evaluation, stopping at the relative change
    delta_rel_conv (LBFGSpp's delta, optim_utils.h:653-674)."""
    from ..ops.lbfgs import lbfgs_run_state

    est = _laplace_est_mask(engine, config)
    yd = engine.prep_y(y)
    has_covariates = X is not None
    K = engine.num_sets_fe
    offs = _laplace_offsets(engine, offset)
    u0 = _laplace_u0(engine, y, config)
    handler, beta0 = _laplace_covariates(
        engine, y, config, X, None if offset is None else offs, True)
    est_idx = np.where(est)[0]
    ne = len(est_idx)
    u0_d = engine._t(u0)
    est_d = torch.as_tensor(est_idx, device=engine.device)
    offs_d = engine._t(offs)
    Xd = engine._t(handler.X) if has_covariates else None

    def vag(x, st):
        x = x.detach().requires_grad_(True)
        u = u0_d.index_put((est_d,), x[:ne])
        F = offs_d + _fixed_effects(Xd, x[ne:], K) if has_covariates \
            else offs_d
        nll, (b, _) = engine._nll_raw(u, F, yd, st)
        (g,) = torch.autograd.grad(nll, x)
        return nll.detach(), g, b

    x0 = u0[est_idx]
    if has_covariates:
        x0 = np.concatenate([x0, beta0])
    max_iter = config.maxit if config.maxit else min(config.max_iter, 1000)
    x, _, b_state, nit, conv = lbfgs_run_state(
        vag, engine._t(x0), engine.zero_mode(), max_iter,
        ftol=config.resolved_delta_rel_conv())
    x = engine._host(x)[0]
    u = u0.copy()
    u[est_idx] = x[:ne]
    beta = x[ne:] if has_covariates else None
    F = offs if not has_covariates \
        else offs + _fixed_effects(handler.X, beta, K)
    nll, a = engine.laplace_nll(u, yd, F, b_state)
    beta_out = _back_transform(handler, beta, K) if has_covariates else None
    return _laplace_result(engine, u, nll, nit, conv, beta_out, a,
                           "device_lbfgs")
