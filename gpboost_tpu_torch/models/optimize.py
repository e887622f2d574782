"""Covariance-parameter estimation (counterpart of
gpboost_tpu/models/optimize.py).

Ported: `OptimConfig`, `OptimResult` and `optimize_gaussian` through the
host scipy L-BFGS-B branch of the reference's `_optimize_external`
(optimize.py:1077-1206) on the nugget-profiled objective. That branch is
the reference's default `lbfgs` below n = 20,000; the port takes it at every
n, since the on-device L-BFGS (ops/lbfgs.py) is not ported yet. Each
objective evaluation is one value-and-gradient pass on the engine's device
and one host sync. The internal optimizers, Nelder-Mead, Adam, linear
covariates, fixed parameters and standard errors raise NotImplementedError.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class OptimConfig:
    """The fields of the reference's OptimConfig that its host L-BFGS-B
    branch reads; the others come with the optimizers that read them."""
    optimizer_cov: str = "lbfgs"
    max_iter: int = 1000
    maxit: Optional[int] = None     # alias used by reference tests for lbfgs
    init_cov_pars: Optional[np.ndarray] = None
    estimate_cov_par_index: Optional[list] = None
    std_dev: bool = False
    use_device_optimizer: Optional[bool] = None


@dataclass
class OptimResult:
    cov_pars: np.ndarray = None          # original scale
    num_it: int = 0
    neg_log_likelihood: float = np.nan
    converged: bool = False


_LBFGS_NAMES = ("lbfgs", "lbfgs_linesearch_nocedal_wright", "bfgs_optim_lib")


def optimize_gaussian(engine, y, config: OptimConfig, X=None) -> OptimResult:
    """Estimate covariance parameters for Gaussian y, given as a tensor in
    the engine's ordering, dtype and device."""
    unsupported = []
    if config.optimizer_cov not in _LBFGS_NAMES:
        unsupported.append(f"optimizer_cov='{config.optimizer_cov}'")
    if X is not None:
        unsupported.append("linear covariates X")
    if config.estimate_cov_par_index is not None:
        unsupported.append("estimate_cov_par_index")
    if config.std_dev:
        unsupported.append("std_dev=True")
    if config.use_device_optimizer:
        unsupported.append("use_device_optimizer=True")
    if unsupported:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(unsupported)
            + " (the port runs the host L-BFGS-B on the profiled NLL)")
    return _optimize_external(engine, y, config)


def _optimize_external(engine, y, config: OptimConfig) -> OptimResult:
    """L-BFGS-B on the nugget-profiled objective (optim_utils.h:562)."""
    from scipy import optimize as sopt

    n = engine.n
    t0 = engine.transform_pars(np.asarray(config.init_cov_pars,
                                          dtype=np.float64))
    theta0 = np.log(t0[1:])

    def obj_and_grad(theta):
        (val, _quad), grad = engine.nll_profiled_vag(theta, y)
        return val, grad

    max_iter = config.maxit if config.maxit else config.max_iter
    if theta0.size == 0:
        theta, nit = theta0, 0
    else:
        r = sopt.minimize(obj_and_grad, theta0, jac=True, method="L-BFGS-B",
                          options={"maxiter": max_iter, "ftol": 1e-16,
                                   "gtol": 1e-12, "maxcor": 20})
        theta, nit = r.x, r.nit
    # the profiled objective returns quad: sigma2_hat = quad / n, and the
    # NLL at (theta, sigma2_hat) equals the profiled value
    (nll, quad), _ = engine.nll_profiled_vag(theta, y)
    internal = np.concatenate([[quad / n], np.exp(theta)])
    internal = engine.apply_nugget_lower_bound(internal)
    return OptimResult(
        cov_pars=engine.back_transform_pars(internal),
        num_it=int(nit),
        neg_log_likelihood=float(nll),
        converged=True,
    )
