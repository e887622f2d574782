"""Warm-started gradient descent for the per-round covariance refits of the
GPBoost algorithm (counterpart of gpboost_tpu/models/jit_gd.py).

Nesterov-accelerated GD on the log-transformed parameters with the nugget
profiled out, Armijo backtracking with permanent learning-rate halving, and
relative-NLL convergence: the reference's `make_jitted_gd` (jit_gd.py:49-115)
step for step. There the two nested `lax.while_loop`s run inside one
compiled program; here they are Python loops on the host. The parameter
vector (a handful of numbers) lives on the host in float64, and every NLL
or gradient evaluation runs on the engine's device:

    host syncs per refit = 1 (initial NLL)
                         + per GD iteration: 1 (gradient) + 1 per Armijo trial.

Removing them (CUDA graphs, device-side control) is later work.
`gd_fit_laplace_engine` is the same loop for the Laplace engines' covariance
and aux parameters at fixed effects F (LaGaBoost's per-round refit).
"""

import math

import numpy as np

LR_SHRINK = 0.5
C_ARMIJO = 1e-4
C_ARMIJO_MOM = 1e-4
MAX_SHRINK_STEPS = 30
MAX_LOG_STEP = math.log(100.0)


def gd_fit_engine(engine, cov_pars_init, y, lr0=0.1, max_iter=50, delta=1e-6):
    """Run the GD loop on a Gaussian engine from original-scale parameters;
    y in data order (numpy or tensor). Returns (cov_pars_orig, nll, lr,
    n_it)."""
    t = engine.transform_pars(np.asarray(cov_pars_init, dtype=np.float64))
    u, nll, lr, it = gd_fit(engine, np.log(t), engine.prep_y(y), float(lr0),
                            int(max_iter), float(delta))
    return engine.back_transform_pars(np.exp(u)), nll, lr, it


def gd_fit(engine, u0, y, lr0, max_iter, delta, momentum_offset=2,
           acc_rate0=0.5):
    """u = log([sigma2, theta...]) on the engine's transformed scale; y in
    the engine's ordering. Returns (u, nll, lr, n_it)."""
    n = engine.n
    u = np.asarray(u0, dtype=np.float64)
    nll, quad = engine.nll_parts(u[1:], math.exp(u[0]), y)
    lr = lr0
    th_ag_lag1 = u[1:].copy()
    it = 0
    done = False
    while not done and it < max_iter:
        sigma2 = quad / n                       # ProfileOutSigma2
        g = engine.nll_grad(u[1:], sigma2, y)
        max_abs = float(np.max(np.abs(g)))
        lr = min(lr, MAX_LOG_STEP / max(max_abs, 1e-300))
        dir_deriv = -float(g @ g)
        mom_dd = float(g @ (u[1:] - th_ag_lag1))
        lr_l, acc_r = lr, acc_rate0
        nll_new, quad_new = nll, quad
        th_grad = th_acc = np.zeros_like(g)
        for _ in range(MAX_SHRINK_STEPS):
            th_grad = u[1:] - lr_l * g
            mu = acc_r if it >= momentum_offset else 0.0
            th_acc = (1.0 + mu) * th_grad - mu * th_ag_lag1
            nll_new, quad_new = engine.nll_parts(th_acc, sigma2, y)
            bound = nll + C_ARMIJO * lr_l * dir_deriv \
                + C_ARMIJO_MOM * mu * mom_dd
            if nll_new <= bound and math.isfinite(nll_new):
                break
            lr_l *= LR_SHRINK
            acc_r *= 0.5
        conv = (nll - nll_new) <= delta * max(abs(nll), 1.0)
        done = conv or not math.isfinite(nll_new)
        u = np.concatenate([[math.log(sigma2)], th_acc])
        nll, quad, lr, th_ag_lag1 = nll_new, quad_new, lr_l, th_grad
        it += 1
    # final profiling of the nugget (the last update used the lagged one)
    u[0] = math.log(quad / n)
    return u, nll, lr, it


def gd_fit_laplace_engine(engine, cov_pars_init, aux_init, y, F, a_init,
                          lr0=0.1, max_iter=50, delta=1e-6, est_aux=True):
    """Warm-started Nesterov GD refit of a Laplace engine's covariance and
    aux parameters at fixed effects F (the reference's
    gd_fit_laplace_engine, jit_gd.py:118-221, used by every LaGaBoost round;
    regression_objective.hpp:175-183 OptimCovPar given F). The reference's
    two nested while_loops are host loops here; every evaluation runs on
    the engine's device, F and y stay device tensors:

        host syncs per refit = Newton steps of each evaluation
                               + 1 (initial NLL)
                               + per GD iteration: 1 (gradient)
                                 + 1 per Armijo trial.

    Aux coordinates are frozen when est_aux is False. Returns
    (cov_pars_orig, aux_pars, nll, lr, n_it, mode_state)."""
    u = np.log(engine.transform_pars(np.asarray(cov_pars_init,
                                                dtype=np.float64)))
    if engine.num_aux:
        aux_int = engine.likelihood.aux_to_internal(
            np.asarray(aux_init, dtype=np.float64))
        u = np.concatenate([u, np.log(aux_int)])
    mask = np.ones(len(u))
    if not est_aux:
        mask[engine.num_theta:] = 0.0
    Fd, yd = engine._F(F), engine.prep_y(y)
    nll, a = engine.laplace_nll(u, yd, Fd, a_init)
    lr, u_ag_lag1 = float(lr0), u.copy()
    it, done = 0, False
    while not done and it < max_iter:
        g, a_c = engine.laplace_grad(u, yd, Fd, a)
        g = g * mask
        lr = min(lr, MAX_LOG_STEP / max(float(np.max(np.abs(g))), 1e-300))
        dir_deriv = -float(g @ g)
        mom_dd = float(g @ (u - u_ag_lag1))
        lr_l, acc_r = lr, 0.5
        for _ in range(MAX_SHRINK_STEPS):
            u_grad = u - lr_l * g
            mu = acc_r if it >= 2 else 0.0
            u_acc = (1.0 + mu) * u_grad - mu * u_ag_lag1
            nll_new, a_new = engine.laplace_nll(u_acc, yd, Fd, a_c)
            bound = nll + C_ARMIJO * lr_l * dir_deriv \
                + C_ARMIJO_MOM * mu * mom_dd
            if nll_new <= bound and math.isfinite(nll_new):
                break
            lr_l *= LR_SHRINK
            acc_r *= 0.5
        conv = (nll - nll_new) <= delta * max(abs(nll), 1.0)
        done = conv or not math.isfinite(nll_new)
        u, nll, a, lr, u_ag_lag1 = u_acc, nll_new, a_new, lr_l, u_grad
        it += 1
    pars = engine.back_transform_pars(np.exp(u[:engine.num_theta]))
    aux = None
    if engine.num_aux:
        aux = engine.likelihood.aux_from_internal(
            np.exp(u[engine.num_theta:]))
    return pars, aux, float(nll), float(lr), it, a
