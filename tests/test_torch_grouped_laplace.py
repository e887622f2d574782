"""The grouped Laplace engine, the Laplace optimizers and the state-threaded
L-BFGS of the PyTorch port against the JAX package.

Data: ng_data of tests/test_non_gaussian_golden.py (n = 100, ten groups of
ten and a crossed grouping, the R suite's LCG). At fixed parameters and F:

  * the padded-by-group mode finder (one grouping) and the rows finder
    (two crossed groupings with a random slope: q x q Cholesky) agree with
    the JAX engine's: mode to 1e-8, NLL to rtol 1e-10, gradients in u and
    F to rtol 1e-8, and the same Newton step count; the two finders of the
    port agree with each other on one grouping to rtol 1e-10;
  * observation weights and cluster_ids, the same way.

Then TestPoisson's grouped, multiple-RE and linear-predictor goldens and
TestGamma's goldens on the port at that file's tolerances;
`lbfgs_run_state` against the JAX one on a test function whose state
depends on the path and whose objective is infinite off a box (iterates to
1e-10, equal iteration counts); a grouped fit with the device L-BFGS
against the JAX package's (equal num_it, parameters to rtol 1e-6); and the
reference's dispatch to the device L-BFGS at n = 19,999 / 20,000.
"""

import os
import sys

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

import gpboost_tpu as gpb
from gpboost_tpu.likelihoods.base import get_likelihood as jax_lik
from gpboost_tpu.models.components import GroupedComponent as JaxGroup
from gpboost_tpu.models.grouped_laplace import \
    GroupedRELaplaceEngine as JaxEngine
from gpboost_tpu.ops.lbfgs import lbfgs_run_state as jax_run_state
from gpboost_tpu.utils.datasim import sim_rand_unif

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.likelihoods.base import get_likelihood as port_lik
from gpboost_tpu_torch.models import optimize as port_optimize
from gpboost_tpu_torch.models.components import GroupedComponent
from gpboost_tpu_torch.models.grouped_laplace import GroupedRELaplaceEngine
from gpboost_tpu_torch.ops.lbfgs import lbfgs_run_state

sys.path.insert(0, os.path.dirname(__file__))
from test_non_gaussian_golden import ng_data  # noqa: E402,F401

torch.set_num_threads(1)

TOL_STRICT, TOL_MEDIUM = 1e-6, 1e-3


def _poisson_y(d):
    mu = np.exp(d["b_gr_1"][d["group"] - 1])
    return stats.poisson.ppf(sim_rand_unif(100, init_c=0.04532), mu=mu)


def _engines(d, name, crossed, weights=None, cluster_ids=None):
    groups = [d["group"]] + ([d["group2"]] if crossed else [])
    slope = [d["x"]] if crossed else []

    def comps(cls):
        out = [cls(g) for g in groups]
        out += [cls(d["group"], z=z) for z in slope]
        return out

    je = JaxEngine(comps(JaxGroup), 100, jax_lik(name),
                   cluster_ids=cluster_ids, weights=weights)
    pe = GroupedRELaplaceEngine(comps(GroupedComponent), 100,
                                port_lik(name), cluster_ids=cluster_ids,
                                weights=weights, device="cpu")
    return je, pe


def _compare(je, pe, u, y, F):
    nj, guj, gFj, bj = je.laplace_vag_F(u, jnp.asarray(y), jnp.asarray(F),
                                        je.zero_mode())
    npt, gup, gFp, bp = pe.laplace_vag_F(u, y, F, pe.zero_mode())
    np.testing.assert_allclose(bp.numpy(), np.asarray(bj), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(npt, nj, rtol=1e-10)
    np.testing.assert_allclose(gup, guj, rtol=1e-8)
    np.testing.assert_allclose(gFp, gFj, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(gFj)))
    assert pe.last_num_mode_it == je.last_num_mode_it
    return npt, gup, gFp, bp


@pytest.mark.parametrize("name,crossed", [
    ("poisson", False), ("bernoulli_logit", False), ("gamma", False),
    ("poisson", True), ("bernoulli_probit", True)])
def test_mode_finders_match_jax(name, crossed, ng_data):  # noqa: F811
    y = _poisson_y(ng_data)
    if name.startswith("bernoulli"):
        y = (y > 0).astype(float)
    elif name == "gamma":
        y = y + 0.5
    je, pe = _engines(ng_data, name, crossed)
    assert (pe._padded is not None) == (not crossed)
    nt = pe.num_theta
    u = np.log([0.7, 1.3, 0.4][:nt] + ([1.4] if name == "gamma" else []))
    F = 0.2 * np.cos(np.arange(100))
    _compare(je, pe, u, y, F)
    if not crossed:
        # the rows finder of the port on the same data as its padded one
        rows = GroupedRELaplaceEngine([GroupedComponent(ng_data["group"])],
                                      100, port_lik(name), device="cpu")
        rows._padded = None
        a = pe.laplace_vag_F(u, y, F, pe.zero_mode())
        b = rows.laplace_vag_F(u, y, F, rows.zero_mode())
        for x1, x2 in zip(a, b):
            np.testing.assert_allclose(np.asarray(x2), np.asarray(x1),
                                       rtol=1e-10, atol=1e-13)


def test_weights_and_cluster_ids_match_jax(ng_data):  # noqa: F811
    y = _poisson_y(ng_data)
    w = 0.5 + sim_rand_unif(100, init_c=0.3)
    clusters = np.arange(100) % 3
    u = np.log([0.8])
    F = np.linspace(-0.2, 0.2, 100)
    for kw in ({"weights": w}, {"cluster_ids": clusters},
               {"weights": w, "cluster_ids": clusters}):
        je, pe = _engines(ng_data, "poisson", False, **kw)
        _compare(je, pe, u, y, F)
    je, pe = _engines(ng_data, "poisson", True, weights=w)
    _compare(je, pe, np.log([0.8, 1.1, 0.5]), y, F)


class TestPoisson:
    """test_GPModel_non_Gaussian_data.R:2521-2617 on the port."""

    def test_grouped(self, ng_data):  # noqa: F811
        y = _poisson_y(ng_data)
        gp = gpt.GPModel(group_data=ng_data["group"], likelihood="poisson",
                         device="cpu")
        gp.fit(y=y, params=dict(optimizer_cov="gradient_descent",
                                use_nesterov_acc=True, lr_cov=0.1))
        assert np.sum(np.abs(gp.get_cov_pars() - [0.4033406])) < TOL_STRICT
        assert gp.get_num_optim_iter() == 8
        group_test = np.array([1, 3, 3, 9999])
        pred = gp.predict(y=y, group_data_pred=group_test,
                          predict_cov_mat=True, predict_response=False)
        expected_mu = np.array([0.07765297, -0.87488533, -0.87488533, 0.0])
        expected_cov = np.array(
            [0.07526284, 0, 0, 0, 0, 0.15041230, 0.15041230, 0, 0,
             0.15041230, 0.15041230, 0, 0, 0, 0, 0.40334058])
        assert np.sum(np.abs(pred["mu"] - expected_mu)) < TOL_STRICT
        assert pred["mu"][3] == 0.0          # an unseen group: exactly 0
        assert np.sum(np.abs(pred["cov"].ravel() - expected_cov)) \
            < TOL_STRICT
        pred = gp.predict(y=y, group_data_pred=group_test,
                          predict_var=True, predict_response=True)
        expected_mu = np.array([1.1221925, 0.4494731, 0.4494731, 1.2234446])
        expected_var = np.array([1.2206301, 0.4822647, 0.4822647,
                                 1.9670879])
        assert np.sum(np.abs(pred["mu"] - expected_mu)) < TOL_STRICT
        assert np.sum(np.abs(pred["var"] - expected_var)) < TOL_STRICT
        nll = gp.neg_log_likelihood(cov_pars=[0.9], y=y)
        assert abs(nll - 140.4554806) < TOL_MEDIUM

    def test_multiple_res(self, ng_data):  # noqa: F811
        d = ng_data
        mu = np.exp(d["b_gr_1"][d["group"] - 1]
                    + d["b_gr_2"][d["group2"] - 1]
                    + d["x"] * d["b_gr_3"][d["group"] - 1])
        y = stats.poisson.ppf(sim_rand_unif(100, init_c=0.74532), mu=mu)
        gp = gpt.GPModel(
            group_data=np.column_stack([d["group"], d["group2"]]),
            group_rand_coef_data=d["x"], ind_effect_group_rand_coef=[1],
            likelihood="poisson", device="cpu")
        gp.fit(y=y, params=dict(optimizer_cov="gradient_descent",
                                use_nesterov_acc=True, lr_cov=0.1,
                                init_cov_pars=[1.0, 1.0, 1.0]))
        assert np.sum(np.abs(gp.get_cov_pars()
                             - [0.4069344, 1.6988978, 1.3415016])) \
            < TOL_STRICT
        assert gp.get_num_optim_iter() == 7
        pred = gp.predict(
            y=y, group_data_pred=np.column_stack([[1, 1, 77], [2, 1, 98]]),
            group_rand_coef_data_pred=np.array([0, 0.1, 0.3]),
            cov_pars=[0.9, 0.8, 1.2], predict_cov_mat=True,
            predict_response=False)
        expected_mu = np.array([0.92620057, -0.08200469, 0.0])
        expected_cov = np.array([0.07730896, 0.04403442, 0, 0.04403442,
                                 0.11600469, 0, 0, 0, 1.808])
        assert np.sum(np.abs(pred["mu"] - expected_mu)) < TOL_STRICT
        assert np.sum(np.abs(pred["cov"].ravel() - expected_cov)) \
            < TOL_STRICT

    def test_linear_predictor(self, ng_data):  # noqa: F811
        d = ng_data
        mu = np.exp(d["b_gr_1"][d["group"] - 1] + d["X"] @ d["beta"])
        y = stats.poisson.ppf(sim_rand_unif(100, init_c=0.84532), mu=mu)
        gp = gpt.GPModel(group_data=d["group"], likelihood="poisson",
                         device="cpu")
        gp.fit(y=y, X=d["X"], params=dict(
            optimizer_cov="gradient_descent",
            optimizer_coef="gradient_descent", lr_cov=0.1, lr_coef=0.1,
            use_nesterov_acc=True, acc_rate_cov=0.5))
        assert np.sum(np.abs(gp.get_cov_pars() - [0.2977336946])) \
            < TOL_MEDIUM
        assert np.sum(np.abs(gp.get_coef()
                             - [-0.1491220786, 2.1209270742])) < TOL_MEDIUM


class TestGamma:
    """test_GPModel_non_Gaussian_data.R:2618-2720 on the port."""

    @pytest.fixture(scope="class")
    def y(self, ng_data):  # noqa: F811
        mu = np.exp(ng_data["b_gr_1"][ng_data["group"] - 1])
        return stats.gamma.ppf(sim_rand_unif(100, init_c=0.04532), a=1.0,
                               scale=mu)

    def _fit(self, ng_data, y, params):  # noqa: F811
        gp = gpt.GPModel(group_data=ng_data["group"], likelihood="gamma",
                         device="cpu")
        return gp.fit(y=y, params=params)

    def test_zero_rejected(self, ng_data, y):  # noqa: F811
        y_zero = y.copy()
        y_zero[0] = 0.0
        with pytest.raises(ValueError):
            self._fit(ng_data, y_zero, dict(optimizer_cov="lbfgs"))

    def test_lbfgs_fixed_shape(self, ng_data, y):  # noqa: F811
        gp = self._fit(ng_data, y, dict(
            optimizer_cov="lbfgs", optimizer_coef="lbfgs", maxit=1000,
            init_aux_pars=[1.0], estimate_aux_pars=False))
        assert np.sum(np.abs(gp.get_cov_pars() - [0.5175032387])) < 1e-5
        group_test = np.array([1, 3, 3, 9999])
        pred = gp.predict(y=y, group_data_pred=group_test,
                          predict_cov_mat=True, predict_response=False,
                          cov_pars=[0.6])
        expected_mu = np.array([0.2141580841, -0.9414716643, -0.9414716643,
                                0.0])
        expected_cov = np.array(
            [0.08316978821, 0, 0, 0, 0, 0.09903395128, 0.09903395128, 0, 0,
             0.09903395128, 0.09903395128, 0, 0, 0, 0, 0.6])
        assert np.sum(np.abs(pred["mu"] - expected_mu)) < TOL_MEDIUM
        assert np.sum(np.abs(pred["cov"].ravel() - expected_cov)) \
            < TOL_STRICT
        pred = gp.predict(y=y, group_data_pred=group_test, predict_var=True,
                          predict_response=True, cov_pars=[0.6])
        expected_mu = np.array([1.2914207620, 0.4098538326, 0.4098538326,
                                1.3498588076])
        expected_var = np.array([1.9570462290, 0.2029549058, 0.2029549058,
                                 4.8181150451])
        assert np.sum(np.abs(pred["mu"] - expected_mu)) < TOL_MEDIUM
        assert np.sum(np.abs(pred["var"] - expected_var)) < TOL_MEDIUM
        nll = gp.neg_log_likelihood(cov_pars=[0.9], y=y, aux_pars=[1.0])
        assert abs(nll - 105.676137) < TOL_MEDIUM

    def test_lbfgs_estimate_shape(self, ng_data, y):  # noqa: F811
        gp = self._fit(ng_data, y, dict(optimizer_cov="lbfgs", maxit=1000,
                                        init_aux_pars=[1.0],
                                        estimate_aux_pars=True))
        assert np.sum(np.abs(gp.get_cov_pars() - [0.5141245271])) \
            < TOL_MEDIUM
        assert np.sum(np.abs(gp.get_aux_pars() - [0.9719437296])) \
            < TOL_MEDIUM

    def test_gd_one_iteration_separate_lrs(self, ng_data, y):  # noqa
        gp = self._fit(ng_data, y, dict(
            optimizer_cov="gradient_descent", maxit=1, init_aux_pars=[1.0],
            estimate_aux_pars=True))
        assert np.sum(np.abs(gp.get_cov_pars() - [0.9058829])) < TOL_STRICT
        assert np.sum(np.abs(gp.get_aux_pars() - [0.9297985])) < TOL_STRICT
        gp = self._fit(ng_data, y, dict(
            optimizer_cov="gradient_descent", maxit=1, lr_cov=0.001,
            init_aux_pars=[1.0], estimate_aux_pars=True))
        assert np.sum(np.abs(gp.get_cov_pars() - [0.998025])) < TOL_STRICT
        assert np.sum(np.abs(gp.get_aux_pars() - [0.9985453])) < TOL_STRICT

    def test_fix_cov_estimate_aux(self, ng_data, y):  # noqa: F811
        gp = self._fit(ng_data, y, dict(
            optimizer_cov="lbfgs", init_aux_pars=[1.0],
            estimate_aux_pars=True, estimate_cov_par_index=[0]))
        assert np.sum(np.abs(gp.get_cov_pars() - [1.0])) < TOL_STRICT
        assert np.sum(np.abs(gp.get_aux_pars() - [0.9762847373])) \
            < TOL_STRICT
        # summary, model dicts with the aux parameter
        gp.summary()
        back = gpt.GPModel(model_dict=gp.model_to_dict(), device="cpu")
        np.testing.assert_array_equal(back.get_aux_pars(), gp.get_aux_pars())
        np.testing.assert_allclose(
            back.predict(group_data_pred=[1, 2], predict_var=True)["var"],
            gp.predict(group_data_pred=[1, 2], predict_var=True)["var"],
            rtol=1e-12)


# ----------------------------------------------------------------------
X0 = np.array([-1.9, 1.7, -1.5, 1.8])


def _objective(xp, x):
    # a tilted quartic bowl, infinite off the box |x| < 2
    w = xp.asarray([1.0, 3.0, 10.0, 0.5], dtype=x.dtype)
    f = xp.sum(w * (x - 0.3) ** 2) + 0.5 * xp.sum(x ** 4) \
        + 0.7 * x[0] * x[2]
    return xp.where(xp.max(xp.abs(x)) < 2.0, f, xp.inf)


def _jax_vag(x, st):
    f, g = jax.value_and_grad(lambda z: _objective(jnp, z))(x)
    return f, g, 0.5 * st + x


def _torch_vag(x, st):
    x = x.detach().requires_grad_(True)
    f = _objective(torch, x)
    (g,) = torch.autograd.grad(f, x)
    return f.detach(), g, 0.5 * st + x.detach()


@pytest.mark.parametrize("max_iter", [3, 200])
def test_lbfgs_run_state_matches_jax(max_iter):
    xj, fj, stj, kj, cj = jax_run_state(
        _jax_vag, jnp.asarray(X0), jnp.zeros(4), max_iter, ftol=1e-12,
        max_step=0.7)
    xp, fp, stp, kp, cp = lbfgs_run_state(
        _torch_vag, torch.as_tensor(X0), torch.zeros(4, dtype=torch.float64),
        max_iter, ftol=1e-12, max_step=0.7)
    assert kp == int(kj) and cp == bool(cj)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(stp.numpy(), np.asarray(stj), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(float(fp), float(fj), rtol=1e-10, atol=1e-14)


def test_device_optimizer_fit_matches_jax(ng_data):  # noqa: F811
    y = _poisson_y(ng_data)
    gj = gpb.GPModel(group_data=ng_data["group"], likelihood="poisson")
    gj.fit(y=y, params={"optimizer_cov": "lbfgs",
                        "use_device_optimizer": True})
    gp = gpt.GPModel(group_data=ng_data["group"], likelihood="poisson",
                     device="cpu")
    gp.fit(y=y, params={"optimizer_cov": "lbfgs",
                        "use_device_optimizer": True})
    assert gp._fit_result.optimizer == "device_lbfgs"
    assert gp.get_num_optim_iter() == gj.get_num_optim_iter()
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-6)
    np.testing.assert_allclose(gp.get_current_neg_log_likelihood(),
                               gj.get_current_neg_log_likelihood(),
                               rtol=1e-10)


class _Engine:
    def __init__(self, n, auto):
        self.n = n
        self.device_opt_auto = auto


@pytest.mark.parametrize("n,auto,opt,forced,expect", [
    (19_999, True, "lbfgs", None, "external"),
    (20_000, True, "lbfgs", None, "device"),
    (20_000, True, "lbfgs_linesearch_nocedal_wright", None, "device"),
    (20_000, False, "lbfgs", None, "external"),   # dense: not validated
    (100, False, "lbfgs", True, "device"),
    (10 ** 6, True, "lbfgs", False, "external"),
    (10 ** 6, True, "nelder_mead", None, "external"),
    (10 ** 6, True, "gradient_descent", None, "gd")])
def test_laplace_dispatch(n, auto, opt, forced, expect, monkeypatch):
    for nm in ("device", "external", "gd"):
        monkeypatch.setattr(port_optimize, f"_optimize_laplace_{nm}",
                            lambda *a, _nm=nm, **k: _nm)
    cfg = port_optimize.OptimConfig(optimizer_cov=opt,
                                    use_device_optimizer=forced)
    assert port_optimize.optimize_laplace(_Engine(n, auto), None,
                                          cfg) == expect
    for bad in ("fisher_scoring", "newton"):
        with pytest.raises(ValueError):
            port_optimize.optimize_laplace(
                _Engine(n, auto), None,
                port_optimize.OptimConfig(optimizer_cov=bad))
