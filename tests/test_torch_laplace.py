"""The dense Laplace engine of the PyTorch port against the JAX package.

Data: ng_data of tests/test_non_gaussian_golden.py (n = 100, the R suite's
LCG), an exponential GP, with and without observation weights. At fixed
parameters and fixed effects F the port's mode a = Sigma^-1 b agrees with
the JAX engine's to 1e-8, its NLL to rtol
1e-10, and the implicit-function gradients with respect to u (log
covariance and aux parameters) and F (the port's autograd.Function, the
reference's custom_vjp) to rtol 1e-8, for a binary, a count and a
positive response with an aux parameter, and the t likelihood with its
Fisher curvature. Then TestBernoulliProbitGP's goldens (gradient descent
with and without Nesterov, L-BFGS, prediction of the latent and the
response) on the port at that file's tolerances.
"""

import os
import sys

import numpy as np
import pytest
import torch
from scipy import stats

import jax.numpy as jnp

from gpboost_tpu.likelihoods.base import get_likelihood as jax_lik
from gpboost_tpu.models.components import GPComponent as JaxGP
from gpboost_tpu.models.laplace import LaplaceDenseEngine as JaxEngine
from gpboost_tpu.ops.cov_fcts import CovarianceFunction as JaxCov
from gpboost_tpu.utils.datasim import sim_rand_unif

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.likelihoods.base import get_likelihood as port_lik
from gpboost_tpu_torch.models.components import GPComponent
from gpboost_tpu_torch.models.laplace import LaplaceDenseEngine
from gpboost_tpu_torch.ops.cov_fcts import CovarianceFunction

sys.path.insert(0, os.path.dirname(__file__))
from test_non_gaussian_golden import ng_data  # noqa: E402,F401

torch.set_num_threads(1)

TOL_STRICT, TOL_MEDIUM, TOL_LOOSE = 1e-6, 1e-3, 1e-2


@pytest.fixture(scope="module")
def y_probit(ng_data):  # noqa: F811
    probs = stats.norm.cdf(ng_data["eps"])
    return (sim_rand_unif(100, init_c=0.2341) < probs).astype(float)


def _response(name, ng_data, y_probit):  # noqa: F811
    eps = ng_data["eps"]
    if name == "bernoulli_probit":
        return y_probit, None
    if name == "poisson":
        return stats.poisson.ppf(sim_rand_unif(100, init_c=0.435),
                                 mu=np.exp(eps)), None
    if name == "gamma":
        return stats.gamma.ppf(sim_rand_unif(100, init_c=0.04532), a=1.0,
                               scale=np.exp(eps)), 1.3
    return eps + 0.5 * stats.norm.ppf(sim_rand_unif(100, init_c=0.77)), 0.6


@pytest.mark.parametrize("name,weighted", [
    ("bernoulli_probit", False), ("poisson", False), ("gamma", False),
    ("t", False), ("poisson", True)])
def test_mode_nll_and_gradients_match_jax(name, weighted,  # noqa: F811
                                          ng_data, y_probit):
    y, aux = _response(name, ng_data, y_probit)
    coords = ng_data["coords"]
    n = len(y)
    w = 0.5 + sim_rand_unif(n, init_c=0.3) if weighted else None
    je = JaxEngine([JaxGP(coords, JaxCov("exponential"))], n,
                   jax_lik(name), weights=w)
    pe = LaplaceDenseEngine([GPComponent(coords,
                                         CovarianceFunction("exponential"))],
                            n, port_lik(name), weights=w, device="cpu")
    u = np.log([0.9, 1.0 / 0.15])
    if name == "t":
        u = np.concatenate([u, np.log([aux, 4.0])])
    elif aux is not None:
        u = np.concatenate([u, [np.log(aux)]])
    F = 0.3 * np.sin(np.arange(n))
    nj, guj, gFj, aj = je.laplace_vag_F(u, jnp.asarray(y), jnp.asarray(F),
                                        je.zero_mode())
    npt, gup, gFp, ap = pe.laplace_vag_F(u, y, F, pe.zero_mode())
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(npt, nj, rtol=1e-10)
    np.testing.assert_allclose(gup, guj, rtol=1e-8)
    np.testing.assert_allclose(gFp, gFj, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(gFj)))
    assert pe.last_num_mode_it == je.last_num_mode_it
    # from a warm start, as the optimizers call it
    nj2, aj2 = je.laplace_nll(u + 0.05, jnp.asarray(y), jnp.asarray(F), aj)
    np2, ap2 = pe.laplace_nll(u + 0.05, y, F, ap)
    np.testing.assert_allclose(np2, nj2, rtol=1e-10)
    np.testing.assert_allclose(ap2.numpy(), np.asarray(aj2), atol=1e-8)
    assert pe.last_num_mode_it == je.last_num_mode_it


class TestBernoulliProbitGP:
    """test_GPModel_non_Gaussian_data.R:286-545 on the port."""

    def _init(self, ng_data):  # noqa: F811
        iu = np.triu_indices(100, k=1)
        return [1.0, np.mean(ng_data["D"][iu]) / 3]

    def _fit(self, ng_data, y, params):  # noqa: F811
        gp = gpt.GPModel(gp_coords=ng_data["coords"],
                         cov_function="exponential",
                         likelihood="bernoulli_probit", device="cpu")
        return gp.fit(y=y, params=params)

    def test_label_validation_and_fisher_rejected(self, ng_data,  # noqa
                                                  y_probit):
        with pytest.raises(ValueError):
            self._fit(ng_data, ng_data["eps"],
                      dict(optimizer_cov="gradient_descent"))
        with pytest.raises(ValueError):
            self._fit(ng_data, y_probit, dict(optimizer_cov="fisher_scoring"))

    def test_gradient_descent(self, ng_data, y_probit):  # noqa: F811
        gp = self._fit(ng_data, y_probit, dict(
            optimizer_cov="gradient_descent", lr_cov=0.1,
            use_nesterov_acc=False,
            convergence_criterion="relative_change_in_parameters",
            init_cov_pars=self._init(ng_data)))
        assert np.sum(np.abs(gp.get_cov_pars()
                             - [0.9419234, 0.1866877])) < TOL_STRICT
        assert abs(gp.get_current_neg_log_likelihood() - 63.61263619) \
            < TOL_STRICT
        assert gp.get_num_optim_iter() == 40

    def test_gradient_descent_nesterov(self, ng_data, y_probit):  # noqa
        gp = self._fit(ng_data, y_probit, dict(
            optimizer_cov="gradient_descent", lr_cov=0.01,
            use_nesterov_acc=True, acc_rate_cov=0.5,
            init_cov_pars=self._init(ng_data)))
        assert np.sum(np.abs(gp.get_cov_pars()
                             - [0.9646422, 0.1844797])) < TOL_STRICT
        assert gp.get_num_optim_iter() == 26

    def test_lbfgs(self, ng_data, y_probit):  # noqa: F811
        gp = self._fit(ng_data, y_probit, dict(
            optimizer_cov="lbfgs", init_cov_pars=self._init(ng_data)))
        assert np.sum(np.abs(gp.get_cov_pars()
                             - [0.9418327551, 0.1866904020])) < TOL_MEDIUM
        assert abs(gp.get_current_neg_log_likelihood() - 63.61263619) \
            < TOL_LOOSE

    def test_prediction(self, ng_data, y_probit):  # noqa: F811
        gp = self._fit(ng_data, y_probit, dict(
            optimizer_cov="gradient_descent", lr_cov=0.01,
            use_nesterov_acc=False, init_cov_pars=self._init(ng_data)))
        coord_test = np.column_stack([[0.1, 0.11, 0.7], [0.9, 0.91, 0.55]])
        pred = gp.predict(y=y_probit, gp_coords_pred=coord_test,
                          predict_cov_mat=True, predict_response=False)
        expected_mu = np.array([-0.6595663, -0.6638940, 0.4997690])
        expected_cov = np.array(
            [0.6482224576, 0.5765285950, -0.0001030520, 0.5765285950,
             0.6478191338, -0.0001163496, -0.0001030520, -0.0001163496,
             0.4435551436])
        assert np.sum(np.abs(pred["mu"] - expected_mu)) < TOL_STRICT
        assert np.sum(np.abs(pred["cov"].ravel() - expected_cov)) \
            < TOL_STRICT
        pred = gp.predict(y=y_probit, gp_coords_pred=coord_test,
                          predict_var=True, predict_response=True)
        expected_mu_resp = np.array([0.3037139, 0.3025143, 0.6612807])
        assert np.sum(np.abs(pred["mu"] - expected_mu_resp)) < TOL_STRICT
        # the latent means at the training points: R a at the mode
        re = gp.predict_training_data_random_effects()
        assert re["GP_1"].shape == (100,) and np.all(np.isfinite(re["GP_1"]))
