"""The dense exact-GP engine of the PyTorch port against the JAX package.

models/gaussian_gp.py against gpboost_tpu.models.gaussian_gp on the R
suite's GP data (tests/conftest.py gp_sim_data, n = 100) and on a GP
combined with a grouped random effect, float64: NLL and gradients to
rtol 1e-10, the Hessian and the Fisher information to 1e-8, fits with
every optimizer to rtol 1e-6 with the same iteration count for the
internal ones, predictions, training-point random effects and Psi~^-1
products. Then the port alone against the goldens of
tests/test_gp_gaussian_golden.py at that file's tolerances.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpboost_tpu as gpb
from gpboost_tpu.boosting.gbdt import _psi_tilde_inv_mat as jax_psi_inv_mat

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.convert import gp_model_from_jax_dict

from conftest import TOLERANCE_LOOSE, TOLERANCE_MEDIUM, TOLERANCE_STRICT

torch.set_num_threads(1)

THETA = np.log([1.5, 6.0, 0.8])        # log [v~_group, v~_gp, alpha]
SIGMA2 = 0.2


def _init(d, y):
    iu = np.triu_indices(len(d["coords"]), k=1)
    return [np.var(y, ddof=1) / 2, np.var(y, ddof=1) / 2,
            np.mean(d["D"][iu]) / 3]


def _group(n):
    return np.arange(n) % 9


@pytest.fixture(scope="module")
def models(gp_sim_data):
    """(JAX, port) GP + grouped random effect models, unfitted."""
    d = gp_sim_data
    kw = dict(group_data=_group(d["n"]), gp_coords=d["coords"],
              cov_function="exponential")
    return gpb.GPModel(**kw), gpt.GPModel(**kw, device="cpu")


@pytest.mark.parametrize("cov,shape,expected", [
    ("exponential", 1.5, 124.2549533), ("matern", 0.5, 124.2549533),
    ("matern", 1.5, 141.3502172), ("matern", 2.5, 158.1111626)])
def test_golden_nll(gp_sim_data, cov, shape, expected):
    m = gpt.GPModel(gp_coords=gp_sim_data["coords"], cov_function=cov,
                    cov_fct_shape=shape, device="cpu")
    nll = m.neg_log_likelihood(cov_pars=[0.1, 1.6, 0.2], y=gp_sim_data["y"])
    assert abs(nll - expected) < TOLERANCE_STRICT


def test_nll_gradients_hessian_and_fisher_match(models, gp_sim_data):
    je, pe = models[0]._engine, models[1]._engine
    y = gp_sim_data["y"]
    yj, yt = jnp.asarray(y), torch.as_tensor(y)
    nj, qj = je.nll_parts(jnp.asarray(THETA), jnp.asarray(SIGMA2), yj)
    np.testing.assert_allclose(pe.nll_parts(THETA, SIGMA2, yt),
                               [float(nj), float(qj)], rtol=1e-10)
    vj, gj = je.grad_profiled(jnp.asarray(THETA), jnp.asarray(SIGMA2), yj)
    np.testing.assert_allclose(pe.grad_profiled(THETA, SIGMA2, yt)[1],
                               np.asarray(gj), rtol=1e-10)
    (vj, qj), gj = je.nll_profiled_vag(jnp.asarray(THETA), yj)
    (vp, qp), gp = pe.nll_profiled_vag(THETA, yt)
    np.testing.assert_allclose([vp, qp], [float(vj), float(qj)], rtol=1e-10)
    np.testing.assert_allclose(gp, np.asarray(gj), rtol=1e-10)
    u = np.concatenate([[np.log(SIGMA2)], THETA])
    np.testing.assert_allclose(pe.vag_full(u, yt)[1],
                               np.asarray(je.vag_full(jnp.asarray(u), yj)[1]),
                               rtol=1e-10)
    np.testing.assert_allclose(pe.hess_full(u, yt),
                               np.asarray(je.hess_full(jnp.asarray(u), yj)),
                               rtol=1e-8)
    np.testing.assert_allclose(
        pe.fisher_transformed(u, True),
        np.asarray(je.fisher_transformed(jnp.asarray(u), True)), rtol=1e-8)
    pars = np.array([SIGMA2, 0.3, 1.2, 0.15])
    np.testing.assert_allclose(
        pe.fisher_original(pars),
        np.asarray(je.fisher_original(jnp.asarray(pars))), rtol=1e-8)
    t = np.concatenate([[SIGMA2], np.exp(THETA)])
    M = np.column_stack([y, np.cos(y)])
    np.testing.assert_allclose(
        pe.psi_tilde_inv_mat(t, torch.as_tensor(M)).numpy(),
        jax_psi_inv_mat(je, t, M), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("extra", [
    {},                                               # GD with Nesterov
    {"use_nesterov_acc": False},
    {"optimizer_cov": "fisher_scoring", "lr_cov": 1.0},
    {"optimizer_cov": "newton", "lr_cov": 1.0, "use_nesterov_acc": False},
    {"optimizer_cov": "lbfgs"},
    {"optimizer_cov": "nelder_mead"}])
def test_fits_match_jax(gp_sim_data, default_optim_params, extra):
    d = gp_sim_data
    params = {**default_optim_params, "init_cov_pars": _init(d, d["y"]),
              **extra}
    kw = dict(gp_coords=d["coords"], cov_function="exponential")
    jm = gpb.GPModel(**kw)
    jm.fit(y=d["y"], params=params)
    pm = gpt.GPModel(**kw, device="cpu")
    pm.fit(y=d["y"], params=params)
    if params["optimizer_cov"] not in ("lbfgs", "nelder_mead"):
        # scipy's L-BFGS-B (ftol 1e-16) and Nelder-Mead compare values in
        # the rounding noise near the optimum, so their iteration counts
        # are no property of the model
        assert pm.get_num_optim_iter() == jm.get_num_optim_iter()
    np.testing.assert_allclose(pm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)


def test_combined_model_fit_predict_and_training_re(models, gp_sim_data):
    jm, pm = models
    d = gp_sim_data
    params = {"optimizer_cov": "fisher_scoring", "std_dev": True}
    jm.fit(y=d["y"], X=d["X"], params=params)
    pm.fit(y=d["y"], X=d["X"], params=params)
    assert pm.get_num_optim_iter() == jm.get_num_optim_iter()
    np.testing.assert_allclose(pm.get_cov_pars(std_err=True),
                               jm.get_cov_pars(std_err=True), rtol=1e-6)
    np.testing.assert_allclose(pm.get_coef(std_err=True),
                               jm.get_coef(std_err=True), rtol=1e-6)
    kw = dict(group_data_pred=[0, 4, 8, 50],
              gp_coords_pred=np.array([[0.1, 0.9], [0.2, 0.4], [0.7, 0.55],
                                       [0.5, 0.5]]),
              X_pred=np.column_stack([np.ones(4), np.linspace(-1, 1, 4)]),
              predict_cov_mat=True, predict_var=True)
    pj, pp = jm.predict(**kw), pm.predict(**kw)
    for k in ("mu", "cov", "var"):
        np.testing.assert_allclose(pp[k], pj[k], rtol=1e-7, atol=1e-10,
                                   err_msg=k)
    rj = jm.predict_training_data_random_effects(predict_var=True)
    rp = pm.predict_training_data_random_effects(predict_var=True)
    assert list(rp) == list(rj.columns)
    for k in rp:
        np.testing.assert_allclose(rp[k], rj[k].values, rtol=1e-7,
                                   atol=1e-10, err_msg=k)
    # model dicts both ways
    lp = gp_model_from_jax_dict(jm.model_to_dict(), device="cpu")
    np.testing.assert_allclose(lp.predict(**kw)["mu"], pj["mu"], rtol=1e-10)
    lj = gpb.GPModel(model_dict=pm.model_to_dict())
    np.testing.assert_allclose(lj.predict(**kw)["var"], pp["var"],
                               rtol=1e-10)


def test_unported_options_raise(gp_sim_data):
    d = gp_sim_data
    # cluster_ids and weights are ported (tests/test_torch_weights_
    # clusters.py holds them to the JAX package), and so are the tapering
    # approximations (tests/test_torch_taper.py) and
    # gp_approx="vecchia_latent" (tests/test_torch_vecchia_grouped.py)
    with pytest.raises(NotImplementedError):
        gpt.GPModel(gp_coords=d["coords"], cov_function="exponential",
                    device="cpu", num_parallel_devices=2)
    # GP random coefficients are ported on the dense engine
    # (tests/test_torch_svc_sampling_adam.py holds them to the JAX
    # package): one column adds a second GP with the covariate as weights
    m = gpt.GPModel(gp_coords=d["coords"], cov_function="exponential",
                    device="cpu", gp_rand_coef_data=d["Z_SVC"][:, 0])
    assert m.get_cov_par_names() == [
        "Error_term", "GP_var", "GP_range", "GP_rand_coef_nb_1_var",
        "GP_rand_coef_nb_1_range"]
    np.testing.assert_array_equal(m.components[1].z, d["Z_SVC"][:, 0])


# ---------------------------------------------------------------------
# the goldens of tests/test_gp_gaussian_golden.py on the port
def _fit_port(d, base, **extra):
    params = {**base, "init_cov_pars": _init(d, d["y"]), **extra}
    m = gpt.GPModel(gp_coords=d["coords"], cov_function="exponential",
                    device="cpu")
    return m.fit(y=d["y"], params=params)


def _interleaved(m):
    return np.asarray(m.get_cov_pars(std_err=True)).T.ravel()


@pytest.mark.parametrize("extra,expected,num_it,tol", [
    ({}, [0.03784221, 0.07943467, 1.07390943, 0.25351519, 0.11451432,
          0.03840236], 59, TOLERANCE_STRICT),
    ({"use_nesterov_acc": False}, [0.04040441, 0.08036674, 1.06926607,
                                   0.25360131, 0.11502362, 0.03877014], 97,
     5e-6),
    ({"lr_cov": 1.0}, [0.03738147, 0.07929704, 1.07520000, 0.25359186,
                       0.11441031, 0.03833048], 49, TOLERANCE_STRICT),
    ({"optimizer_cov": "fisher_scoring", "lr_cov": 1.0},
     [0.03294841, 0.07722844, 1.07591929, 0.25179816, 0.11355958,
      0.03772550], 8, TOLERANCE_STRICT),
    ({"optimizer_cov": "newton", "lr_cov": 1.0, "use_nesterov_acc": False},
     [0.03282998, 0.07718279, 1.07612393, 0.25179124, 0.11353614,
      0.03770875], 7, TOLERANCE_STRICT)])
def test_golden_estimation(gp_sim_data, default_optim_params, extra,
                           expected, num_it, tol):
    m = _fit_port(gp_sim_data, default_optim_params, std_dev=True, **extra)
    assert np.sum(np.abs(_interleaved(m) - np.array(expected))) < tol
    assert m.get_num_optim_iter() == num_it


def test_golden_convergence_criterion_parameters(gp_sim_data,
                                                 default_optim_params):
    m = _fit_port(gp_sim_data, default_optim_params, std_dev=True,
                  convergence_criterion="relative_change_in_parameters")
    expected = np.array([0.03276547, 0.07715343, 1.07617676, 0.25177603,
                         0.11352557, 0.03770062])
    assert np.sum(np.abs(_interleaved(m) - expected)) < TOLERANCE_MEDIUM
    assert 100 < m.get_num_optim_iter() <= 500


@pytest.mark.parametrize("opt", ["lbfgs", "nelder_mead"])
def test_golden_external_optimizers(gp_sim_data, default_optim_params, opt):
    m = _fit_port(gp_sim_data, default_optim_params, optimizer_cov=opt)
    expected = np.array([0.03784221, 1.07390943, 0.11451432])
    assert np.sum(np.abs(m.get_cov_pars() - expected)) < 0.02
    assert abs(m.get_current_neg_log_likelihood() - 122.7771373) \
        < TOLERANCE_LOOSE


@pytest.mark.parametrize("est_idx,expected,nll,tol", [
    ([1, 1, 0], [0.10273152252, 0.08925506562, 1.23337072589, 0.37123039633,
                 0.17864807736, 0.07351705425], 123.4853915, 1e-4),
    ([1, 0, 0], [0.4583440607, 0.1476785505, 0.5170731356, 0.2240355344,
                 0.1786480774, 0.1126220657], 127.7832271, TOLERANCE_STRICT),
    ([0, 0, 0], None, 128.132446, None),
    ([0, 1, 0], [0.5170731356, 0.1687492120, 0.6088800134, 0.2602195062,
                 0.1786480774, 0.1112692786], 127.9879294, 1e-4)])
def test_golden_fixed_cov_pars(gp_sim_data, default_optim_params, est_idx,
                               expected, nll, tol):
    m = _fit_port(gp_sim_data, default_optim_params, optimizer_cov="lbfgs",
                  estimate_cov_par_index=est_idx, std_dev=True)
    if expected is not None:
        assert np.sum(np.abs(_interleaved(m) - np.array(expected))) < tol
    assert abs(m.get_current_neg_log_likelihood() - nll) < TOLERANCE_STRICT


def test_golden_predict_given_params(gp_sim_data):
    m = gpt.GPModel(gp_coords=gp_sim_data["coords"],
                    cov_function="exponential", device="cpu")
    coord_test = np.column_stack([[0.1, 0.2, 0.7], [0.9, 0.4, 0.55]])
    cov_pars = [0.02, 1.2, 0.9]
    expected_mu = np.array([0.08704577, 1.63875604, 0.48513581])
    expected_cov = np.array(
        [1.189093e-01, 1.171632e-05, -4.172444e-07, 1.171632e-05,
         7.427727e-02, 1.492859e-06, -4.172444e-07, 1.492859e-06,
         8.107455e-02])
    kw = dict(y=gp_sim_data["y"], gp_coords_pred=coord_test,
              cov_pars=cov_pars)
    pred = m.predict(predict_response=True, predict_cov_mat=True,
                     predict_var=True, **kw)
    assert np.sum(np.abs(pred["mu"] - expected_mu)) < TOLERANCE_STRICT
    assert np.sum(np.abs(pred["cov"].ravel() - expected_cov)) \
        < TOLERANCE_STRICT
    assert np.sum(np.abs(pred["var"] - expected_cov[[0, 4, 8]])) \
        < TOLERANCE_STRICT
    pred = m.predict(predict_response=False, predict_cov_mat=True, **kw)
    latent = expected_cov.copy()
    latent[[0, 4, 8]] -= cov_pars[0]
    assert np.sum(np.abs(pred["cov"].ravel() - latent)) < TOLERANCE_STRICT


def test_golden_predict_after_fisher_fit(gp_sim_data):
    y = gp_sim_data["y"]
    m = gpt.GPModel(gp_coords=gp_sim_data["coords"],
                    cov_function="exponential", device="cpu")
    m.fit(y=y, params=dict(
        optimizer_cov="fisher_scoring", delta_rel_conv=1e-6,
        use_nesterov_acc=False,
        convergence_criterion="relative_change_in_parameters"))
    coord_test = np.column_stack([[0.1, 0.2, 0.7], [0.9, 0.4, 0.55]])
    pred = m.predict(y=y, gp_coords_pred=coord_test, predict_cov_mat=True,
                     predict_response=True)
    expected_mu = np.array([0.06960478, 1.61299381, 0.44053480])
    expected_cov = np.array(
        [6.218737e-01, 2.024102e-05, 2.278875e-07, 2.024102e-05,
         3.535390e-01, 8.479210e-07, 2.278875e-07, 8.479210e-07,
         4.202154e-01])
    assert np.sum(np.abs(pred["mu"] - expected_mu)) < TOLERANCE_STRICT
    assert np.sum(np.abs(pred["cov"].ravel() - expected_cov)) \
        < TOLERANCE_STRICT
