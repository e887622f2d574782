"""Grouped random effects in the PyTorch port against the JAX package.

The Woodbury engine (models/grouped_re.py) against
gpboost_tpu.models.grouped_re.WoodburyGaussianEngine on the same seeded
numpy data, float64, n = 300 with a random intercept, a crossed grouping
and a random slope: NLL, profiled NLL and gradients to rtol 1e-10 (both
sum the same values, in another order), Fisher information to 1e-8; GLS
and gradient coefficient steps, Psi~^-1 products, training-point random
effects and predictions for seen and unseen groups. Then the port alone
against the R suite's goldens at their own tolerances
(tests/test_grouped_re_golden.py, tests/test_linear_covariates_golden.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpboost_tpu as gpb
from gpboost_tpu.boosting.gbdt import _psi_tilde_inv_mat as jax_psi_inv_mat
from gpboost_tpu.models.components import GroupedComponent as JaxGrouped
from gpboost_tpu.models.grouped_re import WoodburyGaussianEngine as JaxEngine
from gpboost_tpu.utils.datasim import qnorm, sim_rand_unif

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models.components import GroupedComponent
from gpboost_tpu_torch.models.grouped_re import (SegmentSum,
                                                 WoodburyGaussianEngine)

from conftest import TOLERANCE_STRICT

torch.set_num_threads(1)

N = 300
THETA = np.log([1.5, 0.7, 0.4])        # log v~ of the three components
SIGMA2 = 0.35


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(5)
    g1 = rng.randint(0, 25, N)
    g2 = rng.randint(0, 8, N)
    z = rng.rand(N)
    X = np.column_stack([np.ones(N), rng.rand(N)])
    y = (X @ np.array([1.0, 2.0]) + 0.9 * rng.randn(25)[g1]
         + 0.5 * rng.randn(8)[g2] + z * 0.6 * rng.randn(25)[g1]
         + 0.5 * rng.randn(N))
    return g1, g2, z, X, y


def _components(mod, g1, g2, z):
    return [mod(g1, name="Group_1"), mod(g2, name="Group_2"),
            mod(g1, z=z, name="Group_rand_coef_1")]


@pytest.fixture(scope="module")
def engines(data):
    g1, g2, z, _, _ = data
    je = JaxEngine(_components(JaxGrouped, g1, g2, z), N)
    pe = WoodburyGaussianEngine(_components(GroupedComponent, g1, g2, z), N,
                                device="cpu")
    return je, pe


def test_segment_sum_matches_np_add_at():
    rng = np.random.RandomState(0)
    codes = np.concatenate([np.zeros(500, int), rng.randint(2, 40, 300)])
    v = rng.randn(len(codes), 3)
    ref = np.zeros((41, 3))
    np.add.at(ref, codes, v)                # levels 1 and 40 stay empty
    out = SegmentSum(codes, 41, "cpu")(torch.as_tensor(v))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)
    out1 = SegmentSum(codes, 41, "cpu")(torch.as_tensor(v[:, 0]))
    np.testing.assert_allclose(out1.numpy(), ref[:, 0], rtol=1e-12,
                               atol=1e-12)


def test_nll_and_gradients_match(engines, data):
    je, pe = engines
    y = data[4]
    yt = torch.as_tensor(y)
    nj, qj = je.nll_parts(jnp.asarray(THETA), jnp.asarray(SIGMA2), y)
    npp, qp = pe.nll_parts(THETA, SIGMA2, yt)
    np.testing.assert_allclose([npp, qp], [float(nj), float(qj)], rtol=1e-10)
    vj, gj = je.grad_profiled(jnp.asarray(THETA), jnp.asarray(SIGMA2), y)
    vp, gp = pe.grad_profiled(THETA, SIGMA2, yt)
    np.testing.assert_allclose(vp, float(vj), rtol=1e-10)
    np.testing.assert_allclose(gp, np.asarray(gj), rtol=1e-10)
    (vj, qj), gj = je.nll_profiled_vag(jnp.asarray(THETA), y)
    (vp, qp), gp = pe.nll_profiled_vag(THETA, yt)
    np.testing.assert_allclose([vp, qp], [float(vj), float(qj)], rtol=1e-10)
    np.testing.assert_allclose(gp, np.asarray(gj), rtol=1e-10)
    u = np.concatenate([[np.log(SIGMA2)], THETA])
    vj, gj = je.vag_full(jnp.asarray(u), y)
    vp, gp = pe.vag_full(u, yt)
    np.testing.assert_allclose(gp, np.asarray(gj), rtol=1e-10)
    np.testing.assert_allclose(pe.hess_full(u, yt),
                               np.asarray(je.hess_full(jnp.asarray(u), y)),
                               rtol=1e-8)
    lp = np.log([SIGMA2, 0.5, 0.3, 0.2])
    vj, gj = je.nll_orig_vag(jnp.asarray(lp), y)
    vp, gp = pe.nll_orig_vag(lp, yt)
    np.testing.assert_allclose(gp, np.asarray(gj), rtol=1e-10)


def test_fisher_information_matches(engines):
    je, pe = engines
    u = np.concatenate([[np.log(SIGMA2)], THETA])
    for inc in (True, False):
        np.testing.assert_allclose(
            pe.fisher_transformed(u, inc),
            np.asarray(je.fisher_transformed(jnp.asarray(u), inc)),
            rtol=1e-8)
    pars = np.array([SIGMA2, 0.5, 0.3, 0.2])
    np.testing.assert_allclose(pe.fisher_original(pars),
                               np.asarray(je.fisher_original(
                                   jnp.asarray(pars))), rtol=1e-8)


def test_coefficient_steps_and_psi_inverse_match(engines, data):
    je, pe = engines
    X, y = data[3], data[4]
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    np.testing.assert_allclose(
        pe.wls_coef(THETA, yt, Xt),
        np.asarray(je.wls_coef(jnp.asarray(THETA), y, X)), rtol=1e-10)
    r = y - X @ np.array([0.9, 1.8])
    np.testing.assert_allclose(
        pe.coef_grad(THETA, SIGMA2, torch.as_tensor(r), Xt),
        np.asarray(je.coef_grad(jnp.asarray(THETA), jnp.asarray(SIGMA2), r,
                                X)), rtol=1e-10)
    t = np.concatenate([[SIGMA2], np.exp(THETA)])
    M = np.column_stack([y, X[:, 1]])
    np.testing.assert_allclose(
        pe.psi_tilde_inv_mat(t, torch.as_tensor(M)).numpy(),
        jax_psi_inv_mat(je, t, M), rtol=1e-10, atol=1e-12)


def _fit_both(data, params, cluster_ids=None, with_X=True):
    g1, g2, z, X, y = data
    kw = dict(group_data=np.column_stack([g1, g2]), group_rand_coef_data=z,
              ind_effect_group_rand_coef=[1], cluster_ids=cluster_ids)
    Xf = X if with_X else None
    jm = gpb.GPModel(**kw)
    jm.fit(y=y, X=Xf, params=params)
    pm = gpt.GPModel(**kw, device="cpu")
    pm.fit(y=y, X=Xf, params=params)
    return jm, pm


@pytest.mark.parametrize("params", [
    {"optimizer_cov": "fisher_scoring", "std_dev": True},
    {"optimizer_cov": "gradient_descent", "optimizer_coef":
     "gradient_descent", "lr_coef": 0.1},
    {"optimizer_cov": "lbfgs", "std_dev": True}])
def test_fit_random_slope_crossed_with_X_matches(data, params):
    jm, pm = _fit_both(data, params)
    if params["optimizer_cov"] != "lbfgs":
        # scipy's L-BFGS-B runs to ftol 1e-16, into the rounding noise, so
        # its iteration count is no property of the model
        assert pm.get_num_optim_iter() == jm.get_num_optim_iter()
    np.testing.assert_allclose(pm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    np.testing.assert_allclose(pm.get_coef(), jm.get_coef(), rtol=1e-6)
    np.testing.assert_allclose(pm.get_current_neg_log_likelihood(),
                               jm.get_current_neg_log_likelihood(),
                               rtol=1e-10)
    assert pm.get_cov_par_names() == jm.get_cov_par_names()


def test_cluster_ids_fit_and_predict_match(data):
    g1 = data[0]
    clusters = (np.arange(N) >= 120).astype(int)
    params = {"optimizer_cov": "fisher_scoring"}
    jm, pm = _fit_both(data, params, cluster_ids=clusters, with_X=False)
    assert pm._engine.q == jm._engine.q
    np.testing.assert_allclose(pm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    gp = np.column_stack([g1[:6], [0, 1, 2, 3, 99, 99]])
    cp = np.array([0, 1, 1, 0, 0, 7])
    zp = np.linspace(0, 1, 6)
    kw = dict(group_data_pred=gp, group_rand_coef_data_pred=zp,
              cluster_ids_pred=cp, predict_var=True)
    pj, pp = jm.predict(**kw), pm.predict(**kw)
    np.testing.assert_allclose(pp["mu"], pj["mu"], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(pp["var"], pj["var"], rtol=1e-8)


def test_predictions_seen_and_unseen_and_training_re(data):
    g1, g2, z, X, y = data
    jm, pm = _fit_both(data, {"optimizer_cov": "fisher_scoring"})
    gp = np.column_stack([[0, 3, 24, 1000, 1000, 2000], [1, 9, 9, 0, 0, 5]])
    zp = np.array([0.1, 0.5, 0.9, 0.3, 0.7, 0.2])
    Xp = np.column_stack([np.ones(6), np.linspace(0, 1, 6)])
    for resp in (True, False):
        kw = dict(group_data_pred=gp, group_rand_coef_data_pred=zp,
                  X_pred=Xp, predict_cov_mat=True, predict_var=True,
                  predict_response=resp)
        pj, pp = jm.predict(**kw), pm.predict(**kw)
        np.testing.assert_allclose(pp["mu"], pj["mu"], rtol=1e-8)
        np.testing.assert_allclose(pp["cov"], pj["cov"], rtol=1e-8,
                                   atol=1e-12)
        np.testing.assert_allclose(pp["var"], pj["var"], rtol=1e-8)
    rj = jm.predict_training_data_random_effects(predict_var=True)
    rp = pm.predict_training_data_random_effects(predict_var=True)
    assert list(rp) == list(rj.columns)
    for k in rp:
        np.testing.assert_allclose(rp[k], rj[k].values, rtol=1e-8,
                                   atol=1e-12, err_msg=k)


def test_model_dict_round_trips(data):
    jm, pm = _fit_both(data, {"optimizer_cov": "fisher_scoring",
                              "std_dev": True})
    gp = np.column_stack([[0, 3, 1000], [1, 9, 0]])
    kw = dict(group_data_pred=gp, group_rand_coef_data_pred=[0.2, 0.4, 0.6],
              X_pred=np.column_stack([np.ones(3), [0.1, 0.5, 0.9]]),
              predict_var=True)
    from gpboost_tpu_torch.convert import gp_model_from_jax_dict
    loaded = gp_model_from_jax_dict(jm.model_to_dict(), device="cpu")
    np.testing.assert_array_equal(loaded.get_coef(), jm.get_coef())
    pj, pl = jm.predict(**kw), loaded.predict(**kw)
    np.testing.assert_allclose(pl["mu"], pj["mu"], rtol=1e-10)
    np.testing.assert_allclose(pl["var"], pj["var"], rtol=1e-10)
    back = gpb.GPModel(model_dict=pm.model_to_dict())
    np.testing.assert_allclose(back.predict(**kw)["mu"],
                               pm.predict(**kw)["mu"], rtol=1e-10)
    np.testing.assert_array_equal(back.get_cov_pars(std_err=True),
                                  pm.get_cov_pars(std_err=True))


def test_float32_and_unported_options(data):
    g1, _, _, _, y = data
    m = gpt.GPModel(group_data=g1, dtype="float32", device="cpu")
    m.fit(y=y)
    assert m._engine._G.dtype == torch.float32
    assert np.all(np.isfinite(m.get_cov_pars()))
    # the iterative branch is ported (tests/test_torch_vecchia_laplace_
    # iterative.py holds it to the JAX package)
    assert gpt.GPModel(group_data=g1, device="cpu",
                       matrix_inversion_method="iterative"
                       )._engine.matrix_inversion_method == "iterative"
    # weights are ported (tests/test_torch_weights_clusters.py)
    assert gpt.GPModel(group_data=g1, device="cpu", weights=np.ones(N)
                       )._engine.weights is not None
    for kw in (dict(num_parallel_devices=2),
               dict(drop_intercept_group_rand_effect=[True])):
        with pytest.raises(NotImplementedError):
            gpt.GPModel(group_data=g1, device="cpu", **kw)
    # adam is ported (tests/test_torch_svc_sampling_adam.py holds its
    # iterations to the JAX package's)
    m = gpt.GPModel(group_data=g1, device="cpu").fit(
        y=y, params={"optimizer_cov": "adam"})
    assert 51 < m.get_num_optim_iter() <= 10000
    assert np.all(np.isfinite(m.get_cov_pars()))


# ---------------------------------------------------------------------
# the R suite's goldens on the port (tests/test_grouped_re_golden.py)
def _sim(n, init_c):
    return sim_rand_unif(n, init_c=init_c, mod_lcg=134456, mult=8121,
                         inc=28411)


@pytest.fixture(scope="module")
def re_sim_data():
    """test_GPModel_grouped_random_effects.R:25-49."""
    n, m = 1000, 100
    group = np.zeros(n, dtype=int)
    for i in range(m):
        group[i * (n // m):(i + 1) * (n // m)] = i + 1
    b1 = qnorm(_sim(m, 0.546))
    n_gr = n // 20
    group2 = np.tile(np.arange(1, n_gr + 1), n // n_gr)
    b2 = qnorm(_sim(n_gr, 0.46))
    x = np.cos((np.arange(1, n + 1) - n / 2) ** 2 * 5.5 * np.pi / n)
    b3 = qnorm(_sim(m, 0.69))
    xi = np.sqrt(0.5) * qnorm(_sim(n, 0.1))
    return {"group": group, "group2": group2, "b1": b1, "b2": b2, "b3": b3,
            "x": x, "xi": xi, "y": b1[group - 1] + xi}


def _interleaved(model):
    return np.asarray(model.get_cov_pars(std_err=True)).T.ravel()


def _fit_port(d, params):
    m = gpt.GPModel(group_data=d["group"], device="cpu")
    return m.fit(y=d["y"], params=params)


def test_golden_fisher_scoring(re_sim_data):
    m = _fit_port(re_sim_data, dict(
        optimizer_cov="fisher_scoring", std_dev=True,
        convergence_criterion="relative_change_in_parameters"))
    expected = np.array([0.49348532, 0.02326312, 1.22299521, 0.17995161])
    assert np.sum(np.abs(_interleaved(m) - expected)) < 1e-6
    assert m.get_num_optim_iter() == 5


@pytest.mark.parametrize("params,tol", [
    (dict(lr_cov=0.1, use_nesterov_acc=False), 1e-5),
    (dict(lr_cov=0.2, use_nesterov_acc=True, acc_rate_cov=0.1), 1e-5),
    (dict(lr_cov=10.0, use_nesterov_acc=False), 1e-6)])
def test_golden_gradient_descent(re_sim_data, params, tol):
    m = _fit_port(re_sim_data, dict(
        optimizer_cov="gradient_descent", maxit=1000,
        convergence_criterion="relative_change_in_parameters", **params))
    expected = np.array([0.49348532, 1.22299521])
    assert np.sum(np.abs(m.get_cov_pars() - expected)) < tol


def test_golden_nelder_mead(re_sim_data):
    m = _fit_port(re_sim_data, dict(optimizer_cov="nelder_mead",
                                    delta_rel_conv=1e-6, std_dev=True))
    expected = np.array([0.49348532, 0.02326312, 1.22299521, 0.17995161])
    assert np.sum(np.abs(_interleaved(m) - expected)) < 1e-3


def test_golden_lbfgs_fixed_pars(re_sim_data):
    m = _fit_port(re_sim_data, dict(
        optimizer_cov="lbfgs", estimate_cov_par_index=[1, 0],
        init_cov_pars=[0.23, 0.45], std_dev=True))
    expected = np.array([0.50600551128, 0.02385332856, 0.45, 0.07083578226])
    assert np.sum(np.abs(_interleaved(m) - expected)) < 1e-6
    assert abs(m.get_current_neg_log_likelihood() - 1229.514733) < 1e-6


def test_golden_two_random_effects_plus_slope(re_sim_data):
    d = re_sim_data
    y = (d["b1"][d["group"] - 1] + d["b2"][d["group2"] - 1]
         + d["x"] * d["b3"][d["group"] - 1] + d["xi"])
    m = gpt.GPModel(group_data=np.column_stack([d["group"], d["group2"]]),
                    group_rand_coef_data=d["x"],
                    ind_effect_group_rand_coef=[1], device="cpu")
    pars = m.fit(y=y, params=dict(optimizer_cov="lbfgs")).get_cov_pars()
    assert pars.shape[0] == 4
    assert np.all(pars > 0.05)
    assert abs(pars[0] - 0.5) < 0.3


def test_golden_linear_covariates(gp_sim_data):
    """tests/test_linear_covariates_golden.py on the port (dense GP)."""
    d = gp_sim_data
    y = d["eps"] + d["X"] @ np.array([2.0, 2.0]) + d["xi"]
    iu = np.triu_indices(100, k=1)
    init = [np.var(y, ddof=1) / 2, np.var(y, ddof=1) / 2,
            np.mean(d["D"][iu]) / 3]
    m = gpt.GPModel(gp_coords=d["coords"], cov_function="exponential",
                    device="cpu")
    m.fit(y=y, X=d["X"], params=dict(
        optimizer_cov="fisher_scoring", optimizer_coef="wls",
        delta_rel_conv=1e-6, use_nesterov_acc=False,
        convergence_criterion="relative_change_in_parameters",
        init_cov_pars=init, std_dev=True))
    exp_cov = np.array([0.008461342, 0.069973492, 1.001562822,
                        0.214358560, 0.094656409, 0.029400407])
    exp_coef = np.array([2.30780026, 0.21365770, 1.89951426, 0.09484768])
    coef_i = np.asarray(m.get_coef(std_err=True)).T.ravel()
    assert np.sum(np.abs(_interleaved(m) - exp_cov)) < TOLERANCE_STRICT
    assert np.sum(np.abs(coef_i - exp_coef)) < TOLERANCE_STRICT
    assert abs(m.get_current_neg_log_likelihood() - 121.482402) \
        < TOLERANCE_STRICT
    coord_test = np.column_stack([[0.1, 0.2, 0.201], [0.9, 0.4, 0.401]])
    X_test = np.column_stack([np.ones(3), [-0.5, 0.2, 0.4]])
    pred = m.predict(gp_coords_pred=coord_test, X_pred=X_test,
                     predict_cov_mat=True, predict_response=True)
    exp_mu = np.array([1.196952, 4.063324, 4.446861])
    exp_cov_p = np.array(
        [6.305383e-01, 1.358861e-05, 1.414550e-05, 1.358861e-05,
         3.469270e-01, 3.282926e-01, 1.414550e-05, 3.282926e-01,
         3.561731e-01])
    assert np.sum(np.abs(pred["mu"] - exp_mu)) < TOLERANCE_STRICT
    assert np.sum(np.abs(pred["cov"].ravel() - exp_cov_p)) < TOLERANCE_STRICT
