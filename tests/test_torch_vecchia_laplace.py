"""The Vecchia-Laplace engine (dense-precision path) of the PyTorch port and
Vecchia LaGaBoost, against the JAX package and the R suite's goldens.

* The goldens of tests/test_vecchia_laplace_golden.py (n = 100, 99
  neighbours, ordering "none", bernoulli_probit) on the port alone, at that
  file's tolerances (1e-6, 1e-3).
* Parity with the JAX engine at n = 200, 10 neighbours, random and "none"
  orderings, float64: NLL, g_u and g_F to rtol 1e-8, equal Newton steps, the
  mode to 1e-8, predictions to 1e-6; the port's pattern assembly of
  Q = B' D^-1 B against the reference's dense product to 1e-12.
* Vecchia LaGaBoost against the exact one at m = n - 1
  (test_lagaboost_golden.py TestVecchiaEquivalenceBinary, on the port
  alone, its tolerances 2e-2 and 5e-2), and one LaGaBoost round against the
  JAX host loop (gradient in F and the first tree).
* Model dicts both ways, and what must raise.

The JAX side builds one engine per shape, so its compiles stay few.
"""

import os
import sys

import numpy as np
import pytest
import torch
from scipy.stats import norm

import gpboost_tpu as gpb
from gpboost_tpu.likelihoods.base import get_likelihood as jax_lik
from gpboost_tpu.models.components import GPComponent as JaxGP
from gpboost_tpu.models.vecchia_laplace import VecchiaLaplaceEngine as JaxVL
from gpboost_tpu.ops.cov_fcts import CovarianceFunction as JaxCov

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.convert import (booster_from_jax_dict,
                                       gp_model_from_jax_dict)
from gpboost_tpu_torch.likelihoods.base import get_likelihood as port_lik
from gpboost_tpu_torch.models.components import GPComponent
from gpboost_tpu_torch.models.fitc_laplace import FITCLaplaceEngine
from gpboost_tpu_torch.models.vecchia_laplace import VecchiaLaplaceEngine
from gpboost_tpu_torch.ops.cov_fcts import CovarianceFunction

sys.path.insert(0, os.path.dirname(__file__))
from test_lagaboost_golden import sim_friedman3, sim_rand_unif  # noqa: E402
from test_vecchia_laplace_golden import vl_data  # noqa: E402,F401

torch.set_num_threads(1)

TOL_STRICT, TOL_MEDIUM = 1e-6, 1e-3
N, M, P = 200, 10, 4


def _sim(n=N, seed=0):
    rng = np.random.RandomState(seed)
    coords = rng.rand(n, 2)
    X = rng.rand(n, P)
    lat = (np.sin(3 * X[:, 0]) + X[:, 1] ** 2 - 1.0
           + 0.8 * np.sin(6 * coords[:, 0]) * np.cos(4 * coords[:, 1]))
    y = (rng.rand(n) < norm.cdf(lat)).astype(float)
    return coords, X, y


# ----------------------------------------------------------------------
# the R goldens on the port
def _golden_model(coords):
    return gpt.GPModel(gp_coords=coords, cov_function="exponential",
                       likelihood="bernoulli_probit", gp_approx="vecchia",
                       num_neighbors=99, vecchia_ordering="none",
                       matrix_inversion_method="cholesky", device="cpu")


def test_golden_nll(vl_data):  # noqa: F811
    coords, _, y, _ = vl_data
    nll = _golden_model(coords).neg_log_likelihood(cov_pars=[1.0, 0.2], y=y)
    assert abs(nll - 67.18342059) < TOL_STRICT


def test_golden_estimation_with_covariates_and_prediction(vl_data):  # noqa
    coords, D, y, X = vl_data
    iu = np.triu_indices(100, k=1)
    m = _golden_model(coords)
    m.fit(y=y, X=X, params=dict(
        optimizer_cov="gradient_descent", optimizer_coef="gradient_descent",
        use_nesterov_acc=True, lr_cov=0.1, lr_coef=0.1, maxit=1000,
        acc_rate_cov=0.5, init_cov_pars=[1.0, np.mean(D[iu]) / 3]))
    assert np.sum(np.abs(m.get_cov_pars()
                         - [0.92350821208, 0.05944214192])) < TOL_STRICT
    assert np.sum(np.abs(m.get_coef() - [0.3983333, -0.2653886])) \
        < TOL_STRICT
    assert m.get_num_optim_iter() == 17
    coord_test = np.column_stack([[0.1, 0.11, 0.7], [0.9, 0.91, 0.55]])
    X_test = np.column_stack([np.ones(3), [-0.5, 0.2, 1.0]])
    pred = m.predict(y=y, gp_coords_pred=coord_test, predict_var=True,
                     predict_response=False, cov_pars=[1.0, 0.2],
                     X_pred=X_test)
    assert np.sum(np.abs(pred["mu"]
                         - [0.3389905, 0.1512445, -0.1039307])) < TOL_MEDIUM
    assert np.sum(np.abs(pred["var"]
                         - [0.6193229, 0.6159349, 0.4291674])) < TOL_MEDIUM
    predr = m.predict(y=y, gp_coords_pred=coord_test, predict_var=True,
                      predict_response=True, cov_pars=[1.0, 0.2],
                      X_pred=X_test)
    assert np.sum(np.abs(predr["mu"]
                         - [0.6050312, 0.5473537, 0.4653610])) < TOL_MEDIUM
    assert np.sum(np.abs(predr["var"]
                         - [0.2389684, 0.2477576, 0.2488001])) < TOL_MEDIUM


# ----------------------------------------------------------------------
# the engine against the JAX engine
@pytest.fixture(scope="module", params=["random", "none"])
def engines(request):
    coords, _, y = _sim()
    kw = dict(num_neighbors=M, vecchia_ordering=request.param)
    je = JaxVL([JaxGP(coords, JaxCov("exponential"))], N,
               jax_lik("bernoulli_probit"), **kw)
    pe = VecchiaLaplaceEngine(
        [GPComponent(coords, CovarianceFunction("exponential"))], N,
        port_lik("bernoulli_probit"), device="cpu", **kw)
    return je, pe, coords, y


def test_nll_gradients_and_newton_steps_match_jax(engines):
    je, pe, _, y = engines
    u = np.log([0.9, 1.0 / 0.15])
    F = 0.3 * np.sin(np.arange(N))
    nj, guj, gFj, bj = je.laplace_vag_F(u, y, F, je.zero_mode())
    npt, gup, gFp, bp = pe.laplace_vag_F(u, y, F, pe.zero_mode())
    np.testing.assert_allclose(npt, nj, rtol=1e-8)
    np.testing.assert_allclose(gup, guj, rtol=1e-8)
    np.testing.assert_allclose(gFp, gFj, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(gFj)))
    np.testing.assert_allclose(bp.numpy(), np.asarray(bj), rtol=0, atol=1e-8)
    assert pe.last_num_mode_it == je.last_num_mode_it
    # from a warm start, as the optimizers call it; y and F as tensors in
    # data order, as LaGaBoost passes them
    nj2, bj2 = je.laplace_nll(u + 0.05, y, F, bj)
    np2, bp2 = pe.laplace_nll(u + 0.05, torch.as_tensor(y),
                              torch.as_tensor(F), bp)
    np.testing.assert_allclose(np2, nj2, rtol=1e-8)
    np.testing.assert_allclose(bp2.numpy(), np.asarray(bj2), atol=1e-8)
    assert pe.last_num_mode_it == je.last_num_mode_it


def test_predictions_match_jax(engines):
    je, pe, _, y = engines
    rng = np.random.RandomState(3)
    pred_data = {"comps": [{"coords_pred": rng.rand(15, 2)}], "n_pred": 15}
    F = 0.2 * np.cos(np.arange(N))
    F_pred = 0.1 * np.arange(15)
    for kw in (dict(predict_cov_mat=True), dict(predict_var=True),
               dict(predict_var=True, predict_response=True),
               dict(predict_response=True)):
        pj = je.predict([0.8, 0.2], None, y, F, pred_data, F_pred=F_pred,
                        **kw)
        pp = pe.predict([0.8, 0.2], None, y, F, pred_data, F_pred=F_pred,
                        **kw)
        assert set(pp) == set(pj)
        for k in pj:
            np.testing.assert_allclose(pp[k], np.asarray(pj[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{kw} {k}")


def test_aux_parameter_and_weights_match_jax():
    """A likelihood with an aux parameter (gamma), observation weights and
    a Matern 1.5 kernel: NLL, gradients and Newton steps against the JAX
    engine, and the engine's one-Q backward against the hooks."""
    from gpboost_tpu_torch.models.laplace import _LaplaceNLL
    rng = np.random.RandomState(1)
    n = 150
    coords = rng.rand(n, 2)
    y = rng.gamma(1.5, np.exp(np.sin(6 * coords[:, 0])) / 1.5)
    w = 0.5 + rng.rand(n)
    kw = dict(num_neighbors=8, weights=w)
    je = JaxVL([JaxGP(coords, JaxCov("matern", shape=1.5))], n,
               jax_lik("gamma"), **kw)
    pe = VecchiaLaplaceEngine(
        [GPComponent(coords, CovarianceFunction("matern", shape=1.5))], n,
        port_lik("gamma"), device="cpu", **kw)
    u = np.log([0.9, 3.0, 1.3])
    F = 0.2 * np.cos(np.arange(n))
    nj, guj, gFj, _ = je.laplace_vag_F(u, y, F, je.zero_mode())
    npt, gup, gFp, _ = pe.laplace_vag_F(u, y, F, pe.zero_mode())
    np.testing.assert_allclose(npt, nj, rtol=1e-8)
    np.testing.assert_allclose(gup, guj, rtol=1e-8)
    np.testing.assert_allclose(gFp, gFj, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(gFj)))
    assert pe.last_num_mode_it == je.last_num_mode_it
    ut = torch.tensor(u, requires_grad=True)
    yv, Fv = (pe._to_vecchia(torch.as_tensor(v)) for v in (y, F))
    nll = _LaplaceNLL.apply(ut, Fv, pe, yv, pe.zero_mode())[0]
    (g_hooks,) = torch.autograd.grad(nll, ut)
    np.testing.assert_allclose(gup, g_hooks.numpy(), rtol=1e-10)


def test_fused_backward_matches_the_engine_hooks(engines):
    """The engine's one-Q backward against models/laplace.py's
    `_LaplaceNLL`, which runs the four hooks separately."""
    from gpboost_tpu_torch.models.laplace import _LaplaceNLL
    _, pe, _, y = engines
    u = torch.tensor(np.log([0.7, 1.0 / 0.2]), requires_grad=True)
    F = torch.as_tensor(0.3 * np.cos(np.arange(N))).requires_grad_(True)
    yv, Fv = pe._to_vecchia(torch.as_tensor(y)), pe._to_vecchia(F)
    out = []
    for fn in (lambda: _LaplaceNLL.apply(u, Fv, pe, yv, pe.zero_mode()),
               lambda: pe._nll_raw(u, F, torch.as_tensor(y),
                                   pe.zero_mode())[0]):
        nll = fn()
        nll = nll[0] if isinstance(nll, tuple) else nll
        out.append([nll.detach()]
                   + list(torch.autograd.grad(nll, (u, F),
                                              retain_graph=True)))
    for a, b in zip(*out):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-10,
                                   atol=1e-12)


def _dense_product_Q(pe, theta_log):
    """The reference's Q = B' (B / D) with a dense B (padded neighbours
    carry A = 0 and write no other position than their own row's)."""
    A, D = pe._vecchia._bd(theta_log, latent=True)
    n = pe.n
    rows = torch.arange(n)[:, None].expand_as(A)
    M_ = torch.zeros((n, n), dtype=A.dtype).index_put(
        (rows, pe._vecchia._nn_idx), A)
    B = torch.eye(n, dtype=A.dtype) - M_
    return B.T @ (B / D[:, None])


def test_precision_assembly_matches_the_dense_product(engines):
    _, pe, _, _ = engines
    theta_log = torch.tensor(np.log([0.9, 1.0 / 0.15]), requires_grad=True)
    Q, logdetQ = pe._Q_logdetQ(theta_log)
    Qd = _dense_product_Q(pe, theta_log)
    np.testing.assert_allclose(Q.detach().numpy(), Qd.detach().numpy(),
                               rtol=0, atol=1e-12 * float(Qd.abs().max()))
    np.testing.assert_array_equal(Q.detach().numpy(), Q.detach().numpy().T)
    np.testing.assert_allclose(float(logdetQ),
                               np.linalg.slogdet(Qd.detach().numpy())[1],
                               rtol=1e-10)
    # autograd reaches A and D through the assembly
    v = torch.as_tensor(np.sin(np.arange(N)))
    (g,) = torch.autograd.grad(v @ Q @ v, theta_log)
    (gd,) = torch.autograd.grad(v @ Qd @ v, theta_log)
    np.testing.assert_allclose(g.numpy(), gd.numpy(), rtol=1e-10)


# ----------------------------------------------------------------------
# Vecchia LaGaBoost
BOOST = {"objective": "binary", "learning_rate": 0.1, "num_leaves": 7,
         "min_data_in_leaf": 5, "verbose": 0}


@pytest.fixture(scope="module")
def one_round():
    """One LaGaBoost round of each package on the same data (the parity
    engines' shape, random ordering); the covariance parameters are fitted
    once, before the first tree (train_gp_model_cov_pars=False)."""
    coords, X, y = _sim()
    params = {**BOOST, "train_gp_model_cov_pars": False}
    kw = dict(gp_coords=coords, cov_function="exponential",
              likelihood="bernoulli_probit", gp_approx="vecchia",
              num_neighbors=M, matrix_inversion_method="cholesky")
    opt = {"init_cov_pars": [1.0, 0.1], "maxit": 5}
    gj = gpb.GPModel(**kw)
    gj.set_optim_params(params=opt)
    bj = gpb.train(params, gpb.Dataset(X, label=y), num_boost_round=1,
                   gp_model=gj, callbacks=[lambda env: None])
    gp = gpt.GPModel(device="cpu", **kw)
    gp.set_optim_params(params=opt)
    bp = gpt.Booster(params, gpt.Dataset(X, label=y), gp_model=gp,
                     device="cpu")
    grad, _ = bp._gradients()
    bp.update()
    return bj, gj, bp, gp, grad, coords, X, y


def test_one_lagaboost_round_matches_jax(one_round):
    bj, gj, bp, gp, grad, _, _, y = one_round
    np.testing.assert_allclose(bp.init_score, bj.init_score, rtol=1e-8)
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-6)
    r = gj._fit_result
    u = np.log(gj._engine.transform_pars(r.cov_pars))
    _, _, gFj, _ = gj._engine.laplace_vag_F(
        u, y, np.full(N, bj.init_score), r.mode_state)
    np.testing.assert_allclose(grad.numpy(), np.asarray(gFj), rtol=1e-8,
                               atol=1e-10)
    tj, tp = bj.trees[0], bp.trees[0]
    nn = tj.num_nodes
    internal = ~tj.is_leaf[:nn]
    assert tp.num_nodes == nn
    np.testing.assert_array_equal(tp.split_feature[:nn][internal],
                                  tj.split_feature[:nn][internal])
    np.testing.assert_array_equal(tp.threshold_bin[:nn][internal],
                                  tj.threshold_bin[:nn][internal])
    np.testing.assert_allclose(bp.F.numpy(), bj.F, rtol=0, atol=1e-6)


def test_model_dicts_both_ways(one_round):
    bj, gj, bp, gp, _, coords, X, y = one_round
    rng = np.random.RandomState(5)
    cn, Xn = rng.rand(10, 2), rng.rand(10, P)
    # a GP model and a booster of the JAX package predict the same here
    g2 = gp_model_from_jax_dict(gj.model_to_dict(), device="cpu")
    for resp in (False, True):
        pj = gj.predict(gp_coords_pred=cn, predict_var=True,
                        predict_response=resp)
        pp = g2.predict(gp_coords_pred=cn, predict_var=True,
                        predict_response=resp)
        for k in ("mu", "var"):
            np.testing.assert_allclose(pp[k], np.asarray(pj[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
    b2, _ = booster_from_jax_dict(bj.model_to_dict(), device="cpu")
    for latent in (True, False):
        pj = bj.predict(Xn, gp_coords_pred=cn, predict_var=True,
                        pred_latent=latent)
        pp = b2.predict(Xn, gp_coords_pred=cn, predict_var=True,
                        pred_latent=latent)
        assert set(pp) == set(pj)
        for k in pj:
            np.testing.assert_allclose(pp[k], np.asarray(pj[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
    # and the port's booster loads in the JAX package
    bj2 = gpb.Booster(model_dict=bp.model_to_dict())
    pp = bp.predict(Xn, gp_coords_pred=cn, predict_var=True)
    pj = bj2.predict(Xn, gp_coords_pred=cn, predict_var=True)
    for k in pp:
        np.testing.assert_allclose(np.asarray(pj[k]), pp[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    re = bp.predict_training_data_random_effects()
    assert re["GP_1"].shape == (N,) and np.all(np.isfinite(re["GP_1"]))


class TestVecchiaEquivalenceBinary:
    """test_lagaboost_golden.py TestVecchiaEquivalenceBinary (R:1395) on
    the port: exact == Vecchia at m = n - 1 for LaGaBoost."""

    @pytest.fixture(scope="class")
    def vdata(self):
        ntrain = 100
        n = 2 * ntrain
        X, f = sim_friedman3(n, init_c=0.69)
        f = f - f.mean()
        coords = np.reshape(sim_rand_unif(n * 2, 0.63), (2, n)).T.copy()
        D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
        eps = np.linalg.cholesky(np.exp(-D / 0.1) + 1e-20 * np.eye(n)) \
            @ norm.ppf(sim_rand_unif(n, 0.987864))
        y = (sim_rand_unif(n, 0.52574) < norm.cdf(f + eps)).astype(float)
        Dtr = D[:ntrain, :ntrain]
        return dict(ntrain=ntrain, X=X, y=y, coords=coords,
                    init_cov=[1.0,
                              np.mean(Dtr[np.triu_indices(ntrain, 1)]) / 3])

    def _fit(self, d, **gp_kwargs):
        nt = d["ntrain"]
        gp = gpt.GPModel(gp_coords=d["coords"][:nt],
                         cov_function="exponential",
                         likelihood="bernoulli_probit", device="cpu",
                         **gp_kwargs)
        gp.set_optim_params(params={
            "optimizer_cov": "gradient_descent", "use_nesterov_acc": True,
            "delta_rel_conv": 1e-6, "lr_cov": 0.1, "lr_coef": 0.1,
            "init_cov_pars": d["init_cov"],
            "init_coef_aux_pars_from_iid_model": False})
        ds = gpt.Dataset(d["X"][:nt], label=d["y"][:nt])
        bst = gpt.train({"learning_rate": 0.5, "max_depth": 6,
                         "min_data_in_leaf": 5, "objective": "binary",
                         "verbose": 0}, ds, num_boost_round=5, gp_model=gp)
        return gp, bst

    def test_equivalence(self, vdata):
        d = vdata
        nt = d["ntrain"]
        gp_e, bst_e = self._fit(d)
        cp_e = np.asarray(gp_e.get_cov_pars()).ravel()
        assert np.all(cp_e > 0) and np.all(cp_e < 2.0)
        pe = bst_e.predict(d["X"][nt:], gp_coords_pred=d["coords"][nt:],
                           predict_var=True, pred_latent=True)
        for ordering in ("none", "random"):
            gp_v, bst_v = self._fit(d, gp_approx="vecchia",
                                    num_neighbors=nt - 1,
                                    vecchia_ordering=ordering)
            cp_v = np.asarray(gp_v.get_cov_pars()).ravel()
            assert np.sum(np.abs(cp_v - cp_e)) < 2e-2, ordering
            gp_v.set_prediction_data(
                vecchia_pred_type="latent_order_obs_first_cond_all",
                num_neighbors_pred=2 * nt - 1)
            pv = bst_v.predict(d["X"][nt:], gp_coords_pred=d["coords"][nt:],
                               predict_var=True, pred_latent=True)
            assert np.sum(np.abs(pv["random_effect_mean"][-4:]
                                 - pe["random_effect_mean"][-4:])) < 5e-2
            assert np.sum(np.abs(pv["random_effect_cov"][-4:]
                                 - pe["random_effect_cov"][-4:])) < 5e-2


# ----------------------------------------------------------------------
def test_unported_parts_raise():
    coords, _, y = _sim(n=50)
    kw = dict(gp_coords=coords, cov_function="exponential",
              likelihood="bernoulli_probit", gp_approx="vecchia",
              device="cpu")
    # "iterative" takes the matrix-free engine, and so does the
    # reference's auto rule above n = 8,000 (nothing n x n is built)
    from gpboost_tpu_torch.models.vecchia_laplace import \
        VecchiaLaplaceIterativeEngine
    assert isinstance(gpt.GPModel(matrix_inversion_method="iterative",
                                  **kw)._engine,
                      VecchiaLaplaceIterativeEngine)
    with pytest.raises(NotImplementedError, match="cluster_ids"):
        gpt.GPModel(cluster_ids=np.arange(50) % 2, **kw)
    big = np.random.RandomState(0).rand(8001, 2)
    assert isinstance(gpt.GPModel(**{**kw, "gp_coords": big})._engine,
                      VecchiaLaplaceIterativeEngine)
    assert gpt.GPModel(**kw)._engine.matrix_inversion_method == "cholesky"
    with pytest.raises(ValueError, match="predict_var"):
        gp = gpt.GPModel(**kw).fit(y=y, params={"maxit": 1})
        gp.predict_training_data_random_effects(predict_var=True)
    # a two-predictor likelihood: F holds both blocks (2n), and the NLL
    # moves with the second block (tests/test_torch_two_predictor.py holds
    # the engine to the JAX package and the R goldens)
    eng = VecchiaLaplaceEngine(
        [GPComponent(coords, CovarianceFunction("exponential"))], 50,
        port_lik("zero_inflated_regression_poisson"), device="cpu")
    assert eng.num_sets_fe == 2
    yz = np.where(np.arange(50) % 3 == 0, 0.0, 2.0)
    nlls = [eng.neg_log_likelihood([1.0, 0.2], yz, fixed_effects=np.r_[
        np.zeros(50), np.full(50, z)]) for z in (-1.0, 1.0)]
    assert np.all(np.isfinite(nlls)) and nlls[0] != nlls[1]
    with pytest.raises(ValueError, match="num_sets_fe"):
        eng.neg_log_likelihood([1.0, 0.2], yz, fixed_effects=np.zeros(50))
    # gp_approx="fitc" takes the FITC-Laplace engine (tests/test_torch_
    # fitc.py holds it to the JAX package)
    assert isinstance(gpt.GPModel(**{**kw, "gp_approx": "fitc"})._engine,
                      FITCLaplaceEngine)
