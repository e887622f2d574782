"""FITC and FITC-Laplace in the PyTorch port against the JAX package.

models/fitc.py and models/fitc_laplace.py against gpboost_tpu.models.fitc
and .fitc_laplace, float64, on the R suite's GP data (tests/conftest.py
gp_sim_data, n = 100) and on test_fitc_laplace.py's Poisson data
(n = 200):

  * the kmeans++ centres equal the JAX package's bit for bit;
  * Gaussian FITC: NLL and gradients to rtol 1e-10 (with and without
    observation weights), a gradient-descent fit with covariates to rtol
    1e-6 with the same iteration count, predictions with variances to
    1e-10, Psi~^-1 M to 1e-10;
  * FITC-Laplace: NLL to rtol 1e-7, gradients in
    u (the gamma shape among them) and F to rtol 1e-5, the same Newton
    steps, latent variances to rtol 1e-6, the mean and the response
    scale to rtol 3e-4 (atol 1e-4).
    Its latent Sigma^-1 is ill-conditioned where a kmeans++ centre
    meets a data point (the FITC diagonal there is ~1e-10), so the two
    packages' roundings of the same products differ at that scale
    (~1e-8 relative in the NLL);
  * one GPBoost round with a FITC model and one (Poisson) LaGaBoost
    round with a FITC-Laplace model against the JAX host loop: trees
    alike, scores and parameters to rtol 1e-6, predictions to 1e-6
    (Gaussian) and 1e-4 (Poisson, whose predictions re-find the mode;
    the refit capped at 10 gradient steps); model dicts both ways;
  * the goldens of tests/test_fitc.py and tests/test_fitc_laplace.py on
    the port, at those files' tolerances.
"""

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
from gpboost_tpu.boosting.gbdt import _psi_tilde_inv_mat as jax_psi_inv_mat
from gpboost_tpu.models.fitc import kmeanspp_indices as jax_kmeanspp

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.convert import (booster_from_jax_dict,
                                       gp_model_from_jax_dict)
from gpboost_tpu_torch.models.fitc import kmeanspp_indices
from gpboost_tpu_torch.models.fitc_laplace import FITCLaplaceEngine

from conftest import TOLERANCE_LOOSE, TOLERANCE_MEDIUM, TOLERANCE_STRICT

torch.set_num_threads(1)

PARS = [0.1, 1.6, 0.2]
COORD_TEST = np.column_stack([[0.1, 0.2, 0.7], [0.9, 0.4, 0.55]])


@pytest.fixture(scope="module")
def pois_data():
    """tests/test_fitc_laplace.py's data."""
    rng = np.random.RandomState(0)
    n = 200
    coords = rng.rand(n, 2)
    D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    lat = np.linalg.cholesky(np.exp(-D / 0.2) + 1e-8 * np.eye(n)) \
        @ rng.randn(n)
    y = rng.poisson(np.exp(0.3 + lat)).astype(float)
    return dict(coords=coords, y=y, pred=rng.rand(6, 2))


def _pair(**kw):
    return gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)


@pytest.mark.parametrize("n,k,d,seed", [(100, 30, 2, 0), (500, 60, 3, 3),
                                        (1000, 200, 2, 7), (300, 300, 9, 1),
                                        (9000, 40, 1, 2)])
def test_kmeanspp_centres_equal(n, k, d, seed):
    """Bit for bit, in 1-3 dimensions (the port's row-blocked assignment
    adds the squares as numpy's small sums do), in 9 (numpy's pairwise
    sum) and with more rows than one block."""
    coords = np.random.RandomState(seed).rand(n, d)
    np.testing.assert_array_equal(kmeanspp_indices(coords, k, seed=seed),
                                  jax_kmeanspp(coords, k, seed=seed))


# ---------------------------------------------------------------------
# Gaussian FITC
@pytest.fixture(scope="module")
def gauss(gp_sim_data):
    """(JAX, port) FITC models with 40 kmeans++ inducing points, shared by
    the tests below (the JAX engine compiles once)."""
    return _pair(gp_coords=gp_sim_data["coords"], cov_function="exponential",
                 gp_approx="fitc", num_ind_points=40)


@pytest.mark.parametrize("weighted", [False, True])
def test_gaussian_nll_and_gradients(gp_sim_data, gauss, weighted):
    d = gp_sim_data
    if weighted:
        w = np.random.RandomState(1).uniform(0.5, 2.0, d["n"])
        mj, mt = _pair(gp_coords=d["coords"], cov_function="exponential",
                       gp_approx="fitc", num_ind_points=40, weights=w)
    else:
        mj, mt = gauss
    np.testing.assert_array_equal(mt._engine.ip, mj._engine.ip)
    ej, et = mj._engine, mt._engine
    t = et.transform_pars(PARS)
    yt = et.prep_y(d["y"])
    vj, gj = ej.grad_profiled(np.log(t[1:]), t[0], d["y"])
    vt, gt_ = et.grad_profiled(np.log(t[1:]), t[0], yt)
    np.testing.assert_allclose(vt, float(vj), rtol=1e-10)
    np.testing.assert_allclose(gt_, np.asarray(gj), rtol=1e-10)
    if weighted:
        return
    np.testing.assert_allclose(mt.neg_log_likelihood(PARS, d["y"]),
                               mj.neg_log_likelihood(PARS, d["y"]),
                               rtol=1e-10)
    (pj, _), gpj = ej.nll_profiled_vag(np.log(t[1:]), d["y"])
    (pt, _), gpt_ = et.nll_profiled_vag(np.log(t[1:]), yt)
    np.testing.assert_allclose(pt, float(pj), rtol=1e-10)
    np.testing.assert_allclose(gpt_, np.asarray(gpj), rtol=1e-10)
    M = np.random.RandomState(2).randn(d["n"], 3)
    np.testing.assert_allclose(
        et.psi_tilde_inv_mat(t, torch.as_tensor(M)).numpy(),
        jax_psi_inv_mat(ej, t, M), rtol=1e-10, atol=1e-12)
    with pytest.raises(NotImplementedError, match="fisher_scoring"):
        et.fisher_transformed(np.log(t))


def test_gaussian_fit_and_predict(gp_sim_data, gauss):
    d = gp_sim_data
    mj, mt = gauss
    y = d["y"] + d["X"] @ d["beta"]
    for m in (mj, mt):
        m.fit(y=y, X=d["X"], params={"optimizer_cov": "gradient_descent",
                                     "maxit": 20})
    np.testing.assert_allclose(mt.get_cov_pars(), mj.get_cov_pars(),
                               rtol=1e-6)
    np.testing.assert_allclose(mt.get_coef(), mj.get_coef(), rtol=1e-6)
    assert mt.get_num_optim_iter() == mj.get_num_optim_iter()
    kw = dict(gp_coords_pred=COORD_TEST, X_pred=np.ones((3, 2)),
              cov_pars=PARS)
    for extra in (dict(predict_var=True), dict(predict_cov_mat=True),
                  dict(predict_var=True, predict_response=False)):
        pj, pt = mj.predict(**kw, **extra), mt.predict(**kw, **extra)
        for key in ("mu", "var", "cov"):
            if pj.get(key) is not None:
                np.testing.assert_allclose(pt[key], np.asarray(pj[key]),
                                           rtol=1e-10, atol=1e-13,
                                           err_msg=key)


# ---------------------------------------------------------------------
# FITC-Laplace
@pytest.fixture(scope="module")
def pois(pois_data):
    return _pair(gp_coords=pois_data["coords"], cov_function="exponential",
                 likelihood="poisson", gp_approx="fitc", num_ind_points=60)


def test_laplace_nll_gradients_and_modes(pois_data, pois):
    d = pois_data
    mj, mt = pois
    assert isinstance(mt._engine, FITCLaplaceEngine)
    np.testing.assert_array_equal(mt._engine.ip, mj._engine.ip)
    u, F = np.log([1.0, 5.0]), 0.1 * np.sin(d["coords"][:, 0])
    rj = mj._engine.laplace_vag_F(u, d["y"], F, mj._engine.zero_mode())
    rt = mt._engine.laplace_vag_F(u, d["y"], F, mt._engine.zero_mode())
    assert mt._engine.last_num_mode_it == mj._engine.last_num_mode_it
    np.testing.assert_allclose(rt[0], rj[0], rtol=1e-7)
    np.testing.assert_allclose(rt[1], rj[1], rtol=1e-5)
    np.testing.assert_allclose(rt[2], rj[2], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(rt[3].numpy(), np.asarray(rj[3]), rtol=1e-5,
                               atol=1e-8)


def test_laplace_predictions(pois_data, pois):
    d = pois_data
    mj, mt = pois
    for extra in (dict(predict_var=True, predict_response=False),
                  dict(predict_cov_mat=True, predict_response=False),
                  dict(predict_var=True, predict_response=True)):
        kw = dict(gp_coords_pred=d["pred"], cov_pars=[0.8, 0.18], y=d["y"],
                  **extra)
        pj, pt = mj.predict(**kw), mt.predict(**kw)
        latent = not extra["predict_response"]
        for key in ("mu", "var", "cov"):
            if pj.get(key) is not None:
                # the latent variances to 1e-6; the mean, and through it
                # the response, carries the mode's rounding (~2e-5)
                rtol, atol = (1e-6, 4e-7) if latent and key != "mu" \
                    else (3e-4, 1e-4)
                np.testing.assert_allclose(pt[key], np.asarray(pj[key]),
                                           rtol=rtol, atol=atol,
                                           err_msg=key)


def test_laplace_gamma_aux_gradient(pois_data):
    """The gamma shape rides u as its log; NLL and gradients in u, F."""
    d = pois_data
    mj, mt = _pair(gp_coords=d["coords"], cov_function="exponential",
                   likelihood="gamma", gp_approx="fitc", num_ind_points=60)
    y = d["y"] + 0.5
    u = np.log([0.5, 4.0, 2.0])
    rj = mj._engine.laplace_vag(u, y, np.zeros(len(y)),
                                mj._engine.zero_mode())
    rt = mt._engine.laplace_vag(u, y, np.zeros(len(y)),
                                mt._engine.zero_mode())
    np.testing.assert_allclose(rt[0], rj[0], rtol=1e-7)
    np.testing.assert_allclose(rt[1], rj[1], rtol=1e-5)


# ---------------------------------------------------------------------
# one boosting round each, against the JAX host loop; the JAX side reuses
# the fixtures' models, whose engines have compiled already
def _splits(tree):
    nn = tree.num_nodes
    internal = ~tree.is_leaf[:nn]
    return (tree.is_leaf[:nn].tolist(),
            tree.split_feature[:nn][internal].tolist(),
            tree.threshold_bin[:nn][internal].tolist())


def _boost_both(params, models, X, y, opt):
    gj, gp_like = models
    gp = gpt.GPModel(device="cpu", **gp_like)
    gj.set_optim_params(params=opt)
    gp.set_optim_params(params=opt)
    bj = gpb.train(params, gpb.Dataset(X, label=y), num_boost_round=1,
                   gp_model=gj, callbacks=[lambda env: None])
    bp = gpt.train(params, gpt.Dataset(X, label=y), num_boost_round=1,
                   gp_model=gp)
    assert [_splits(t) for t in bp.trees] == [_splits(t) for t in bj.trees]
    np.testing.assert_allclose(bp.F.numpy(), bj.F, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-6)
    return bj, bp


def test_fitc_gpboost_round(gp_sim_data, gauss):
    d = gp_sim_data
    rng = np.random.RandomState(4)
    X = rng.rand(d["n"], 4)
    y = 2 * X[:, 0] + 2 * np.sin(8 * X[:, 1]) + d["y"]
    bj, bp = _boost_both(
        {"objective": "regression", "learning_rate": 0.1, "num_leaves": 7,
         "min_data_in_leaf": 10, "verbose": 0, "leaves_newton_update": True},
        (gauss[0], dict(gp_coords=d["coords"], cov_function="exponential",
                        gp_approx="fitc", num_ind_points=40)),
        X, y, {"optimizer_cov": "gradient_descent", "maxit": 20})
    # at test_gaussian_fit_and_predict's shapes, whose compiles it shares
    Xn, cn = rng.rand(3, 4), COORD_TEST
    pj = bj.predict(Xn, gp_coords_pred=cn, predict_var=True)
    pp = bp.predict(Xn, gp_coords_pred=cn, predict_var=True)
    for k in ("response_mean", "response_var"):
        np.testing.assert_allclose(pp[k], np.asarray(pj[k]), rtol=1e-6,
                                   err_msg=k)
    # the JAX booster's dict loads in the port and predicts the same
    b3, g3 = booster_from_jax_dict(bj.model_to_dict(), device="cpu")
    assert g3.gp_approx == "fitc" and g3.num_ind_points == 40
    p3 = b3.predict(Xn, gp_coords_pred=cn, predict_var=True)
    for k in ("response_mean", "response_var"):
        np.testing.assert_allclose(p3[k], np.asarray(pj[k]), rtol=1e-8)


def test_fitc_lagaboost_round(pois_data, pois):
    d = pois_data
    rng = np.random.RandomState(5)
    X = rng.rand(len(d["y"]), 4)
    opt = {"optimizer_cov": "gradient_descent", "use_nesterov_acc": False,
           "delta_rel_conv": 1e-6, "lr_cov": 0.01, "maxit": 10,
           "init_coef_aux_pars_from_iid_model": False}
    bj, bp = _boost_both(
        {"learning_rate": 0.1, "max_depth": 6, "min_data_in_leaf": 5,
         "verbose": 0},
        (pois[0], dict(gp_coords=d["coords"], cov_function="exponential",
                       likelihood="poisson", gp_approx="fitc",
                       num_ind_points=60)),
        X, d["y"], opt)
    assert bp.objective_name == "poisson"
    Xn = rng.rand(len(d["pred"]), 4)
    for latent in (True, False):
        pj = bj.predict(Xn, gp_coords_pred=d["pred"], predict_var=True,
                        pred_latent=latent)
        pp = bp.predict(Xn, gp_coords_pred=d["pred"], predict_var=True,
                        pred_latent=latent)
        assert set(pp) == set(pj)
        for k in pj:
            np.testing.assert_allclose(pp[k], np.asarray(pj[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("likelihood", ["gaussian", "poisson"])
def test_model_dicts_both_ways(pois_data, likelihood):
    """A fitted port model's dict builds the same FITC model in the JAX
    package (inducing points, parameters), and the JAX dict of that model
    builds the port's again, which predicts as the first (the Gaussian
    model's predictions also against the JAX package's)."""
    d = pois_data
    kw = dict(gp_coords=d["coords"], cov_function="exponential",
              gp_approx="fitc", num_ind_points=30, seed=3,
              likelihood=likelihood)
    pars = [0.3, 1.0, 0.2] if likelihood == "gaussian" else [1.0, 0.2]
    mt = gpt.GPModel(device="cpu", **kw)
    mt.set_optim_params({"init_cov_pars": pars, "maxit": 2})
    mt.fit(y=d["y"])
    mj = gpb.GPModel(model_dict=mt.model_to_dict())
    np.testing.assert_array_equal(mj._engine.ip, mt._engine.ip)
    np.testing.assert_allclose(mj.get_cov_pars(), mt.get_cov_pars(),
                               rtol=1e-15)
    dj = mj.model_to_dict()
    for key in ("num_ind_points", "ind_points_selection", "seed",
                "cov_fct_taper_range", "cov_fct_taper_shape"):
        assert dj[key] == mt.model_to_dict()[key], key
    m2 = gp_model_from_jax_dict(dj, device="cpu")
    np.testing.assert_array_equal(m2._engine.ip, mt._engine.ip)
    pred = dict(gp_coords_pred=d["pred"], predict_var=True,
                cov_pars=mt.get_cov_pars())
    ref, p2 = mt.predict(**pred), m2.predict(**pred)
    for k in ("mu", "var"):
        # the fitted model's Newton steps start at its last mode, the
        # loaded model's at zero: the Poisson modes part at ~5e-5
        np.testing.assert_allclose(p2[k], ref[k], rtol=5e-4)
    if likelihood == "gaussian":
        pj = mj.predict(**pred)
        for k in ("mu", "var"):
            np.testing.assert_allclose(np.asarray(pj[k]), ref[k],
                                       rtol=1e-10)


# ---------------------------------------------------------------------
# the goldens of tests/test_fitc.py on the port
class TestFITCGoldens:
    def _model(self, d, **kw):
        return gpt.GPModel(gp_coords=d["coords"], cov_function="exponential",
                           gp_approx="fitc", device="cpu", **kw)

    def test_nll_all_inducing_equals_exact(self, gp_sim_data):
        m = self._model(gp_sim_data, num_ind_points=100,
                        ind_points_selection="random")
        nll = m.neg_log_likelihood(cov_pars=[0.1, 1.6, 0.2],
                                   y=gp_sim_data["y"])
        assert abs(nll - 124.2549533) < TOLERANCE_STRICT

    def test_estimation_all_inducing(self, gp_sim_data):
        m = self._model(gp_sim_data, num_ind_points=100,
                        ind_points_selection="random")
        m.fit(y=gp_sim_data["y"], params=dict(optimizer_cov="lbfgs"))
        expected = np.array([0.03276547, 1.07617676, 0.11352557])
        assert np.sum(np.abs(m.get_cov_pars() - expected)) < TOLERANCE_MEDIUM

    def test_prediction_all_inducing(self, gp_sim_data):
        m = self._model(gp_sim_data, num_ind_points=100,
                        ind_points_selection="random")
        pred = m.predict(y=gp_sim_data["y"], gp_coords_pred=COORD_TEST,
                         cov_pars=[0.02, 1.2, 0.9], predict_var=True,
                         predict_response=True)
        exp_mu = np.array([0.08704577, 1.63875604, 0.48513581])
        exp_var = np.array([1.189093e-01, 7.427727e-02, 8.107455e-02])
        assert np.sum(np.abs(pred["mu"] - exp_mu)) < TOLERANCE_STRICT
        assert np.sum(np.abs(pred["var"] - exp_var)) < TOLERANCE_STRICT

    def test_fewer_inducing_points_approximates(self, gp_sim_data):
        m = self._model(gp_sim_data, num_ind_points=40)
        nll = m.neg_log_likelihood(cov_pars=[0.1, 1.6, 0.2],
                                   y=gp_sim_data["y"])
        assert abs(nll - 124.2549533) < 5.0


# the goldens of tests/test_fitc_laplace.py on the port (the dense Laplace
# engine is exact at m = n)
class TestFITCLaplaceGoldens:
    def _pois(self, d, **kw):
        return gpt.GPModel(gp_coords=d["coords"], cov_function="exponential",
                           likelihood="poisson", device="cpu", **kw)

    def test_nll_exact_at_m_equals_n(self, pois_data):
        d = pois_data
        nll_d = self._pois(d).neg_log_likelihood([1.0, 0.2], d["y"])
        nll_f = self._pois(d, gp_approx="fitc", num_ind_points=len(d["y"]),
                           ind_points_selection="random"
                           ).neg_log_likelihood([1.0, 0.2], d["y"])
        assert abs(nll_f - nll_d) < 1e-3

    def test_nll_approx_close(self, pois_data):
        d = pois_data
        nll_d = self._pois(d).neg_log_likelihood([1.0, 0.2], d["y"])
        nll_f = self._pois(d, gp_approx="fitc", num_ind_points=60
                           ).neg_log_likelihood([1.0, 0.2], d["y"])
        assert abs(nll_f - nll_d) < 5.0

    def test_fit_close_to_dense(self, pois_data):
        d = pois_data
        m_dense = self._pois(d).fit(y=d["y"], params={"maxit": 50})
        m_fitc = self._pois(d, gp_approx="fitc", num_ind_points=len(d["y"]),
                            ind_points_selection="random"
                            ).fit(y=d["y"], params={"maxit": 50})
        np.testing.assert_allclose(m_fitc.get_cov_pars(),
                                   m_dense.get_cov_pars(), rtol=0.05)

    def test_predict_matches_dense_at_m_equals_n(self, pois_data):
        d = pois_data
        kw = dict(gp_coords_pred=d["pred"], cov_pars=[0.8, 0.18], y=d["y"],
                  predict_var=True, predict_response=False)
        pd_ = self._pois(d).predict(**kw)
        pf = self._pois(d, gp_approx="fitc", num_ind_points=len(d["y"]),
                        ind_points_selection="random").predict(**kw)
        np.testing.assert_allclose(pf["mu"], pd_["mu"], atol=5e-3)
        np.testing.assert_allclose(pf["var"], pd_["var"], atol=5e-3)

    def test_response_scale_prediction(self, pois_data):
        d = pois_data
        m = self._pois(d, gp_approx="fitc", num_ind_points=60).fit(
            y=d["y"], params={"maxit": 20})
        p = m.predict(gp_coords_pred=d["pred"], predict_var=True,
                      predict_response=True)
        assert np.all(np.isfinite(p["mu"])) and np.all(p["mu"] > 0)
        assert np.all(p["var"] > 0)

    def test_gamma_aux_par_estimation(self, pois_data):
        d = pois_data
        m = gpt.GPModel(gp_coords=d["coords"], cov_function="exponential",
                        likelihood="gamma", gp_approx="fitc",
                        num_ind_points=60, device="cpu")
        m.fit(y=d["y"] + 0.5, params={"maxit": 30})
        assert np.all(np.isfinite(m.get_aux_pars()))
        assert np.isfinite(m.get_current_neg_log_likelihood())
