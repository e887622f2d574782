"""GP random coefficients (spatially varying coefficient models),
optimizer_cov="adam" and posterior / prior sampling in the PyTorch port,
against the JAX package on the CPU in float64.

Data: the R suite's GP fixture (tests/conftest.py gp_sim_data: n = 100 on
the unit square, an exponential GP with two random-coefficient covariates
Z_SVC, eps_svc).

* An exponential GP with two random-coefficient columns on the dense
  Gaussian engine: the parameter names, the NLL to rtol 1e-10 and its
  gradient to 1e-8; one lbfgs fit from [0.1, 1, 0.1, 1, 0.1, 1, 0.1]
  (equal iterations, parameters to 1e-6; the nugget ends at its lower
  bound, and from the default start and from PARS7 scipy's L-BFGS-B,
  run to ftol 1e-16, stopped 2 and 1 iterations apart in the two
  packages, at NLLs agreeing to 1e-14);
  predictions with gp_rand_coef_data_pred (mean and covariance, 1e-8);
  predict_training_data_random_effects (names and values, 1e-8); a JAX
  model dict loaded in the port, and the port's own round trip; the NLL
  of a tapered main GP beside the coefficient processes.
* The same model for a binary probit response on the dense Laplace
  engine: NLL, g_u, g_F and the mode to 1e-8 with equal Newton steps,
  predictions to 1e-8.
* One GPBoost round and one LaGaBoost round with an SVC model (the GP
  fit by gradient descent; LaGaBoost's fitted once at the init score and
  then held) against the JAX host loop: the same trees,
  parameters to 1e-8, scores and predictions to 1e-8 (1e-6 for
  LaGaBoost's float32 leaf sums), the JAX boosters' dicts loaded in the
  port predicting the same (1e-8); cv's folds slice gp_rand_coef_data.
* adam (optax.adam(1e-2) in the JAX package, by hand in the port) on the
  grouped Gaussian engine and on the probit SVC model's dense Laplace
  engine: equal iteration counts, parameters to 1e-6.
* Posterior and prior samples element by element against the JAX package
  at one seed (rtol 1e-8), through GPModel.predict and Booster.predict.
  The prior with cluster_ids on the Vecchia and Woodbury engines, whose
  predictions take no same-cluster mask, element by element too.
  The JAX package's prior for a non-Gaussian model reads the parameters
  as if an error variance came first (gpboost_tpu/gp_model.py:909-913);
  there the port is held to the closed form, the model's covariance at
  the new points.
* The goldens of TestRandomCoefficients and both test_posterior_sampling
  cases of tests/test_combined_gp_re_golden.py, and TestPosteriorSampling
  of tests/test_persistence.py, their own test bodies run on the port.
"""

import copy
import os
import sys
import types

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.stats import norm

import jax.numpy as jnp

import gpboost_tpu as gpb
from gpboost_tpu.models.optimize import OptimConfig as JaxOptimConfig
from gpboost_tpu.models.optimize import optimize_laplace as \
    jax_optimize_laplace

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.convert import booster_from_jax_dict
from gpboost_tpu_torch.engine import _clone_gp_model

sys.path.insert(0, os.path.dirname(__file__))
import test_combined_gp_re_golden as golden  # noqa: E402
import test_persistence as persistence  # noqa: E402
from test_combined_gp_re_golden import cb  # noqa: E402,F401
from test_persistence import spatial_pois  # noqa: E402,F401

torch.set_num_threads(1)

TOL = 1e-8
PARS7 = np.array([0.1, 0.9, 0.12, 0.8, 0.15, 1.1, 0.08])
COORD_TEST = np.column_stack([[0.1, 0.2, 0.7], [0.9, 0.4, 0.55]])
Z_TEST = np.column_stack([[0.1, 0.3, 0.7], [0.5, 0.2, 0.4]])
PRED = dict(gp_coords_pred=COORD_TEST, gp_rand_coef_data_pred=Z_TEST)
BOOST = {"objective": "regression", "learning_rate": 0.1, "num_leaves": 7,
         "min_data_in_leaf": 10, "verbose": 0}
GD = {"optimizer_cov": "gradient_descent", "maxit": 10}


def _kw(d):
    return dict(gp_coords=d["coords"], gp_rand_coef_data=d["Z_SVC"],
                cov_function="exponential")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _splits(tree):
    nn = tree.num_nodes
    internal = ~tree.is_leaf[:nn]
    return (tree.is_leaf[:nn].tolist(),
            tree.split_feature[:nn][internal].tolist(),
            tree.threshold_bin[:nn][internal].tolist())


@pytest.fixture(scope="module")
def svc(gp_sim_data):
    """The Gaussian SVC model fitted once by lbfgs in each package."""
    d = gp_sim_data
    y = d["eps_svc"] + d["xi"]
    jm = gpb.GPModel(**_kw(d))
    pm = gpt.GPModel(device="cpu", **_kw(d))
    fit = {"optimizer_cov": "lbfgs",
           "init_cov_pars": np.array([0.1, 1, 0.1, 1, 0.1, 1, 0.1])}
    jm.fit(y=y, params=fit)
    pm.fit(y=y, params=fit)
    return y, jm, pm


@pytest.fixture(scope="module")
def y_bin(gp_sim_data):
    return (golden.sim_rand_unif(100, init_c=0.2341)
            < norm.cdf(gp_sim_data["eps_svc"])).astype(float)


# ---------------------------------------------------------------------
# SVC models on the dense Gaussian engine
def test_svc_gaussian_nll_and_gradient_match_jax(svc):
    y, jm, pm = svc
    assert pm.get_cov_par_names() == jm.get_cov_par_names() == [
        "Error_term", "GP_var", "GP_range", "GP_rand_coef_nb_1_var",
        "GP_rand_coef_nb_1_range", "GP_rand_coef_nb_2_var",
        "GP_rand_coef_nb_2_range"]
    assert pm.neg_log_likelihood(PARS7, y) == pytest.approx(
        jm.neg_log_likelihood(PARS7, y), rel=1e-10)
    u = np.log(pm._engine.transform_pars(PARS7))
    vj, gj = jm._engine.vag_full(jnp.asarray(u), jnp.asarray(y))
    vp, gp = pm._engine.vag_full(u, pm._engine.prep_y(y))
    assert vp == pytest.approx(float(vj), rel=1e-10)
    np.testing.assert_allclose(gp, np.asarray(gj), rtol=TOL)


def test_svc_gaussian_fit_predict_and_dicts_match_jax(svc):
    y, jm, pm = svc
    assert pm.get_num_optim_iter() == jm.get_num_optim_iter()
    np.testing.assert_allclose(pm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    for resp in (False, True):
        pj = jm.predict(predict_cov_mat=True, predict_response=resp, **PRED)
        pp = pm.predict(predict_cov_mat=True, predict_response=resp, **PRED)
        assert _rel(pp["mu"], pj["mu"]) < TOL
        assert _rel(pp["cov"], pj["cov"]) < TOL
    rj = jm.predict_training_data_random_effects(predict_var=True)
    rp = pm.predict_training_data_random_effects(predict_var=True)
    assert list(rp) == list(rj.columns) == [
        "GP_1", "GP_2_rand_coef", "GP_3_rand_coef", "GP_1_var",
        "GP_2_rand_coef_var", "GP_3_rand_coef_var"]
    for k in rp:
        assert _rel(rp[k], rj[k].values) < TOL, k
    # a JAX model dict loads in the port, and the port's dict carries
    # gp_rand_coef_data too
    lp = gpt.GPModel(model_dict=jm.model_to_dict(), device="cpu")
    assert _rel(lp.predict(predict_cov_mat=True, **PRED)["cov"],
                pj["cov"]) < TOL
    d = pm.model_to_dict()
    np.testing.assert_array_equal(d["gp_rand_coef_data"],
                                  jm.model_to_dict()["gp_rand_coef_data"])
    lp2 = gpt.GPModel(model_dict=d, device="cpu")
    np.testing.assert_array_equal(lp2.predict(**PRED)["mu"],
                                  pm.predict(**PRED)["mu"])
    with pytest.raises(ValueError):
        pm.predict(gp_coords_pred=COORD_TEST)


def test_svc_beside_a_taper_and_refused_engines(gp_sim_data):
    """The coefficient processes keep a plain kernel beside a tapered
    main GP, as in the reference; the Vecchia and FITC engines refuse
    them (the reference asserts one GP component there)."""
    d = gp_sim_data
    y = d["eps_svc"] + d["xi"]
    kw = dict(_kw(d), gp_approx="tapering", cov_fct_taper_range=0.3,
              cov_fct_taper_shape=1)
    jm, pm = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    assert pm.neg_log_likelihood(PARS7, y) == pytest.approx(
        jm.neg_log_likelihood(PARS7, y), rel=1e-10)
    for approx, lik in (("vecchia", "gaussian"), ("fitc", "poisson"),
                        ("vecchia_latent", "gaussian")):
        with pytest.raises(NotImplementedError, match="one GP component"):
            gpt.GPModel(device="cpu", gp_approx=approx, likelihood=lik,
                        **_kw(d))


# ---------------------------------------------------------------------
# GPBoost and LaGaBoost with an SVC model, one round against the JAX
# host loop
def _boost_data():
    X = np.random.RandomState(6).rand(103, 3)
    return X[:100], X[100:]


@pytest.fixture(scope="module")
def gpboost(gp_sim_data):
    d = gp_sim_data
    X, _ = _boost_data()
    y = d["eps_svc"] + d["xi"] + 2.0 * X[:, 0]
    gj, gp = gpb.GPModel(**_kw(d)), gpt.GPModel(device="cpu", **_kw(d))
    gj.set_optim_params(params=GD)
    gp.set_optim_params(params=GD)
    bj = gpb.train(BOOST, gpb.Dataset(X, label=y), num_boost_round=1,
                   gp_model=gj, callbacks=[lambda env: None])
    bp = gpt.train(BOOST, gpt.Dataset(X, label=y), num_boost_round=1,
                   gp_model=gp)
    return bj, gj, bp, gp


@pytest.fixture(scope="module")
def lagaboost(gp_sim_data, y_bin):
    X, _ = _boost_data()
    kw = dict(_kw(gp_sim_data), likelihood="bernoulli_probit")
    gj, gp = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    opt = {**GD, "maxit": 1, "init_cov_pars": PARS7[1:]}
    gj.set_optim_params(params=opt)
    gp.set_optim_params(params=opt)
    # the GP is fitted once, at the init score, and then held: the JAX
    # package's warm-started refit compiles a graph of its own
    params = {**BOOST, "objective": "binary",
              "train_gp_model_cov_pars": False}
    bj = gpb.train(params, gpb.Dataset(X, label=y_bin), num_boost_round=1,
                   gp_model=gj, callbacks=[lambda env: None])
    bp = gpt.train(params, gpt.Dataset(X, label=y_bin), num_boost_round=1,
                   gp_model=gp)
    return bj, gj, bp, gp


def test_svc_probit_laplace_matches_jax(lagaboost, y_bin):
    """The dense Laplace engine with SVC components (the LaGaBoost
    fixture's models, whose JAX graphs are compiled): NLL, g_u, g_F and
    the mode at fixed parameters and fixed effects, predictions."""
    _, jm, _, pm = lagaboost
    pars = PARS7[1:]
    u = np.log(pm._engine.transform_pars(pars))
    F = 0.3 * np.sin(np.arange(100))
    je, pe = jm._engine, pm._engine
    nj, guj, gFj, aj = je.laplace_vag_F(u, jnp.asarray(y_bin),
                                        jnp.asarray(F), je.zero_mode())
    npt, gup, gFp, ap = pe.laplace_vag_F(u, y_bin, F, pe.zero_mode())
    assert npt == pytest.approx(float(nj), rel=1e-10)
    assert _rel(ap.numpy(), aj) < TOL
    np.testing.assert_allclose(gup, guj, rtol=TOL)
    assert _rel(gFp, gFj) < TOL
    assert pe.last_num_mode_it == je.last_num_mode_it
    for resp in (False, True):
        pj = jm.predict(y=y_bin, cov_pars=pars, predict_var=True,
                        predict_response=resp, **PRED)
        pp = pm.predict(y=y_bin, cov_pars=pars, predict_var=True,
                        predict_response=resp, **PRED)
        assert _rel(pp["mu"], pj["mu"]) < TOL
        assert _rel(pp["var"], pj["var"]) < TOL


@pytest.mark.parametrize("which", ["gpboost", "lagaboost"])
def test_boosting_round_with_svc_matches_jax(which, request):
    """One round: the init score, the GP fit at it (parameters to 1e-8),
    the same tree; scores and predictions to 1e-8 for GPBoost, 1e-6 for
    LaGaBoost, whose leaf values are float32 histogram sums taken in
    another order (tests/test_torch_lagaboost.py)."""
    bj, gj, bp, gp = request.getfixturevalue(which)
    tol = TOL if which == "gpboost" else 1e-6
    _, Xn = _boost_data()
    np.testing.assert_allclose(bp.init_score, bj.init_score, rtol=1e-10)
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=TOL)
    assert [_splits(t) for t in bp.trees] == [_splits(t) for t in bj.trees]
    assert _rel(bp.F.numpy(), bj.F) < tol
    # the JAX booster's dict, gp_rand_coef_data in its GP model, loads in
    # the port and predicts what the JAX booster predicts
    bl, _ = booster_from_jax_dict(bj.model_to_dict(), device="cpu")
    for latent in (True, False):
        pj = bj.predict(Xn, predict_var=True, pred_latent=latent, **PRED)
        pp = bp.predict(Xn, predict_var=True, pred_latent=latent, **PRED)
        pl = bl.predict(Xn, predict_var=True, pred_latent=latent, **PRED)
        assert set(pp) == set(pj) == set(pl)
        for k in pj:
            assert _rel(pp[k], pj[k]) < tol, k
            assert _rel(pl[k], pj[k]) < TOL, k


def test_cv_folds_slice_the_coefficients(gpboost):
    gp = gpboost[3]
    idx = np.arange(0, gp.num_data, 3)
    clone = _clone_gp_model(gp, idx)
    np.testing.assert_array_equal(clone.gp_rand_coef_data,
                                  gp.gp_rand_coef_data[idx])
    np.testing.assert_array_equal(clone.components[1].z,
                                  gp.gp_rand_coef_data[idx, 0])


# ---------------------------------------------------------------------
# adam
@pytest.mark.parametrize("lik", ["gaussian", "bernoulli_probit"])
def test_adam_matches_jax(lik, request):
    """adam through GPModel.fit in the port, against the JAX package: a
    grouped Gaussian model (Woodbury engine, default stop), and the probit
    SVC model on the dense Laplace engine, where the JAX side runs its
    optimizer on the LaGaBoost fixture's engine, whose graphs that
    fixture's fit compiled; delta_rel_conv 1e-4 stops it by the relative
    change after 61 steps (at 1e-6 the range of a coefficient process
    drifts along a flat direction for hundreds of steps)."""
    params = {"optimizer_cov": "adam"}
    if lik == "gaussian":
        rng = np.random.RandomState(3)
        g = np.repeat(np.arange(20), 10)
        y = 0.8 * rng.randn(20)[g] + 0.5 * rng.randn(200)
        jm = gpb.GPModel(group_data=g).fit(y=y, params=params)
        nit_j, pars_j = jm.get_num_optim_iter(), jm.get_cov_pars()
        pm = gpt.GPModel(group_data=g, device="cpu")
    else:
        gj = request.getfixturevalue("lagaboost")[1]
        y = request.getfixturevalue("y_bin")
        params.update(init_cov_pars=PARS7[1:], delta_rel_conv=1e-4)
        r = jax_optimize_laplace(gj._engine, y, JaxOptimConfig(**params))
        nit_j, pars_j = r.num_it, r.cov_pars
        pm = gpt.GPModel(device="cpu", likelihood=lik, **_kw(
            request.getfixturevalue("gp_sim_data")))
    pm.fit(y=y, params=params)
    assert pm.get_num_optim_iter() == nit_j < 10000
    np.testing.assert_allclose(pm.get_cov_pars(), pars_j, rtol=1e-6)
    assert pm._fit_result.optimizer == "scipy"


# ---------------------------------------------------------------------
# posterior and prior samples at one seed
def test_gp_model_samples_match_jax(svc):
    _, jm, pm = svc
    for kw in (dict(sample_posterior=True, num_post_samples=40, seed=3,
                    predict_var=True),
               dict(sample_posterior=True, num_post_samples=40, seed=3,
                    predict_response=False, predict_cov_mat=True),
               dict(sample_prior=True, num_prior_samples=30, seed=5),
               dict(sample_prior=True, num_post_samples=30, seed=5,
                    predict_response=False)):
        pj, pp = jm.predict(**kw, **PRED), pm.predict(**kw, **PRED)
        key = "posterior_samples" if "sample_posterior" in kw \
            else "prior_samples"
        assert pp[key].shape == np.asarray(pj[key]).shape
        assert _rel(pp[key], pj[key]) < TOL, kw
        for k in ("mu", "var", "cov"):
            if pj.get(k) is None:
                assert pp.get(k) is None, k
            else:
                assert _rel(pp[k], pj[k]) < TOL, k


def test_non_gaussian_prior_is_the_closed_form(lagaboost):
    """The port draws a probit SVC model's prior from
    sum_j v_j z_j z_j' exp(-D / rho_j) at the new points; the JAX package
    reads its parameters shifted by one, as if an error variance came
    first, and fails."""
    bj, gj, bp, gp = lagaboost
    pars = gp.get_cov_pars()
    D = np.sqrt(((COORD_TEST[:, None] - COORD_TEST[None]) ** 2).sum(-1))
    zs = [np.ones(3), Z_TEST[:, 0], Z_TEST[:, 1]]
    K = sum(pars[2 * j] * np.outer(z, z) * np.exp(-D / pars[2 * j + 1])
            for j, z in enumerate(zs))
    pp = gp.predict(sample_prior=True, num_prior_samples=25, seed=7,
                    **PRED)
    assert _rel(pp["cov"], K) < 1e-12
    L = np.linalg.cholesky(K + 1e-10 * np.eye(3))
    expected = L @ np.random.RandomState(7).standard_normal((3, 25))
    assert _rel(pp["prior_samples"], expected) < 1e-12
    # the JAX package's parameter shift runs off the end of its vector
    with pytest.raises(IndexError):
        gj.predict(sample_prior=True, num_prior_samples=25, seed=7, **PRED)
    # through the booster: latent samples carry the ensemble
    _, Xn = _boost_data()
    F = bp.predict(Xn, pred_latent=True, **PRED)["fixed_effect"]
    qp = bp.predict(Xn, pred_latent=True, sample_prior=True,
                    num_prior_samples=25, seed=7, **PRED)
    assert _rel(qp["prior_samples"], expected + F[:, None]) < 1e-12


@pytest.mark.parametrize("approx", ["vecchia", "woodbury"])
def test_prior_samples_with_clusters(approx, gp_sim_data):
    """cluster_ids make the prior of different clusters independent on
    engines whose predictions take no same-cluster mask: a Vecchia GP
    (against the JAX package, element by element; points 0 and 3 lie
    0.07 apart in different clusters), and a grouping on the Woodbury
    engine, held to the closed form v 1{same group} 1{same cluster}
    (the JAX package's prior fails there with KeyError, as without
    clusters)."""
    d = gp_sim_data
    cid = np.array([1, 2, 1, 2])
    a = dict(cluster_ids_pred=cid, sample_prior=True, num_prior_samples=20,
             seed=4)
    if approx == "vecchia":
        kw = dict(gp_coords=d["coords"], cov_function="exponential",
                  gp_approx="vecchia", num_neighbors=10,
                  cluster_ids=d["cluster_ids"])
        a.update(cov_pars=np.array([0.1, 1.0, 0.1]),
                 gp_coords_pred=np.column_stack(
                     [[0.1, 0.2, 0.7, 0.15], [0.9, 0.4, 0.55, 0.85]]))
    else:
        kw = dict(group_data=np.arange(100) % 10,
                  cluster_ids=d["cluster_ids"])
        gp_ = np.array([0, 1, 0, 0])
        a.update(cov_pars=np.array([0.1, 1.0]), group_data_pred=gp_)
    jm, pm = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    for resp in (True, False):
        pp = pm.predict(predict_response=resp, **a)
        assert pp["cov"][0, 3] == pp["cov"][0, 1] == 0.0
        assert pp["cov"][0, 2] > 0.0
        if approx == "vecchia":
            pj = jm.predict(predict_response=resp, **a)
            assert _rel(pp["cov"], pj["cov"]) < TOL
            assert _rel(pp["prior_samples"], pj["prior_samples"]) < TOL
            continue
        K = 1.0 * (gp_[:, None] == gp_[None]) * (cid[:, None] == cid[None])
        K = K + (0.1 * np.eye(4) if resp else 0.0)
        assert _rel(pp["cov"], K) < 1e-15
        L = np.linalg.cholesky(K + 1e-10 * np.eye(4))
        assert _rel(pp["prior_samples"], L @ np.random.RandomState(
            4).standard_normal((4, 20))) < 1e-12
        with pytest.raises(KeyError):
            jm.predict(predict_response=resp, **a)


@pytest.mark.parametrize("which", ["gpboost", "lagaboost"])
def test_booster_posterior_samples_match_jax(which, request):
    bj, _, bp, _ = request.getfixturevalue(which)
    _, Xn = _boost_data()
    kw = dict(sample_posterior=True, num_post_samples=30, seed=11,
              pred_latent=which == "lagaboost", **PRED)
    sj, sp = bj.predict(Xn, **kw), bp.predict(Xn, **kw)
    # the draws at 1e-8; the ensemble they carry as the rounds' test holds
    # it (LaGaBoost's float32 leaf sums: 1e-6)
    Fj, Fp = sj["fixed_effect"], sp["fixed_effect"]
    assert _rel(Fp, Fj) < (TOL if which == "gpboost" else 1e-6)
    assert _rel(sp["posterior_samples"] - Fp[:, None],
                sj["posterior_samples"] - Fj[:, None]) < TOL
    if which == "lagaboost":
        # the latent process only: the response has no covariance
        with pytest.raises(ValueError, match="predict_response=False"):
            bp.predict(Xn, **{**kw, "pred_latent": False})


# ---------------------------------------------------------------------
# the goldens on the port: the files' own test bodies with the port's
# GPModel (device="cpu") in place of the JAX one
class _PortGPModel(gpt.GPModel):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(*args, **kwargs)

    def predict_training_data_random_effects(self, *args, **kwargs):
        return pd.DataFrame(super().predict_training_data_random_effects(
            *args, **kwargs))


def _port_fit_gp_model(y, X=None, params=None, **kwargs):
    return _PortGPModel(**kwargs).fit(y=y, X=X, params=copy.deepcopy(params))


GOLDENS = [("TestRandomCoefficients", t) for t in (
    "test_gradient_descent_golden", "test_prediction_golden",
    "test_fisher_scoring_golden", "test_nll_golden")] + [
    ("TestCombinedGaussian", "test_posterior_sampling"),
    ("TestCombinedGamma", "test_posterior_sampling")]


@pytest.mark.parametrize("cls,name", GOLDENS,
                         ids=[f"{c}.{t}" for c, t in GOLDENS])
def test_combined_golden_on_the_port(cls, name, cb,  # noqa: F811
                                     monkeypatch):
    monkeypatch.setattr(golden, "GPModel", _PortGPModel)
    monkeypatch.setattr(golden, "fitGPModel", _port_fit_gp_model)
    fn = getattr(getattr(golden, cls)(), name)
    if cls == "TestCombinedGamma":
        # the class's yg fixture
        from scipy.stats import gamma
        fn(cb, gamma.ppf(golden.sim_rand_unif(cb["n"], init_c=0.234),
                         a=0.5, scale=np.exp(cb["eps"])))
    else:
        fn(cb)


@pytest.mark.parametrize("name", [
    "test_nongaussian_posterior_samples_match_moments", "test_prior_samples"])
def test_persistence_sampling_golden_on_the_port(name, spatial_pois,  # noqa
                                                 monkeypatch):
    monkeypatch.setattr(persistence, "gpb", types.SimpleNamespace(
        fitGPModel=_port_fit_gp_model))
    getattr(persistence.TestPosteriorSampling(), name)(spatial_pois)
