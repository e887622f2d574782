"""Vecchia prediction, training random effects, weights, cluster_ids and the
time orderings of the PyTorch port against the JAX package.

The same numpy inputs (seeded) go through
gpboost_tpu.models.vecchia.VecchiaGaussianEngine and the port's engine at
n = 300, m = 10, float64: every prediction ordering's means, variances and
covariance matrices agree to rtol 1e-8 (the latent ordering's CG solves to
1e-6); the time orderings and the clustered neighbour search give the same
sets index for index. Then the reference goldens of
tests/test_vecchia_golden.py (test_prediction_cond_all,
TestVecchiaPredictionOrderings), tests/test_weights.py (the weighted
Vecchia NLL and prediction), tests/test_vecchia_clusters.py (all) and
tests/test_training_re.py (test_vecchia_exact_at_full_neighbors) run on the
port at their own files' tolerances.

Weighted training random effects are held to the dense engine at
m = n - 1, not to the JAX package: its vecchia.py:516 returns
r - Psi~^-1 r where the posterior mean is r - diag(1/w) Psi~^-1 r.
"""

import numpy as np
import pytest
import torch

from gpboost_tpu.models.components import GPComponent as JaxGPComponent
from gpboost_tpu.models.vecchia import (
    VecchiaGaussianEngine as JaxEngine,
    nearest_preceding_neighbors as jax_neighbors)
from gpboost_tpu.ops.cov_fcts import CovarianceFunction as JaxCov
from gpboost_tpu.utils.datasim import qnorm, sim_rand_unif
import gpboost_tpu as gpb

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models.components import GPComponent
from gpboost_tpu_torch.models.vecchia import (VecchiaGaussianEngine,
                                              nearest_preceding_neighbors)
from gpboost_tpu_torch.ops.cov_fcts import CovarianceFunction

from conftest import TOLERANCE_STRICT

torch.set_num_threads(1)

N, M = 300, 10
PARS = np.array([0.3, 0.6, 0.25])     # [sigma2, var, range]
ORDERINGS = ("order_obs_first_cond_obs_only", "order_obs_first_cond_all",
             "latent_order_obs_first_cond_all")


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(3)
    coords = rng.rand(N, 2)
    y = np.sin(5 * coords[:, 0]) * np.cos(3 * coords[:, 1]) \
        + 0.4 * rng.randn(N)
    w = 0.5 + 2.0 * rng.rand(N)
    return coords, y, w, rng.rand(40, 2)


def _engines(coords, weights=None, ordering="random", clusters=None, m=M):
    n = len(coords)
    je = JaxEngine([JaxGPComponent(coords, JaxCov("exponential"))], n,
                   num_neighbors=m, seed=0, vecchia_ordering=ordering,
                   weights=weights, cluster_ids=clusters)
    pe = VecchiaGaussianEngine(
        [GPComponent(coords, CovarianceFunction("exponential"))], n,
        num_neighbors=m, seed=0, vecchia_ordering=ordering, weights=weights,
        cluster_ids=clusters, device="cpu")
    return je, pe


@pytest.fixture(scope="module")
def engines(data):
    return _engines(data[0])


def _close(out, ref, rtol):
    """Entries to rtol relative to the largest entry's magnitude."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rtol * np.max(np.abs(ref)))


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_prediction_orderings_match_jax(data, engines, ordering):
    _, y, _, cp = data
    je, pe = engines
    pd = {"comps": [{"coords_pred": cp}]}
    rtol = 1e-6 if ordering.startswith("latent") else 1e-8
    for resp in (True, False):
        kw = dict(predict_var=True, predict_cov_mat=True,
                  predict_response=resp, vecchia_pred_type=ordering,
                  num_neighbors_pred=12)
        ref = je.predict(PARS, y, pd, **kw)
        out = pe.predict(PARS, y, pd, **kw)
        np.testing.assert_allclose(out["mu"], ref["mu"], rtol=rtol,
                                   atol=rtol * 1e-3)
        np.testing.assert_allclose(out["var"], ref["var"], rtol=rtol)
        _close(out["cov"], ref["cov"], rtol)
    if ordering == ORDERINGS[0]:
        # the reference's aliases of the first ordering
        for alias in ("order_pred_first",
                      "latent_order_obs_first_cond_obs_only"):
            a = pe.predict(PARS, y, pd, predict_var=True,
                           vecchia_pred_type=alias, num_neighbors_pred=12)
            np.testing.assert_array_equal(a["mu"], out["mu"])
    if ordering == ORDERINGS[2]:
        # the CG's mean is the same bits in two launches; the last solve's
        # iteration counts are kept on the engine
        again = pe.predict(PARS, y, pd, vecchia_pred_type=ordering,
                           num_neighbors_pred=12)
        np.testing.assert_array_equal(again["mu"], out["mu"])
        assert 0 < int(pe.last_pred_cg_it.max()) < 1000


def test_time_orderings_and_clustered_neighbours(data):
    coords, y, _, _ = data
    # gridded times: ties decide the orderings
    tc = np.column_stack([np.round(coords[:, 0] * 10) / 10, coords[:, 1]])
    for ordering in ("time", "time_random_space"):
        je, pe = _engines(tc, ordering=ordering)
        np.testing.assert_array_equal(pe.perm, je.perm)
        np.testing.assert_array_equal(pe._nn_idx.numpy(),
                                      np.asarray(je._nn_idx))
        np.testing.assert_allclose(pe.neg_log_likelihood(PARS, y),
                                   je.neg_log_likelihood(PARS, y),
                                   rtol=1e-10)
    clusters = np.repeat(np.arange(6), N // 6)[
        np.random.RandomState(8).permutation(N)]
    for a, b in zip(nearest_preceding_neighbors(coords, M, clusters),
                    jax_neighbors(coords, M, clusters)):
        np.testing.assert_array_equal(a, b)
    je, pe = _engines(coords, clusters=clusters)
    np.testing.assert_array_equal(pe._nn_idx.numpy(), np.asarray(je._nn_idx))
    np.testing.assert_allclose(pe.neg_log_likelihood(PARS, y),
                               je.neg_log_likelihood(PARS, y), rtol=1e-10)


def test_weighted_cond_obs_only_and_training_re(data, engines):
    coords, y, w, cp = data
    je, pe = _engines(coords, weights=w)
    np.testing.assert_allclose(pe.neg_log_likelihood(PARS, y),
                               je.neg_log_likelihood(PARS, y), rtol=1e-10)
    pd = {"comps": [{"coords_pred": cp}]}
    for resp in (True, False):
        ref = je.predict(PARS, y, pd, predict_var=True,
                         predict_response=resp)
        out = pe.predict(PARS, y, pd, predict_var=True,
                         predict_response=resp)
        np.testing.assert_allclose(out["mu"], ref["mu"], rtol=1e-8,
                                   atol=1e-11)
        np.testing.assert_allclose(out["var"], ref["var"], rtol=1e-8)
    # unweighted: the JAX package's training_re
    je0, pe0 = engines
    np.testing.assert_allclose(pe0.training_re(PARS, y)[0],
                               je0.training_re(PARS, y)[0], rtol=1e-8,
                               atol=1e-11)
    # weighted: at m = n - 1 the dense engine's posterior mean
    n = 120
    kw = dict(gp_coords=coords[:n], cov_function="exponential",
              weights=w[:n], device="cpu")
    dense = gpt.GPModel(**kw)
    vec = gpt.GPModel(**kw, gp_approx="vecchia", num_neighbors=n - 1,
                      vecchia_ordering="none")
    np.testing.assert_allclose(
        vec._engine.training_re(PARS, y[:n])[0],
        dense._engine.training_re(PARS, y[:n])[0], rtol=1e-8, atol=1e-10)


def test_guards_raise_as_in_jax(data, engines):
    coords, y, w, cp = data
    _, pe = engines
    pd = {"comps": [{"coords_pred": cp}]}
    _, pw = _engines(coords, weights=w)
    for ordering in ORDERINGS[1:]:
        with pytest.raises(NotImplementedError):
            pw.predict(PARS, y, pd, vecchia_pred_type=ordering)
    _, pc = _engines(coords, clusters=np.repeat([0, 1], N // 2))
    with pytest.raises(NotImplementedError):
        pc.predict(PARS, y, pd)
    big = {"comps": [{"coords_pred": np.random.RandomState(9).rand(2001,
                                                                   2)}]}
    with pytest.raises(ValueError):
        pe.predict(PARS, y, big, predict_var=True,
                   vecchia_pred_type=ORDERINGS[2])
    with pytest.raises(ValueError):
        pe.training_re(PARS, y, predict_var=True)
    with pytest.raises(ValueError):
        pe.predict(PARS, y, pd, vecchia_pred_type="order_unknown")


def test_gpmodel_facade_matches_jax(data):
    coords, y, _, cp = data
    kw = dict(gp_coords=coords, cov_function="exponential",
              gp_approx="vecchia", num_neighbors=M)
    jm = gpb.GPModel(**kw)
    pm = gpt.GPModel(**kw, device="cpu")
    jm.fit(y=y, params={"init_cov_pars": PARS, "maxit": 5})
    pm.fit(y=y, params={"init_cov_pars": PARS, "maxit": 5})
    np.testing.assert_allclose(pm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    for m_ in (jm, pm):
        m_.set_prediction_data(vecchia_pred_type=ORDERINGS[1],
                               num_neighbors_pred=15)
    ref = jm.predict(gp_coords_pred=cp, predict_var=True)
    out = pm.predict(gp_coords_pred=cp, predict_var=True)
    np.testing.assert_allclose(out["mu"], ref["mu"], rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(out["var"], ref["var"], rtol=1e-5)
    rj = jm.predict_training_data_random_effects()
    rp = pm.predict_training_data_random_effects()
    np.testing.assert_allclose(rp["GP_1"], rj["GP_1"].values, rtol=1e-5,
                               atol=1e-8)
    d = pm.model_to_dict()
    assert d["vecchia_pred_type"] == ORDERINGS[1]
    assert d["num_neighbors_pred"] == 15


# ---------------------------------------------------------------------
# reference goldens on the port
TEST_COORDS = np.column_stack([[0.1, 0.2, 0.7], [0.9, 0.4, 0.55]])


def _vecchia_gp(d, **kw):
    return gpt.GPModel(gp_coords=d["coords"], cov_function="exponential",
                       gp_approx="vecchia", num_neighbors=99,
                       vecchia_ordering="none", device="cpu", **kw)


def test_golden_prediction_cond_all(gp_sim_data):
    """test_vecchia_golden.py::TestVecchiaGaussian::
    test_prediction_cond_all."""
    y = gp_sim_data["y"]
    m = _vecchia_gp(gp_sim_data)
    m.set_prediction_data(vecchia_pred_type="order_obs_first_cond_all",
                          num_neighbors_pred=102)
    pred = m.predict(y=y, gp_coords_pred=TEST_COORDS,
                     cov_pars=[0.02, 1.2, 0.9], predict_cov_mat=True,
                     predict_response=True)
    exp_mu = np.array([0.08704577, 1.63875604, 0.48513581])
    exp_cov = np.array(
        [1.189093e-01, 1.171632e-05, -4.172444e-07, 1.171632e-05,
         7.427727e-02, 1.492859e-06, -4.172444e-07, 1.492859e-06,
         8.107455e-02])
    assert np.sum(np.abs(pred["mu"] - exp_mu)) < TOLERANCE_STRICT
    assert np.sum(np.abs(pred["cov"].ravel() - exp_cov)) < TOLERANCE_STRICT
    pred_lat = m.predict(y=y, gp_coords_pred=TEST_COORDS,
                         cov_pars=[0.02, 1.2, 0.9], predict_cov_mat=True,
                         predict_response=False)
    exp_lat = exp_cov.copy()
    exp_lat[[0, 4, 8]] -= 0.02
    assert np.sum(np.abs(pred_lat["cov"].ravel() - exp_lat)) \
        < TOLERANCE_STRICT


@pytest.mark.parametrize("ordering,nbp,resp,tol", [
    ("latent_order_obs_first_cond_all", 102, False, 1e-4),
    ("order_obs_first_cond_obs_only", 100, True, TOLERANCE_STRICT)])
def test_golden_prediction_orderings_full_neighbors(gp_sim_data, ordering,
                                                    nbp, resp, tol):
    """test_vecchia_golden.py::TestVecchiaPredictionOrderings: exact at
    m = n - 1 against the dense engine."""
    y = gp_sim_data["y"]
    cov_pars = [0.1, 1.2, 0.3]
    exact = gpt.GPModel(gp_coords=gp_sim_data["coords"],
                        cov_function="exponential", device="cpu").predict(
        y=y, gp_coords_pred=TEST_COORDS, cov_pars=cov_pars,
        predict_var=True, predict_response=resp)
    m = _vecchia_gp(gp_sim_data)
    m.set_prediction_data(vecchia_pred_type=ordering, num_neighbors_pred=nbp)
    pred = m.predict(y=y, gp_coords_pred=TEST_COORDS, cov_pars=cov_pars,
                     predict_var=True, predict_response=resp)
    assert np.max(np.abs(pred["mu"] - exact["mu"])) < tol
    assert np.max(np.abs(pred["var"] - exact["var"])) < tol


@pytest.fixture(scope="module")
def wdata():
    """test_weights.py::TestWeightsWithApproximations.wdata."""
    n = 200
    coords = sim_rand_unif(n * 2, init_c=0.1).reshape(2, n).T
    D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    C = np.linalg.cholesky(np.exp(-D / 0.1) + 1e-20 * np.eye(n))
    eps = C @ qnorm(sim_rand_unif(n, init_c=0.8))
    xi = qnorm(sim_rand_unif(n, init_c=0.3)) / 4.0
    w = 0.5 + sim_rand_unif(n, init_c=0.55) * 2.0
    return dict(coords=coords, w=w, y=eps + xi / np.sqrt(w))


def _weighted_vecchia(wd):
    return gpt.GPModel(gp_coords=wd["coords"], cov_function="exponential",
                       gp_approx="vecchia", num_neighbors=30,
                       vecchia_ordering="none", weights=wd["w"],
                       device="cpu")


def test_golden_vecchia_weighted_nll(wdata):
    nll = _weighted_vecchia(wdata).neg_log_likelihood(
        cov_pars=[0.08, 1.1, 0.12], y=wdata["y"])
    assert abs(nll - 241.55287211671592) < 1e-8


def test_golden_vecchia_weighted_prediction(wdata):
    m = _weighted_vecchia(wdata)
    m.set_prediction_data(num_neighbors_pred=30)
    pr = m.predict(y=wdata["y"],
                   gp_coords_pred=sim_rand_unif(10, init_c=0.33).reshape(
                       2, 5).T,
                   cov_pars=[0.08, 1.1, 0.12], predict_var=True,
                   predict_response=True)
    np.testing.assert_allclose(
        pr["mu"], [1.4732118381279045, -0.9869788575603993,
                   -0.2663048755724224, 1.4559654078664808,
                   1.3439075488558712], atol=1e-6)
    np.testing.assert_allclose(
        pr["var"], [0.4786700113750881, 0.3903457583038167,
                    0.49713344618967853, 0.49443042752430216,
                    0.16753331560112428], atol=1e-6)


@pytest.fixture(scope="module")
def clustered_data():
    """test_vecchia_clusters.py: n = 160 in four clusters."""
    n = 160
    rng = np.random.RandomState(3)
    coords = rng.rand(n, 2)
    cid = np.repeat([1, 2, 3, 4], n // 4)
    return coords, cid, np.sin(4 * coords[:, 0]) + 0.4 * rng.randn(n)


def _clustered(coords, cid, **kw):
    return gpt.GPModel(gp_coords=coords, cov_function="exponential",
                       cluster_ids=cid, device="cpu", **kw)


def test_golden_clusters_exact_parity_with_dense(clustered_data):
    coords, cid, y = clustered_data
    pars = [0.15, 1.0, 0.12]
    nd = _clustered(coords, cid).neg_log_likelihood(cov_pars=pars, y=y)
    nv = _clustered(coords, cid, gp_approx="vecchia",
                    num_neighbors=len(y) - 1,
                    vecchia_ordering="none").neg_log_likelihood(
                        cov_pars=pars, y=y)
    assert abs(nd - nv) < 1e-6 * abs(nd)


def test_golden_clusters_silent_ignore_regression(clustered_data):
    coords, cid, y = clustered_data
    pars = [0.15, 1.0, 0.3]
    kw = dict(gp_approx="vecchia", num_neighbors=30, vecchia_ordering="none")
    nc = _clustered(coords, cid, **kw).neg_log_likelihood(cov_pars=pars, y=y)
    nu = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     device="cpu", **kw).neg_log_likelihood(cov_pars=pars,
                                                            y=y)
    assert abs(nc - nu) > 1e-3


def test_golden_fit_clustered_vecchia(clustered_data):
    coords, cid, y = clustered_data
    init = [0.2, 1.0, 0.15]
    m = _clustered(coords, cid, gp_approx="vecchia", num_neighbors=20)
    m.fit(y=y, params={"maxit": 20, "init_cov_pars": init})
    assert np.all(np.isfinite(m.get_cov_pars()))
    p = {"maxit": 20, "init_cov_pars": init, "optimizer_cov": "lbfgs"}
    d = _clustered(coords, cid).fit(y=y, params=p)
    v = _clustered(coords, cid, gp_approx="vecchia",
                   num_neighbors=len(y) - 1,
                   vecchia_ordering="none").fit(y=y, params=p)
    np.testing.assert_allclose(v.get_cov_pars(), d.get_cov_pars(),
                               rtol=1e-3)


def test_golden_clusters_predict_and_nongaussian_guards(clustered_data):
    coords, cid, y = clustered_data
    m = _clustered(coords, cid, gp_approx="vecchia", num_neighbors=20)
    with pytest.raises(NotImplementedError):
        m.predict(y=y, gp_coords_pred=coords[:3], cluster_ids_pred=cid[:3],
                  cov_pars=[0.2, 1.0, 0.15])
    with pytest.raises(NotImplementedError):
        _clustered(coords, cid, gp_approx="vecchia", num_neighbors=20,
                   likelihood="bernoulli_probit")


def test_golden_training_re_vecchia_exact_at_full_neighbors():
    """test_training_re.py::TestGaussian::
    test_vecchia_exact_at_full_neighbors."""
    rng = np.random.RandomState(3)
    n = 120
    coords = rng.rand(n, 2)
    y = np.sin(4 * coords[:, 0]) + 0.4 * rng.randn(n)
    p = {"optimizer_cov": "lbfgs"}
    md = gpt.GPModel(gp_coords=coords, device="cpu").fit(y=y, params=p)
    mv = gpt.GPModel(gp_coords=coords, gp_approx="vecchia",
                     num_neighbors=n - 1, vecchia_ordering="none",
                     device="cpu").fit(y=y, params=p)
    rd = md.predict_training_data_random_effects()["GP_1"]
    rv = mv.predict_training_data_random_effects()["GP_1"]
    assert np.allclose(rd, rv, atol=1e-4)
    with pytest.raises(ValueError):
        mv.predict_training_data_random_effects(predict_var=True)
