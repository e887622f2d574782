"""GPBoost with grouped random effects and with an exact GP in the PyTorch
port, against the JAX package and the R suite's goldens.

Parity: n = 400, p = 6 (the data of examples/03_gpboost_algorithm.py, cut
to 20 groups), 7-leaf trees, 5 rounds, float64; the JAX side runs its host
loop (a callback turns the fused scan off). Trees split alike; training
scores, covariance parameters and predictions agree to rtol 1e-5 (leaf
values are float32 histogram sums in another order), with plain updates,
Newton leaf updates and the line-search step length. Model dicts load
both ways and predict the same.

Goldens: the grouped and exact-GP blocks of
tests/test_gpboost_algorithm_golden.py on the port, at that file's
tolerances. Not here: Nesterov-accelerated boosting, sample weights and
posterior sampling (not ported), and the n = 100,000 goldens
(TestLargeDataAndLineSearch), which take ~40 s on one CPU thread and run
on the card in chip_smoke.py (phase 11).
"""

import sys
import os

import numpy as np
import pytest
import torch
from scipy.stats import norm

import gpboost_tpu as gpb

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.convert import booster_from_jax_dict

sys.path.insert(0, os.path.dirname(__file__))
from test_gpboost_algorithm_golden import (  # noqa: E402
    sim_friedman3, sim_rand_unif)

torch.set_num_threads(1)

N, P, GROUPS, ROUNDS = 400, 6, 20, 5
PARAMS = {"objective": "regression", "learning_rate": 0.1, "num_leaves": 7,
          "min_data_in_leaf": 20, "verbose": 0}


def _data(n=N, seed=1):
    """examples/03_gpboost_algorithm.py:19-25 at n rows, GROUPS groups."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, P)
    F = 2 * X[:, 0] + 2 * np.sin(8 * X[:, 1]) + (X[:, 2] > 0.6)
    group = rng.randint(0, GROUPS, n)
    b = 0.8 * rng.randn(GROUPS)
    return X, group, F + b[group] + 0.3 * rng.randn(n)


def _train_both(extra, gp_kw):
    X, group, y = _data()
    gj = gpb.GPModel(**gp_kw(group))
    bj = gpb.train({**PARAMS, **extra}, gpb.Dataset(X, label=y),
                   num_boost_round=ROUNDS, gp_model=gj,
                   callbacks=[lambda env: None])
    gp = gpt.GPModel(**gp_kw(group), device="cpu")
    bp = gpt.train({**PARAMS, **extra}, gpt.Dataset(X, label=y),
                   num_boost_round=ROUNDS, gp_model=gp)
    return bj, gj, bp, gp


def _grouped(group):
    return {"group_data": group}


def _new(n=40, seed=2):
    rng = np.random.RandomState(seed)
    group = rng.randint(0, GROUPS + 5, n)           # some unseen groups
    return rng.rand(n, P), group


def _splits(tree):
    nn = tree.num_nodes
    internal = ~tree.is_leaf[:nn]
    return (tree.is_leaf[:nn].tolist(),
            tree.split_feature[:nn][internal].tolist(),
            tree.threshold_bin[:nn][internal].tolist())


@pytest.mark.parametrize("extra", [{}, {"leaves_newton_update": True},
                                   {"line_search_step_length": True}])
def test_grouped_gpboost_matches_jax(extra):
    bj, gj, bp, gp = _train_both(extra, _grouped)
    assert [_splits(t) for t in bp.trees] == [_splits(t) for t in bj.trees]
    np.testing.assert_allclose(bp.F.numpy(), bj.F, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-5)
    Xn, gn = _new()
    for latent in (False, True):
        pj = bj.predict(Xn, group_data_pred=gn, predict_var=True,
                        pred_latent=latent)
        pp = bp.predict(Xn, group_data_pred=gn, predict_var=True,
                        pred_latent=latent)
        for k in ("fixed_effect", "random_effect_mean", "random_effect_cov",
                  "response_mean"):
            np.testing.assert_allclose(pp[k], pj[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    rj = bj.predict_training_data_random_effects(predict_var=True)
    rp = bp.predict_training_data_random_effects(predict_var=True)
    for k in rp:
        np.testing.assert_allclose(rp[k], rj[k].values, rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_exact_gp_gpboost_matches_jax():
    rng = np.random.RandomState(4)
    n = 200
    coords = rng.rand(n, 2)
    X, _, y = _data(n)
    y = y + np.sin(6 * coords[:, 0]) * np.cos(4 * coords[:, 1])
    params = {**PARAMS, "leaves_newton_update": True}
    gj = gpb.GPModel(gp_coords=coords, cov_function="exponential")
    bj = gpb.train(params, gpb.Dataset(X, label=y), num_boost_round=ROUNDS,
                   gp_model=gj, callbacks=[lambda env: None])
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     device="cpu")
    bp = gpt.train(params, gpt.Dataset(X, label=y), num_boost_round=ROUNDS,
                   gp_model=gp)
    assert [_splits(t) for t in bp.trees] == [_splits(t) for t in bj.trees]
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-5)
    Xn = rng.rand(30, P)
    cn = rng.rand(30, 2)
    pj = bj.predict(Xn, gp_coords_pred=cn, predict_var=True)
    pp = bp.predict(Xn, gp_coords_pred=cn, predict_var=True)
    for k in ("response_mean", "response_var"):
        np.testing.assert_allclose(pp[k], pj[k], rtol=1e-5, err_msg=k)


def test_model_dicts_both_ways():
    bj, gj, bp, gp = _train_both({}, _grouped)
    Xn, gn = _new(seed=3)
    bc, gc = booster_from_jax_dict(bj.model_to_dict(), device="cpu")
    np.testing.assert_array_equal(gc.get_cov_pars(), gj.get_cov_pars())
    pj = bj.predict(Xn, group_data_pred=gn, predict_var=True)
    pc = bc.predict(Xn, group_data_pred=gn, predict_var=True)
    for k in ("response_mean", "response_var"):
        np.testing.assert_allclose(pc[k], pj[k], rtol=0, atol=1e-10)
    bl = gpb.Booster(model_dict=bp.model_to_dict())
    pl = bl.predict(Xn, group_data_pred=gn, predict_var=True)
    pp = bp.predict(Xn, group_data_pred=gn, predict_var=True)
    for k in ("response_mean", "response_var"):
        np.testing.assert_allclose(pp[k], pl[k], rtol=0, atol=1e-10)


# ---------------------------------------------------------------------
# goldens of tests/test_gpboost_algorithm_golden.py on the port
@pytest.fixture(scope="module")
def grouped_data():
    """test_z_GPBoost_algorithm.R:80-124 setup."""
    ntrain = 1000
    n = 2 * ntrain
    X, f = sim_friedman3(n)
    m, n_new = 40, 3
    group = np.repeat(np.arange(1, m + 1), ntrain // m).astype(float)
    group = np.concatenate([group, group])
    group[-n_new:] = 99999
    group2 = np.tile(np.arange(1, ntrain // m + 1), m).astype(float)
    group2 = np.concatenate([group2, group2])
    group2[-n_new:] = 99999
    _, inv1 = np.unique(group, return_inverse=True)
    _, inv2 = np.unique(group2, return_inverse=True)
    b1 = np.sqrt(0.6) * norm.ppf(sim_rand_unif(len(np.unique(group)), 0.542))
    b2 = np.sqrt(0.4) * norm.ppf(
        sim_rand_unif(len(np.unique(group2)), 0.2354))
    xi = 0.1 * norm.ppf(sim_rand_unif(n, 0.756))
    y = f + b1[inv1] + b2[inv2] + xi
    gd = np.column_stack([group, group2])
    return dict(y_train=y[:ntrain], X_train=X[:ntrain], g_train=gd[:ntrain],
                y_test=y[ntrain:], X_test=X[ntrain:], f_test=f[ntrain:],
                g_test=gd[ntrain:], var_y=np.var(y, ddof=1))


GOLDEN_BOOST = {"learning_rate": 0.01, "max_depth": 6, "min_data_in_leaf": 5,
                "objective": "regression_l2", "verbose": 0}


def _train_grouped_golden(d, init=True):
    gp = gpt.GPModel(group_data=d["g_train"], device="cpu")
    vy = d["var_y"]
    p = {"optimizer_cov": "fisher_scoring", "delta_rel_conv": 1e-6,
         "init_coef_aux_pars_from_iid_model": False}
    if init:
        p["init_cov_pars"] = [vy / 2, vy / 2, vy / 2]
    gp.set_optim_params(params=p)
    boost = dict(GOLDEN_BOOST)
    if not init:
        boost.pop("objective")
    bst = gpt.train(boost, gpt.Dataset(d["X_train"], label=d["y_train"]),
                    num_boost_round=62, gp_model=gp)
    return gp, bst


class TestGroupedREBoostingGolden:
    REF_COV = np.array([0.005087137, 0.590527753, 0.390570179])

    @pytest.fixture(scope="class")
    def fitted(self, grouped_data):
        return _train_grouped_golden(grouped_data)

    def test_cov_pars_and_nll(self, fitted):
        gp, _ = fitted
        assert np.sum(np.abs(gp.get_cov_pars() - self.REF_COV)) < 0.05
        assert gp.get_current_neg_log_likelihood() < -965.389782 + 3.0

    def test_predictions(self, fitted, grouped_data):
        d = grouped_data
        gp, bst = fitted
        lat = bst.predict(d["X_test"], group_data_pred=d["g_test"],
                          pred_latent=True, predict_var=True)
        fe, re = lat["fixed_effect"], lat["random_effect_mean"]
        assert np.sqrt(np.mean((fe - d["f_test"]) ** 2)) < 0.262 + 0.02
        assert np.sqrt(np.mean((fe - d["y_test"]) ** 2)) < 1.0241 + 0.01
        assert np.sqrt(np.mean((fe + re - d["y_test"]) ** 2)) < 0.235 + 0.01
        re_mean = np.array([0.3918770, -0.1655551, -1.2513672, 0, 0, 0])
        re_var = np.array([0.0003254678] * 3 + [0.9810979337] * 3)
        pred_fe = np.array([4.392474, 4.294148, 3.561677,
                            5.072800, 5.048781, 3.864357])
        assert np.sum(np.abs(re[-6:] - re_mean)) < 0.3
        assert np.sum(np.abs(lat["random_effect_cov"][-6:] - re_var)) < 0.05
        assert np.sum(np.abs(fe[-6:] - pred_fe)) < 0.8
        resp = bst.predict(d["X_test"], group_data_pred=d["g_test"],
                           pred_latent=False, predict_var=True)
        np.testing.assert_allclose(resp["response_mean"], fe + re,
                                   atol=1e-10)
        np.testing.assert_allclose(
            resp["response_var"],
            lat["random_effect_cov"] + gp.get_cov_pars()[0], atol=1e-10)

    def test_objective_defaults_to_gaussian(self, grouped_data):
        gp, _ = _train_grouped_golden(grouped_data, init=False)
        assert np.sum(np.abs(gp.get_cov_pars() - self.REF_COV)) < 0.05


@pytest.fixture(scope="module")
def gp_data():
    """test_z_GPBoost_algorithm.R:881-905 setup."""
    ntrain = 500
    n = 2 * ntrain
    X, f = sim_friedman3(n)
    coords = np.reshape(sim_rand_unif(n * 2, 0.63), (2, n)).T.copy()
    D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    C = np.linalg.cholesky(np.exp(-D / 0.1) + 1e-20 * np.eye(n))
    eps = C @ norm.ppf(sim_rand_unif(n, 0.864))
    xi = np.sqrt(0.1) * norm.ppf(sim_rand_unif(n, 0.36))
    y = f + eps + xi
    Dtr = D[:ntrain, :ntrain]
    init_cov = [np.var(y[:ntrain], ddof=1) / 2,
                np.var(y[:ntrain], ddof=1) / 2,
                np.mean(Dtr[np.triu_indices(ntrain, 1)]) / 3]
    return dict(y_train=y[:ntrain], X_train=X[:ntrain],
                c_train=coords[:ntrain], y_test=y[ntrain:],
                X_test=X[ntrain:], f_test=f[ntrain:], c_test=coords[ntrain:],
                init_cov=init_cov)


def _train_gp_golden(d, optim):
    gp = gpt.GPModel(gp_coords=d["c_train"], cov_function="exponential",
                     device="cpu")
    gp.set_optim_params(params={**optim, "init_cov_pars": d["init_cov"],
                                "init_coef_aux_pars_from_iid_model": False})
    bst = gpt.train({**GOLDEN_BOOST, "learning_rate": 0.05},
                    gpt.Dataset(d["X_train"], label=d["y_train"]),
                    num_boost_round=20, gp_model=gp)
    return gp, bst


class TestGPBoostingGolden:
    PRED_RE = np.array([0.19200894, 0.08380017, 0.59402383, -0.75484438])
    PRED_FE = np.array([3.920440, 3.641091, 4.536346, 4.951052])
    PRED_VAR = np.array([0.3612252, 0.1596113, 0.1664702, 0.2577366])

    @pytest.fixture(scope="class")
    def fitted(self, gp_data):
        return _train_gp_golden(gp_data, {"maxit": 20,
                                          "optimizer_cov": "fisher_scoring"})

    def test_cov_pars(self, fitted):
        ref = np.array([0.1358229, 0.9099908, 0.1115316])
        assert np.sum(np.abs(fitted[0].get_cov_pars() - ref)) < 0.08

    def test_latent_prediction(self, fitted, gp_data):
        d = gp_data
        pred = fitted[1].predict(d["X_test"], gp_coords_pred=d["c_test"],
                                 predict_var=True, pred_latent=True)
        fe, re = pred["fixed_effect"], pred["random_effect_mean"]
        assert np.sum(np.abs(re[-4:] - self.PRED_RE)) < 0.15
        assert np.sum(np.abs(pred["random_effect_cov"][-4:]
                             - self.PRED_VAR)) < 0.08
        assert np.sum(np.abs(fe[-4:] - self.PRED_FE)) < 1.2
        assert abs(np.sqrt(np.mean((fe - d["f_test"]) ** 2))
                   - 0.5229658) < 0.08
        assert abs(np.sqrt(np.mean((fe + re - d["y_test"]) ** 2))
                   - 0.8304062) < 0.05

    def test_response_and_cov_mat(self, fitted, gp_data):
        d = gp_data
        gp, bst = fitted
        kw = dict(gp_coords_pred=d["c_test"], predict_var=True)
        resp = bst.predict(d["X_test"], pred_latent=False, **kw)
        lat = bst.predict(d["X_test"], pred_latent=True, **kw)
        np.testing.assert_allclose(
            resp["response_mean"],
            lat["fixed_effect"] + lat["random_effect_mean"], atol=1e-10)
        np.testing.assert_allclose(
            resp["response_var"],
            lat["random_effect_cov"] + gp.get_cov_pars()[0], atol=1e-10)
        predc = bst.predict(d["X_test"][-3:], gp_coords_pred=d["c_test"][-3:],
                            predict_cov_mat=True, pred_latent=True)
        cov = np.asarray(predc["random_effect_cov"])
        assert cov.shape == (3, 3)
        ref_diag = np.array([1.596106e-01, 1.664696e-01, 2.577362e-01])
        assert np.sum(np.abs(np.diag(cov) - ref_diag)) < 0.05
        assert np.max(np.abs(cov[~np.eye(3, dtype=bool)])) < 1e-3

    def test_cov_pars_override_in_predict(self, fitted, gp_data):
        d = gp_data
        kw = dict(gp_coords_pred=d["c_test"], predict_var=True,
                  pred_latent=True)
        p1 = fitted[1].predict(d["X_test"], cov_pars=np.array(
            [0.1358229, 0.9099908, 0.1115316]), **kw)
        assert np.sum(np.abs(p1["random_effect_mean"][-4:]
                             - self.PRED_RE)) < 0.15
        p2 = fitted[1].predict(d["X_test"],
                               cov_pars=np.array([0.2, 1.5, 0.2]), **kw)
        re2 = np.array([0.2182825, 0.1131264, 0.5737999, -0.7441675])
        var2 = np.array([0.3540400, 0.1704857, 0.1720302, 0.2562620])
        assert np.sum(np.abs(p2["random_effect_mean"][-4:] - re2)) < 0.15
        assert np.sum(np.abs(p2["random_effect_cov"][-4:] - var2)) < 0.05

    def test_nelder_mead_variant(self, gp_data):
        gp, _ = _train_gp_golden(gp_data, {"optimizer_cov": "nelder_mead",
                                           "delta_rel_conv": 1e-6})
        ref = np.array([0.1286928, 0.9140254, 0.1097192])
        assert np.sum(np.abs(gp.get_cov_pars() - ref)) < 0.1
