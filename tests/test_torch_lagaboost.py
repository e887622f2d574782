"""LaGaBoost (boosting with a non-Gaussian grouped GPModel) in the PyTorch
port against the JAX package's host loop.

Data: the design of tests/test_lagaboost_golden.py (sim_friedman3, a
probit link, the R suite's LCG) cut to ntrain = 300 rows and 15 groups,
and the binary block's settings (max_depth 6, min_data_in_leaf 5,
learning rate 0.1, gradient descent for the covariance parameter), 5
rounds; the JAX side runs its host loop (a callback turns the fused scan
off). Trees split alike, the covariance parameter agrees to rtol 1e-5 and
the latent and response predictions to 1e-6 (leaf values are float32
histogram sums in another order); new groups get a latent mean of exactly
0. Model dicts load both ways, the objective is inferred from the GP
model, and fisher_scoring is rejected.
"""

import os
import sys

import numpy as np
import pytest
import torch
from scipy.stats import norm

import gpboost_tpu as gpb

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.convert import booster_from_jax_dict

sys.path.insert(0, os.path.dirname(__file__))
from test_lagaboost_golden import sim_friedman3, sim_rand_unif  # noqa: E402

torch.set_num_threads(1)

NTRAIN, GROUPS, ROUNDS = 300, 15, 5
BOOST = {"learning_rate": 0.1, "max_depth": 6, "min_data_in_leaf": 5,
         "verbose": 0}
OPT = {"optimizer_cov": "gradient_descent", "use_nesterov_acc": False,
       "delta_rel_conv": 1e-6, "lr_cov": 0.01, "init_cov_pars": [1.0],
       "init_coef_aux_pars_from_iid_model": False}


@pytest.fixture(scope="module")
def data():
    n = 2 * NTRAIN
    X, f = sim_friedman3(n)
    f = f - f.mean()
    g = np.repeat(np.arange(1, GROUPS + 1), NTRAIN // GROUPS).astype(float)
    g = np.concatenate([g, g])
    g[-3:] = 99999
    _, inv = np.unique(g, return_inverse=True)
    b = np.sqrt(0.6) * norm.ppf(sim_rand_unif(GROUPS + 1, 0.5542))
    eps = b[inv] - b[inv].mean()
    y = (sim_rand_unif(n, 0.574) < norm.cdf(f + eps)).astype(float)
    return X, g, y


@pytest.fixture(scope="module")
def both(data):
    X, g, y = data
    gj = gpb.GPModel(group_data=g[:NTRAIN], likelihood="bernoulli_probit")
    gj.set_optim_params(params=OPT)
    bj = gpb.train({**BOOST, "objective": "binary"},
                   gpb.Dataset(X[:NTRAIN], label=y[:NTRAIN]),
                   num_boost_round=ROUNDS, gp_model=gj,
                   callbacks=[lambda env: None])
    gp = gpt.GPModel(group_data=g[:NTRAIN], likelihood="bernoulli_probit",
                     device="cpu")
    gp.set_optim_params(params=OPT)
    bp = gpt.train({**BOOST, "objective": "binary"},
                   gpt.Dataset(X[:NTRAIN], label=y[:NTRAIN]),
                   num_boost_round=ROUNDS, gp_model=gp)
    return bj, gj, bp, gp


def _splits(tree):
    nn = tree.num_nodes
    internal = ~tree.is_leaf[:nn]
    return (tree.is_leaf[:nn].tolist(),
            tree.split_feature[:nn][internal].tolist(),
            tree.threshold_bin[:nn][internal].tolist())


def test_lagaboost_matches_jax(both, data):
    bj, gj, bp, gp = both
    X, g, _ = data
    assert bp.objective_name == bj.objective_name == "bernoulli_probit"
    np.testing.assert_allclose(bp.init_score, bj.init_score, rtol=1e-10)
    assert [_splits(t) for t in bp.trees] == [_splits(t) for t in bj.trees]
    np.testing.assert_allclose(bp.F.numpy(), bj.F, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-5)
    for latent in (True, False):
        pj = bj.predict(X[NTRAIN:], group_data_pred=g[NTRAIN:],
                        predict_var=True, pred_latent=latent)
        pp = bp.predict(X[NTRAIN:], group_data_pred=g[NTRAIN:],
                        predict_var=True, pred_latent=latent)
        assert set(pp) == set(pj)
        for k in pj:
            np.testing.assert_allclose(pp[k], np.asarray(pj[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
        if latent:
            np.testing.assert_array_equal(pp["random_effect_mean"][-3:],
                                          np.zeros(3))
    rj = bj.predict_training_data_random_effects()
    rp = bp.predict_training_data_random_effects()
    np.testing.assert_allclose(rp["Group_1"], rj["Group_1"].values,
                               rtol=0, atol=1e-6)


def test_model_dicts_both_ways(both, data):
    bj, gj, bp, gp = both
    X, g, _ = data
    kw = dict(group_data_pred=g[NTRAIN:], predict_var=True)
    ref = bp.predict(X[NTRAIN:], **kw)
    b2, g2 = booster_from_jax_dict(bp.model_to_dict(), device="cpu")
    assert g2.likelihood == "bernoulli_probit"
    for k, v in b2.predict(X[NTRAIN:], **kw).items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-10, err_msg=k)
    bj2 = gpb.Booster(model_dict=bp.model_to_dict())
    pj = bj2.predict(X[NTRAIN:], **kw)
    for k in ref:
        np.testing.assert_allclose(np.asarray(pj[k]), ref[k], rtol=0,
                                   atol=1e-8, err_msg=k)
    b3, _ = booster_from_jax_dict(bj.model_to_dict(), device="cpu")
    pj = bj.predict(X[NTRAIN:], **kw)
    for k, v in b3.predict(X[NTRAIN:], **kw).items():
        np.testing.assert_allclose(v, np.asarray(pj[k]), rtol=0, atol=1e-8,
                                   err_msg=k)


def test_objective_inferred_and_fisher_rejected(data):
    X, g, y = data
    ds = gpt.Dataset(X[:NTRAIN], label=y[:NTRAIN])
    gp = gpt.GPModel(group_data=g[:NTRAIN], likelihood="bernoulli_logit",
                     device="cpu")
    bst = gpt.Booster(dict(BOOST), ds, gp_model=gp, device="cpu")
    assert bst.objective_name == "bernoulli_logit"
    gp = gpt.GPModel(group_data=g[:NTRAIN], likelihood="bernoulli_probit",
                     device="cpu")
    gp.set_optim_params(params={"maxit": 2,
                                "optimizer_cov": "fisher_scoring"})
    with pytest.raises(ValueError):
        gpt.train({**BOOST, "objective": "binary"}, ds, num_boost_round=1,
                  gp_model=gp)
    # without a GP model the objective's own checks apply (the objectives:
    # tests/test_torch_objectives.py, tests/test_torch_booster_modes.py):
    # multiclass needs num_class >= 2
    with pytest.raises(ValueError, match="num_class"):
        gpt.train({**BOOST, "objective": "multiclass"}, ds,
                  num_boost_round=1, device="cpu")
