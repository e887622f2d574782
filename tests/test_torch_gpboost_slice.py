"""The Gaussian GPBoost slice of the PyTorch port against the JAX package.

n = 400, p = 5, Vecchia with 10 neighbours, 7-leaf trees, 5 rounds,
float64. The JAX side runs its host loop (a callback turns the fused scan
off, as tests/test_scan_train.py does), the port always does. Tolerances:
the trees' leaf values are float32 histogram sums in another order (~1e-7),
so training scores and predictions agree to 1e-6 and the refitted
covariance parameters to rtol 1e-5; tree splits are equal.
"""

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.convert import booster_from_jax_dict

torch.set_num_threads(1)

N, P, M, LEAVES, ROUNDS = 400, 5, 10, 7, 5
PARAMS = {"objective": "regression", "learning_rate": 0.1,
          "num_leaves": LEAVES, "verbose": 0}


def _data(n=N, seed=1):
    rng = np.random.RandomState(seed)
    coords = rng.rand(n, 2)
    X = rng.rand(n, P)
    y = (np.sin(3 * X[:, 0]) + X[:, 1] ** 2
         + np.sin(6 * coords[:, 0]) * np.cos(4 * coords[:, 1])
         + 0.3 * rng.randn(n))
    return coords, X, y


def _new_points(n=60, seed=2):
    rng = np.random.RandomState(seed)
    return rng.rand(n, P), rng.rand(n, 2)


@pytest.fixture(scope="module")
def trained():
    coords, X, y = _data()
    gj = gpb.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=M)
    bj = gpb.train(PARAMS, gpb.Dataset(X, label=y), num_boost_round=ROUNDS,
                   gp_model=gj, callbacks=[lambda env: None])
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=M, device="cpu")
    bp = gpt.train(PARAMS, gpt.Dataset(X, label=y), num_boost_round=ROUNDS,
                   gp_model=gp)
    return bj, gj, bp, gp


def test_cov_pars_match(trained):
    _, gj, _, gp = trained
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-5)


def test_tree_splits_match(trained):
    bj, _, bp, _ = trained
    assert len(bp.trees) == len(bj.trees) == ROUNDS
    for tj, tp in zip(bj.trees, bp.trees):
        nn = tj.num_nodes
        assert tp.num_nodes == nn
        internal = ~tj.is_leaf[:nn]
        np.testing.assert_array_equal(tp.is_leaf[:nn], tj.is_leaf[:nn])
        np.testing.assert_array_equal(tp.split_feature[:nn][internal],
                                      tj.split_feature[:nn][internal])
        np.testing.assert_array_equal(tp.threshold_bin[:nn][internal],
                                      tj.threshold_bin[:nn][internal])


def test_training_score_and_predictions_match(trained):
    bj, _, bp, _ = trained
    np.testing.assert_allclose(bp.F.numpy(), bj.F, rtol=0, atol=1e-6)
    Xn, cn = _new_points()
    pj = bj.predict(Xn, gp_coords_pred=cn, predict_var=True)
    pp = bp.predict(Xn, gp_coords_pred=cn, predict_var=True)
    for k in ("response_mean", "fixed_effect", "random_effect_mean"):
        np.testing.assert_allclose(pp[k], pj[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(pp["response_var"], pj["response_var"],
                               rtol=1e-5)


def test_jax_model_dict_predicts_the_same_in_the_port(trained):
    bj, _, _, _ = trained
    bc, gc = booster_from_jax_dict(bj.model_to_dict(), device="cpu")
    np.testing.assert_array_equal(gc.get_cov_pars(),
                                  bj.gp_model.get_cov_pars())
    Xn, cn = _new_points(seed=3)
    pj = bj.predict(Xn, gp_coords_pred=cn, predict_var=True)
    pc = bc.predict(Xn, gp_coords_pred=cn, predict_var=True)
    for k in ("response_mean", "response_var", "fixed_effect"):
        np.testing.assert_allclose(pc[k], pj[k], rtol=0, atol=1e-10,
                                   err_msg=k)


@pytest.mark.parametrize("change", ["no_gp_model", "dense_gp", "two_sets"])
def test_unported_jax_model_dicts_raise(trained, change):
    d = trained[0].model_to_dict()
    if change == "no_gp_model":
        # a booster without a GP model loads (test_torch_parallel_learner),
        # with every objective (test_torch_objectives.py,
        # test_torch_booster_modes.py): a multiclass dict of one block, as
        # the JAX package loads it, predicts its class probabilities
        d["has_gp_model"] = 0
        d["objective"] = "multiclass"
        b, gp = booster_from_jax_dict(d, device="cpu")
        assert gp is None and b._nsets == 1
        np.testing.assert_allclose(b.predict(_new_points(seed=4)[0]), 1.0)
        return
    elif change == "dense_gp":
        # a dense GP loads, with cluster_ids too
        # (tests/test_torch_weights_clusters.py) and with GP random
        # coefficients (tests/test_torch_svc_sampling_adam.py): one
        # column of ones is a second GP on the same coordinates
        d["gp_model"] = {**d["gp_model"], "gp_approx": "none",
                         "cov_pars": d["gp_model"]["cov_pars"] + [0.1, 0.2],
                         "gp_rand_coef_data": np.ones(N).tolist()}
        _, gp = booster_from_jax_dict(d, device="cpu")
        assert gp.get_cov_par_names()[-2:] == [
            "GP_rand_coef_nb_1_var", "GP_rand_coef_nb_1_range"]
        np.testing.assert_array_equal(gp.gp_rand_coef_data, np.ones((N, 1)))
        return
    else:
        # two predictor sets without a two-predictor likelihood (the
        # two-predictor models load: tests/test_torch_two_predictor.py)
        d["num_sets"] = 2
    with pytest.raises(NotImplementedError):
        booster_from_jax_dict(d, device="cpu")


def test_port_model_dict_loads_in_jax(trained):
    _, _, bp, _ = trained
    bl = gpb.Booster(model_dict=bp.model_to_dict())
    Xn, cn = _new_points(seed=4)
    pl = bl.predict(Xn, gp_coords_pred=cn)
    pp = bp.predict(Xn, gp_coords_pred=cn)
    np.testing.assert_allclose(pp["response_mean"], pl["response_mean"],
                               rtol=0, atol=1e-10)


def test_float32_engine_trains():
    coords, X, y = _data(n=300, seed=5)
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=M, dtype="float32",
                     device="cpu")
    assert gp._engine._d_nn.dtype == torch.float32
    bst = gpt.train(PARAMS, gpt.Dataset(X, label=y), num_boost_round=2,
                    gp_model=gp)
    cov = gp.get_cov_pars()
    assert np.all(np.isfinite(cov)) and np.all(cov > 0)
    Xn, cn = _new_points()
    assert np.all(np.isfinite(bst.predict(Xn, gp_coords_pred=cn)[
        "response_mean"]))


# use_nesterov_acc is ported (tests/test_torch_weights_clusters.py),
# bagging with a GP model (tests/test_torch_objectives.py), extra_trees
# (tests/test_torch_tree_breadth.py), DART, GOSS and linear trees
# (tests/test_torch_booster_modes.py); what the reference refuses with a
# GP model still raises: DART with Nesterov momentum, random forests, and
# (in the port) an objective other than the Gaussian GP model's
@pytest.mark.parametrize("params", [{"boosting": "dart",
                                     "use_nesterov_acc": True},
                                    {"boosting": "rf"},
                                    {"objective": "binary"},
                                    {"objective": "multiclass",
                                     "num_class": 3}])
def test_unported_booster_options_raise(params):
    coords, X, y = _data(n=300, seed=6)
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=M, device="cpu")
    err = NotImplementedError if "objective" in params else ValueError
    with pytest.raises(err):
        gpt.Booster({**PARAMS, **params}, gpt.Dataset(X, label=y),
                    gp_model=gp)


# ----------------------------------------------------------------------
# plain boosting (no GP model): Dataset weights, boost_from_average and the
# reference's parameter aliases, held to the JAX package at n = 500, p = 4,
# 7 leaves, 3 rounds (predictions to 1e-6), or raising NotImplementedError
# naming the unported option
N_PLAIN, P_PLAIN = 500, 4
PLAIN = {"objective": "regression", "num_leaves": 7, "verbose": 0}


def _plain_data(p=P_PLAIN):
    rng = np.random.RandomState(11)
    X = rng.rand(N_PLAIN, p)
    y = 2 * X[:, 0] + np.sin(5 * X[:, 1]) + 0.3 * rng.randn(N_PLAIN)
    return X, y, 0.2 + rng.rand(N_PLAIN)


@pytest.mark.parametrize("case", ["weights", "no_boost_from_average",
                                  "aliases_at_defaults"])
def test_plain_boosting_options_match_jax(case):
    X, y, w = _plain_data()
    params, wt = dict(PLAIN), None
    if case == "weights":
        wt = w
    elif case == "no_boost_from_average":
        params["boost_from_average"] = False
    else:
        params.update(subsample=1.0, subsample_freq=0, colsample_bytree=1.0,
                      sub_row=1.0, bagging=1.0, sub_feature=1.0,
                      monotone_constraint=None, unbalance=False,
                      unbalanced_sets=False)
    bj = gpb.train(params, gpb.Dataset(X, label=y, weight=wt),
                   num_boost_round=3, callbacks=[lambda env: None])
    bp = gpt.train(params, gpt.Dataset(X, label=y, weight=wt),
                   num_boost_round=3, device="cpu")
    np.testing.assert_allclose(bp.init_score, bj.init_score, rtol=1e-12)
    np.testing.assert_allclose(bp.predict(X), np.asarray(bj.predict(X)),
                               rtol=0, atol=1e-6)
    if case == "no_boost_from_average":
        assert bp.init_score == 0.0


# bagging, feature_fraction, is_unbalance, alpha and the sampling seeds
# are ported (tests/test_torch_objectives.py), and the tree learner's split
# options (tests/test_torch_tree_breadth.py)
@pytest.mark.parametrize("params,key", [
    ({"boosting_type": "goss"}, "boosting"),
    ({"boost": "rf"}, "boosting"),
    ({"top_rate": 0.3}, "top_rate"),
    ({"other_rate": 0.2}, "other_rate"),
    ({"max_drop": 10}, "max_drop"),
    ({"skip_drop": 0.2}, "skip_drop"),
    ({"linear_tree": True}, "linear_tree"),
    ({"lambdarank_norm": False}, "lambdarank_norm"),
    ({"lambdarank_truncation_level": 10}, "lambdarank_truncation_level"),
    ({"objective_seed": 7}, "objective_seed"),
    ({"label_gain": [0, 1, 3]}, "label_gain"),
    ({"drop_rate": 0.2}, "drop_rate"),
    ({"drop_seed": 9}, "drop_seed"),
    ({"eval_at": [1, 3]}, "eval_at"),
    ({"refit_decay_rate": 0.5}, "refit_decay_rate"),
])
def test_plain_boosting_unported_options_raise(params, key):
    """The booster's modes and their options are ported
    (tests/test_torch_booster_modes.py): each is read under its canonical
    name, and only what the reference refuses raises, a random forest
    without bagging."""
    X, y, _ = _plain_data()
    if params.get("boost") == "rf":
        with pytest.raises(ValueError, match="bagging"):
            gpt.train({**PLAIN, **params}, gpt.Dataset(X, label=y),
                      num_boost_round=1, device="cpu")
        return
    bst = gpt.train({**PLAIN, **params}, gpt.Dataset(X, label=y),
                    num_boost_round=1, device="cpu")
    assert bst.params[key] == list(params.values())[0]
    assert bst.num_trees() == 1


def test_reference_defaults_pass_and_every_key_is_known():
    """Every key of the reference's _BOOST_PARAM_DEFAULTS is read or
    checked by the port, and passing all of them at their defaults (eval_at
    as a list) trains."""
    from gpboost_tpu.boosting.gbdt import _BOOST_PARAM_DEFAULTS as ref
    from gpboost_tpu_torch.boosting.gbdt import _BOOST_PARAM_DEFAULTS
    assert set(ref) <= set(_BOOST_PARAM_DEFAULTS)
    X, y, _ = _plain_data()
    params = {**ref, **PLAIN, "eval_at": list(ref["eval_at"])}
    bp = gpt.train(params, gpt.Dataset(X, label=y), num_boost_round=1,
                   device="cpu")
    assert len(bp.trees) == 1
