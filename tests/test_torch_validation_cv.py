"""Model selection in the PyTorch port against the JAX package: the
metrics, validation sets with early stopping (the loop's rule and the
early_stopping callback), the other callbacks, feval, the GP-routed
validation metrics, cv and grid_search_tune_parameters, and the
validation + early stopping + cv flow of examples/03_gpboost_algorithm.py.

One data shape for the file: n = 400 training rows (four folds of 100),
p = 4, 100 validation rows, 7-leaf trees. The JAX side runs its host loop
(validation sets and callbacks turn its fused scan off). Tolerances: the
metric values within 1e-6 relative (the float32 histogram tier of
tests/test_torch_gpboost_slice.py: leaf values are float32 histogram sums
in another order), the GP models' training NLL within 1e-6 relative, the
best iterations, cv's best_iter and grid search's best_params equal. The
port's running validation score equals a fresh predict(num_iteration=k)
bit for bit.
"""

import logging

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu.engine import _metric_fn as jax_metric_fn
from gpboost_tpu.engine import _var_metric_fn as jax_var_metric_fn
from gpboost_tpu_torch.engine import _metric_fn, _var_metric_fn

torch.set_num_threads(1)

N, P, NV, Q = 400, 4, 100, 20
BASE = {"num_leaves": 7, "learning_rate": 0.5, "verbose": 0}


def _data():
    rng = np.random.RandomState(7)
    X = rng.rand(N, P)
    group = rng.randint(0, Q, N)
    coords = rng.rand(N, 2)
    b = 0.8 * rng.randn(Q + 5)
    y = 2 * X[:, 0] + np.sin(5 * X[:, 1]) + b[group] + 0.3 * rng.randn(N)
    Xv = rng.rand(NV, P)
    gv = rng.randint(0, Q + 5, NV)          # five groups unseen in training
    cv_ = rng.rand(NV, 2)
    yv = 2 * Xv[:, 0] + np.sin(5 * Xv[:, 1]) + b[gv] + 0.3 * rng.randn(NV)
    return X, group, coords, y, Xv, gv, cv_, yv


X, GROUP, COORDS, Y, XV, GV, CV, YV = _data()
YB, YBV = (Y > np.median(Y)).astype(float), (YV > np.median(Y)).astype(float)
YP = np.floor(np.exp(0.4 * (Y - Y.mean())) * 2)
YPV = np.floor(np.exp(0.4 * (YV - Y.mean())) * 2)


def _valid(mod, label, pk=None):
    dv = mod.Dataset(XV, label=label)
    if pk is not None:
        dv.gp_valid_data = pk
    return dv


def _train_both(params, label, vlabel, rounds=30, gp=None, pk=None,
                stopping=3, callbacks=(), rows=slice(None)):
    out = []
    for mod in (gpb, gpt):
        kw = {} if mod is gpb else {"device": "cpu"}
        ev = {}
        gpm = None if gp is None else gp(mod, rows, **kw)
        cbs = [c(mod) for c in callbacks]
        b = mod.train(params, mod.Dataset(X[rows], label=label[rows]),
                      num_boost_round=rounds, gp_model=gpm,
                      valid_sets=[_valid(mod, vlabel, pk)],
                      early_stopping_rounds=stopping, evals_result=ev,
                      callbacks=cbs or None, **kw)
        out += [b, ev]
    return out


def _assert_evals(ej, ep, rtol=1e-6):
    assert ej.keys() == ep.keys()
    for nm in ej:
        assert ej[nm].keys() == ep[nm].keys()
        for m in ej[nm]:
            np.testing.assert_allclose(ep[nm][m], ej[nm][m], rtol=rtol,
                                       atol=1e-12, err_msg=m)


def test_metric_functions_equal_jax():
    rng = np.random.RandomState(0)
    y01 = (rng.rand(50) > 0.5).astype(float)
    yc = rng.poisson(2.0, 50).astype(float)
    p = rng.rand(50) * 0.98 + 0.01
    for name in ("l2", "rmse", "l1", "mae", "binary_logloss", "binary_error",
                 "auc", "quantile", "mape", "huber", "fair", "poisson",
                 "gamma", "gamma_deviance", "tweedie", "cross_entropy",
                 "xentropy", "mse"):
        y = y01 if name in ("binary_logloss", "binary_error", "auc",
                            "cross_entropy", "xentropy") else yc
        assert _metric_fn(name)(y, p) == jax_metric_fn(name)(y, p), name
    for name in ("test_neg_log_likelihood", "crps_gaussian"):
        assert _var_metric_fn(name)(yc, p, p + 0.5) \
            == jax_var_metric_fn(name)(yc, p, p + 0.5), name


@pytest.mark.parametrize("metric,objective", [
    ("l2", "regression"), ("rmse", "regression"), ("mae", "regression"),
    ("huber", "huber"), ("fair", "fair"), ("quantile", "quantile"),
    ("mape", "mape"), ("binary_logloss", "binary"),
    ("binary_error", "binary"), ("auc", "binary"),
    ("cross_entropy", "cross_entropy"), ("poisson", "poisson"),
    ("gamma", "gamma"), ("gamma_deviance", "gamma"),
    ("tweedie", "tweedie"), ("test_neg_log_likelihood", "regression"),
    ("crps_gaussian", "regression"), (None, "binary"), (None, "regression"),
])
def test_validation_metric_and_early_stopping_match_jax(metric, objective):
    label, vlabel = Y, YV
    if objective in ("binary", "cross_entropy"):
        label, vlabel = YB, YBV
    elif objective in ("poisson", "tweedie"):
        label, vlabel = YP, YPV
    elif objective == "gamma":
        label, vlabel = YP + 0.5, YPV + 0.5
    params = {**BASE, "objective": objective}
    if metric is not None:
        params["metric"] = metric
    bj, ej, bp, ep = _train_both(params, label, vlabel)
    _assert_evals(ej, ep)
    assert bp.best_iteration == bj.best_iteration
    np.testing.assert_allclose(bp.best_score, bj.best_score, rtol=1e-6)
    # the loop's rule: best_iteration = argmin (argmax for auc) + 1
    (mname, vals), = ep["valid_0"].items()
    best = np.argmax(vals) if mname == "auc" else np.argmin(vals)
    assert bp.best_iteration == best + 1
    # the running score gives the metric of a fresh predict bit for bit
    if metric not in ("test_neg_log_likelihood", "crps_gaussian") \
            and metric is not None:
        k = bp.best_iteration
        assert _metric_fn(metric)(vlabel, bp.predict(XV, num_iteration=k)) \
            == vals[k - 1]


def test_early_stopping_callback_and_record_evaluation_match_jax():
    params = {**BASE, "objective": "binary"}
    recs = {}

    def rec(mod):
        recs[mod.__name__] = {}
        return mod.callback.record_evaluation(recs[mod.__name__])

    def stop(mod):
        return mod.callback.early_stopping(3, verbose=False)

    bj, ej, bp, ep = _train_both(params, YB, YBV, stopping=None,
                                 callbacks=(rec, stop))
    _assert_evals(ej, ep)
    _assert_evals(recs["gpboost_tpu"], recs["gpboost_tpu_torch"])
    assert bp.best_iteration == bj.best_iteration
    vals = ep["valid_0"]["binary_logloss"]
    assert bp.best_iteration == int(np.argmin(vals)) + 1
    # the callback stops 3 rounds after the best one; predict keeps them
    assert len(bp.trees) == bp.best_iteration + 3 == len(bj.trees)


def test_reset_parameter_feval_and_log_evaluation_match_jax():
    params = {**BASE, "objective": "regression"}
    lrs = [0.5, 0.4, 0.3, 0.2, 0.1] + [0.05] * 25

    def reset(mod):
        return mod.callback.reset_parameter(learning_rate=lrs)

    def feval(preds, ds):
        return "mean_abs", float(np.mean(np.abs(preds - ds.get_label()))), \
            False

    lines = []

    class Sink:
        def info(self, msg):
            lines.append(msg)

        def warning(self, msg):
            lines.append(msg)

    out = []
    for mod in (gpb, gpt):
        kw = {} if mod is gpb else {"device": "cpu"}
        ev = {}
        b = mod.train(params, mod.Dataset(X, label=Y), num_boost_round=12,
                      valid_sets=[_valid(mod, YV)], feval=feval,
                      evals_result=ev, early_stopping_rounds=4,
                      callbacks=[reset(mod)], **kw)
        out += [b, ev]
    bj, ej, bp, ep = out
    _assert_evals(ej, ep)
    assert bp.best_iteration == bj.best_iteration
    assert bp.params["learning_rate"] == bj.params["learning_rate"]
    gpt.register_logger(Sink())
    try:
        gpt.train(params, gpt.Dataset(X, label=Y), num_boost_round=4,
                  valid_sets=[_valid(gpt, YV)], verbose_eval=2,
                  device="cpu")
    finally:
        gpt.register_logger(None)
    assert len(lines) == 2 and lines[0].startswith("[GPBoost] [Info] [2]")


def _grouped(mod, rows=slice(None), **kw):
    return mod.GPModel(group_data=GROUP[rows], **kw)


def _vecchia(mod, rows=slice(None), **kw):
    return mod.GPModel(gp_coords=COORDS[rows], cov_function="exponential",
                       gp_approx="vecchia", num_neighbors=10, **kw)


def _grouped_logit(mod, rows=slice(None), **kw):
    return mod.GPModel(group_data=GROUP[rows], likelihood="bernoulli_logit",
                       **kw)


@pytest.mark.parametrize("model,metric", [
    ("grouped", "l2"), ("grouped", "test_neg_log_likelihood"),
    ("grouped", "neg_log_likelihood"), ("grouped", "crps_gaussian"),
    ("vecchia", "l2"),
])
def test_gp_routed_validation_matches_jax(model, metric):
    gp = {"grouped": _grouped, "vecchia": _vecchia}[model]
    pk = {"gp_coords_pred": CV} if model == "vecchia" \
        else {"group_data_pred": GV}
    # the JAX package's GP compiles dominate: 3 rounds, and the grouped
    # model on the first 300 rows, the shape of cv's folds below
    bj, ej, bp, ep = _train_both({**BASE, "metric": metric}, Y, YV,
                                 rounds=3, gp=gp, pk=pk, stopping=2,
                                 rows=slice(0, 300) if model == "grouped"
                                 else slice(None))
    _assert_evals(ej, ep)
    assert bp.best_iteration == bj.best_iteration
    if metric == "l2":
        # the GP-routed metric of a fresh predict, from the current fit
        pred = bp.predict(XV, **pk)["response_mean"]
        assert _metric_fn(metric)(YV, pred) == ep["valid_0"][metric][-1]


def test_laplace_routed_validation_matches_jax():
    """Grouped LaGaBoost (bernoulli_logit) validated through
    gp_valid_data: binary_logloss round by round against the JAX package;
    test_neg_log_likelihood (adaptive Gauss-Hermite over the latent
    predictive distribution) and approx_neg_marginal_log_likelihood (the
    GP model's Laplace NLL) after the last round against the JAX
    booster's state. One JAX training: its Laplace compiles dominate."""
    pk = {"group_data_pred": GV}
    gj = _grouped_logit(gpb)
    ej = {}
    bj = gpb.train({**BASE, "metric": "binary_logloss"},
                   gpb.Dataset(X, label=YB), num_boost_round=3,
                   gp_model=gj, valid_sets=[_valid(gpb, YBV, pk)],
                   evals_result=ej)
    pj = bj.predict(XV, pred_latent=True, predict_var=True, **pk)
    want = {
        "binary_logloss": ej["valid_0"]["binary_logloss"][-1],
        "test_neg_log_likelihood": float(
            gj._likelihood_obj.test_neg_log_likelihood(
                YBV, np.asarray(pj["fixed_effect"]
                                + pj["random_effect_mean"]),
                np.asarray(pj["random_effect_var"]),
                gj._fit_result.aux_pars)),
        "approx_neg_marginal_log_likelihood": float(
            gj._fit_result.neg_log_likelihood)}
    for metric, value in want.items():
        ep = {}
        gp = _grouped_logit(gpt, device="cpu")
        bp = gpt.train({**BASE, "metric": metric},
                       gpt.Dataset(X, label=YB), num_boost_round=3,
                       gp_model=gp, valid_sets=[_valid(gpt, YBV, pk)],
                       evals_result=ep, device="cpu")
        if metric == "binary_logloss":
            _assert_evals(ej, ep)
        np.testing.assert_allclose(ep["valid_0"][metric][-1], value,
                                   rtol=1e-6, err_msg=metric)
        assert bp.best_iteration == int(np.argmin(ep["valid_0"][metric])) + 1


def test_cv_matches_jax():
    params = {**BASE, "objective": "regression", "learning_rate": 0.3}
    rj = gpb.cv(params, gpb.Dataset(X, label=Y), num_boost_round=8,
                nfold=4, seed=3, eval_train_metric=True,
                return_cvbooster=True)
    rp = gpt.cv(params, gpt.Dataset(X, label=Y), num_boost_round=8,
                nfold=4, seed=3, eval_train_metric=True,
                return_cvbooster=True, device="cpu")
    assert rp.keys() == rj.keys()
    for k in ("l2-mean", "l2-stdv", "train l2-mean", "train l2-stdv"):
        np.testing.assert_allclose(rp[k], rj[k], rtol=1e-6, err_msg=k)
    assert rp["best_iter"] == rj["best_iter"]
    assert rp["cvbooster"].best_iteration == rj["cvbooster"].best_iteration
    for pj, pp in zip(rj["cvbooster"].predict(XV),
                      rp["cvbooster"].predict(XV)):
        np.testing.assert_allclose(pp, pj, rtol=0, atol=1e-6)


def test_cv_stratified_feval_and_grouped_gp_match_jax():
    def feval(preds, ds):
        return "acc", float(np.mean((preds > 0.5) == ds.get_label())), True

    params = {**BASE, "objective": "binary"}
    out = []
    for mod in (gpb, gpt):
        kw = {} if mod is gpb else {"device": "cpu"}
        out.append(mod.cv(params, mod.Dataset(X, label=YB),
                          num_boost_round=6, nfold=4, stratified=True,
                          seed=1, eval=feval, **kw))
    rj, rp = out
    np.testing.assert_allclose(rp["binary_logloss-mean"],
                               rj["binary_logloss-mean"], rtol=1e-6)
    assert rp["best_iter"] == rj["best_iter"]
    out = []
    for mod in (gpb, gpt):
        kw = {} if mod is gpb else {"device": "cpu"}
        out.append(mod.cv({**BASE, "learning_rate": 0.3},
                          mod.Dataset(X, label=Y),
                          gp_model=_grouped(mod, **kw), num_boost_round=3,
                          nfold=4, early_stopping_rounds=2, seed=5,
                          metrics="test_neg_log_likelihood", **kw))
    rj, rp = out
    for k in ("test_neg_log_likelihood-mean",
              "test_neg_log_likelihood-stdv"):
        np.testing.assert_allclose(rp[k], rj[k], rtol=1e-6, err_msg=k)
    assert rp["best_iter"] == rj["best_iter"]


def test_grid_search_matches_jax():
    grid = {"learning_rate": [0.1, 0.5], "min_data_in_leaf": [5, 50]}
    params = {**BASE, "objective": "regression"}
    out = []
    for mod in (gpb, gpt):
        kw = {} if mod is gpb else {"device": "cpu"}
        out.append(mod.grid_search_tune_parameters(
            grid, params=params, train_set=mod.Dataset(X, label=Y), nfold=4,
            num_boost_round=6, num_try_random=3, seed=2, **kw))
    rj, rp = out
    assert rp["best_params"] == rj["best_params"]
    assert rp["best_iter"] == rj["best_iter"]
    np.testing.assert_allclose(rp["best_score"], rj["best_score"], rtol=1e-6)


def test_example_03_validation_and_cv_flow_matches_jax():
    """examples/03_gpboost_algorithm.py:42-60 at n = 400: a grouped GP
    model validated through gp_valid_data with early stopping, then cv of
    grouped GPBoost."""
    tr = np.arange(N) < 300
    out = []
    for mod in (gpb, gpt):
        kw = {} if mod is gpb else {"device": "cpu"}
        data_valid = mod.Dataset(X[~tr], label=Y[~tr])
        data_valid.gp_valid_data = {"group_data_pred": GROUP[~tr]}
        evals = {}
        bst = mod.train(params={"learning_rate": 0.1, "num_leaves": 31},
                        train_set=mod.Dataset(X[tr], label=Y[tr]),
                        gp_model=mod.GPModel(group_data=GROUP[tr], **kw),
                        num_boost_round=40, valid_sets=data_valid,
                        early_stopping_rounds=3, evals_result=evals, **kw)
        cvres = mod.cv(params={"learning_rate": 0.1, "num_leaves": 31},
                       train_set=mod.Dataset(X, label=Y),
                       gp_model=mod.GPModel(group_data=GROUP, **kw),
                       num_boost_round=5, nfold=4, seed=7, **kw)
        out.append((bst, evals, cvres))
    (bj, ej, cj), (bp, ep, cp) = out
    _assert_evals(ej, ep)
    assert bp.best_iteration == bj.best_iteration
    np.testing.assert_allclose(bp.best_score, bj.best_score, rtol=1e-6)
    np.testing.assert_allclose(cp["l2-mean"], cj["l2-mean"], rtol=1e-6)
    assert int(np.argmin(cp["l2-mean"])) == int(np.argmin(cj["l2-mean"]))


def test_log_level_and_logger_checks():
    with pytest.raises(ValueError):
        gpt.set_log_level("loud")
    with pytest.raises(TypeError):
        gpt.register_logger(object())
    gpt.register_logger(logging.getLogger("gpboost_tpu_torch_test"))
    gpt.register_logger(None)


@pytest.mark.parametrize("likelihood", ["gaussian", "bernoulli_logit"])
def test_grouped_predictions_gather_equals_dense_path(likelihood):
    """The grouped engines predict the mean and variances by gathers from
    the posterior (what validation runs every round); with predict_cov_mat
    they build the reference's dense (n_pred, q) incidence. Crossed
    groupings, a random slope and unseen levels give the same values."""
    rng = np.random.RandomState(11)
    g2 = np.column_stack([GROUP, rng.randint(0, 7, N)])
    gv2 = np.column_stack([GV, rng.randint(0, 9, NV)])   # 2 levels unseen
    z, zv = rng.rand(N), rng.rand(NV)
    label = Y if likelihood == "gaussian" else YB
    gp = gpt.GPModel(group_data=g2, group_rand_coef_data=z,
                     ind_effect_group_rand_coef=[1], likelihood=likelihood,
                     device="cpu")
    gp.fit(y=label, params={"maxit": 5})
    kw = dict(group_data_pred=gv2, group_rand_coef_data_pred=zv,
              predict_response=likelihood == "gaussian")
    a = gp.predict(predict_var=True, **kw)
    b = gp.predict(predict_cov_mat=True, **kw)
    np.testing.assert_allclose(a["mu"], b["mu"], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(a["var"], np.diagonal(b["cov"]), rtol=1e-12)
