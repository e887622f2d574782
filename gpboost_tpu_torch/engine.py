"""Evaluation metrics, cross-validation and parameter search of the PyTorch
port (counterpart of gpboost_tpu/engine.py; reference python-package/
gpboost/engine.py: cv :575, grid_search_tune_parameters :906).

The metrics are numpy functions of the host copy of a prediction, copied
from the JAX package: a validation prediction is read back once per round
and scored on the host.

`cv` advances the k fold boosters in lockstep, one round each, every fold
with its own clone of the GP model (its engine built on the fold's rows).
Each fold's held-out rows keep a running raw score that takes the new tree
each round (`gbdt._RunningScore`), equal bitwise to a fresh
`predict(num_iteration=k)`, so the folds' predictions cost one tree pass a
round instead of k. With a GP model the random-effect part is predicted
again every round, since the covariance parameters are refitted.
"""

import itertools

import numpy as np

from .boosting import Dataset
from .boosting.gbdt import Booster, _RunningScore
from .gp_model import GPModel

_METRIC_ALIASES = {
    "l2": "l2", "mse": "l2", "mean_squared_error": "l2",
    "regression": "l2", "regression_l2": "l2",
    "rmse": "rmse", "root_mean_squared_error": "rmse",
    "l1": "mae", "mae": "mae", "mean_absolute_error": "mae",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "auc": "auc",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multi_error": "multi_error",
    "quantile": "quantile", "cross_entropy": "cross_entropy",
    "xentropy": "cross_entropy",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "huber": "huber", "fair": "fair",
    "tweedie": "tweedie",
    "poisson": "poisson", "gamma": "gamma",
    "gamma_deviance": "gamma_deviance",
    "binary_error": "binary_error",
    "neg_log_likelihood": "neg_log_likelihood",
    "approx_neg_marginal_log_likelihood": "approx_neg_marginal_log_likelihood",
    "test_neg_log_likelihood": "test_neg_log_likelihood",
    "crps_gaussian": "crps_gaussian",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "map": "map", "mean_average_precision": "map",
}

# metrics where larger is better (LightGBM metric headers)
_MAXIMIZE_METRICS = {"auc", "ndcg", "map"}

# metrics needing query information (rank_metric.hpp, map_metric.hpp):
# `train` scores them on validation sets with a group
_RANK_METRICS = {"ndcg", "map"}

# GP-routed metrics evaluated on the training data from the GP model's
# state (random_effects_metric.hpp:25 NegLogLikelihood, :69
# LatenGaussianLaplace)
_GP_TRAIN_METRICS = {"neg_log_likelihood", "approx_neg_marginal_log_likelihood"}

# metrics needing a predictive variance (regression_metric.hpp:373
# TestNegLogLikelihood; crps in test_z_GPBoost_algorithm.R:602-616)
_VAR_METRICS = {"test_neg_log_likelihood", "crps_gaussian"}


def metric_higher_better(name):
    return _METRIC_ALIASES.get(name, name) in _MAXIMIZE_METRICS


def _var_metric_fn(name):
    """Metrics of (y, pred_mean, pred_var)."""
    name = _METRIC_ALIASES.get(name, name)
    if name == "test_neg_log_likelihood":
        # Gaussian predictive NLL (regression_metric.hpp:436-441); the
        # non-Gaussian quadrature version is the likelihood's own
        return lambda y, mu, var: float(np.mean(
            0.5 * ((y - mu) ** 2 / var + np.log(2.0 * np.pi * var))))
    if name == "crps_gaussian":
        def crps(y, mu, var):
            from scipy.stats import norm
            sd = np.sqrt(var)
            r = (y - mu) / sd
            return float(np.mean(sd * (-1.0 / np.sqrt(np.pi)
                                       + 2.0 * norm.pdf(r)
                                       + r * (2.0 * norm.cdf(r) - 1.0))))
        return crps
    raise ValueError(f"unknown variance metric '{name}'")


def _metric_fn(name):
    name = _METRIC_ALIASES.get(name, name)
    if name == "mae":
        return lambda y, p: float(np.mean(np.abs(y - p)))
    if name == "l2":
        return lambda y, p: float(np.mean((y - p) ** 2))
    if name == "rmse":
        return lambda y, p: float(np.sqrt(np.mean((y - p) ** 2)))
    if name == "binary_logloss":
        return lambda y, p: float(-np.mean(
            y * np.log(np.clip(p, 1e-15, 1)) +
            (1 - y) * np.log(np.clip(1 - p, 1e-15, 1))))
    if name == "binary_error":
        return lambda y, p: float(np.mean((p > 0.5).astype(int) != y))
    if name == "multi_logloss":
        def mll(y, p):
            p = np.asarray(p)
            pc = np.clip(p[np.arange(len(y)), y.astype(int)], 1e-15, 1.0)
            return float(-np.mean(np.log(pc)))
        return mll
    if name == "multi_error":
        return lambda y, p: float(np.mean(np.asarray(p).argmax(1)
                                          != y.astype(int)))
    if name == "quantile":
        # the alpha used in training is not visible here; default 0.9
        def pinball(y, p, alpha=0.9):
            d = y - p
            return float(np.mean(np.maximum(alpha * d, (alpha - 1) * d)))
        return pinball
    if name == "mape":
        # regression_metric.hpp:297 MAPEMetric
        return lambda y, p: float(np.mean(np.abs(y - p)
                                          / np.maximum(1.0, np.abs(y))))
    if name == "huber":
        # regression_metric.hpp:240 HuberLossMetric (config alpha default)
        def huber(y, p, alpha=0.9):
            d = np.abs(p - y)
            return float(np.mean(np.where(d <= alpha, 0.5 * d * d,
                                          alpha * (d - 0.5 * alpha))))
        return huber
    if name == "fair":
        # regression_metric.hpp:262 FairLossMetric
        def fair(y, p, c=1.0):
            x = np.abs(p - y)
            return float(np.mean(c * x - c * c * np.log1p(x / c)))
        return fair
    if name == "poisson":
        # regression_metric.hpp:279 PoissonMetric (p on the response scale)
        def pois(y, p):
            p = np.maximum(p, 1e-10)
            return float(np.mean(p - y * np.log(p)))
        return pois
    if name == "gamma":
        # regression_metric.hpp:306 GammaMetric (unit shape)
        def gamma_nll(y, p):
            p = np.maximum(p, 1e-35)
            return float(np.mean(y / p + np.log(p)))
        return gamma_nll
    if name == "gamma_deviance":
        # regression_metric.hpp:329 GammaDevianceMetric (AverageLoss x2)
        def gamma_dev(y, p):
            t = y / (p + 1e-9)
            return float(2.0 * np.sum(t - np.log(np.maximum(t, 1e-35)) - 1))
        return gamma_dev
    if name == "tweedie":
        # regression_metric.hpp:350 TweedieMetric
        def tweedie(y, p, rho=1.5):
            p = np.maximum(p, 1e-10)
            return float(np.mean(-y * p ** (1.0 - rho) / (1.0 - rho)
                                 + p ** (2.0 - rho) / (2.0 - rho)))
        return tweedie
    if name == "cross_entropy":
        return lambda y, p: float(-np.mean(
            y * np.log(np.clip(p, 1e-15, 1))
            + (1 - y) * np.log(np.clip(1 - p, 1e-15, 1))))
    if name == "auc":
        def auc(y, p):
            order = np.argsort(p)
            ranks = np.empty(len(p))
            ranks[order] = np.arange(1, len(p) + 1)
            n1 = y.sum()
            n0 = len(y) - n1
            return float((ranks[y == 1].sum() - n1 * (n1 + 1) / 2) / (n0 * n1))
        return auc
    raise ValueError(f"unknown metric '{name}'")


def _default_metric(gp_model, params):
    if gp_model is not None and gp_model.likelihood != "gaussian":
        return "binary_logloss" if "bernoulli" in gp_model.likelihood else "rmse"
    obj = (params or {}).get("objective", "regression")
    return "binary_logloss" if obj in ("binary", "bernoulli_logit") else "l2"


def _make_folds(y, nfold, folds, seed, stratified):
    """Row-index folds (the test rows of each); stratified folds keep each
    class's share (engine.py:575 cv stratified=True)."""
    n = len(y)
    if folds is not None:
        out = []
        for f in folds:
            # (train_idx, test_idx) tuples as the reference takes them;
            # bare index arrays are test indices
            if isinstance(f, (tuple, list)) and len(f) == 2 \
                    and np.ndim(f[0]) == 1 and np.ndim(f[1]) == 1 \
                    and not np.isscalar(f[0]):
                out.append(np.asarray(f[1], dtype=int))
            else:
                out.append(np.asarray(f, dtype=int))
        return out
    rng = np.random.RandomState(seed)
    if stratified:
        out = [[] for _ in range(nfold)]
        for cls in np.unique(y):
            idx = np.where(y == cls)[0]
            idx = rng.permutation(idx)
            for i in range(nfold):
                out[i].extend(idx[i::nfold])
        return [np.sort(np.asarray(f, dtype=int)) for f in out]
    perm = rng.permutation(n)
    return [perm[i::nfold] for i in range(nfold)]


def _clone_gp_model(gp_model, idx):
    """The GPModel rebuilt on a row subset, with what the port's model
    holds: grouping data and random slopes, coordinates and GP random
    coefficients, cluster ids, weights, the likelihood and its parameter,
    the Vecchia settings, the matrix inversion method, the float type and
    device, and the optimizer parameters that differ from their defaults
    (init_cov_pars left to the clone)."""
    if gp_model is None:
        return None
    from .models.optimize import OptimConfig
    kw = dict(likelihood=gp_model.likelihood,
              cov_function=gp_model.cov_function_name,
              cov_fct_shape=gp_model.cov_fct_shape,
              gp_approx=gp_model.gp_approx,
              num_neighbors=gp_model.num_neighbors,
              vecchia_ordering=gp_model.vecchia_ordering,
              seed=gp_model.seed,
              matrix_inversion_method=gp_model.matrix_inversion_method,
              likelihood_additional_param=gp_model.likelihood_additional_param,
              dtype=gp_model._dtype, device=gp_model.device)
    if gp_model.group_data is not None:
        kw["group_data"] = gp_model.group_data[idx]
    if gp_model.group_rand_coef_data is not None:
        kw["group_rand_coef_data"] = gp_model.group_rand_coef_data[idx]
        kw["ind_effect_group_rand_coef"] = (
            np.asarray(gp_model.ind_effect_group_rand_coef) + 1)
    if gp_model.gp_coords is not None:
        kw["gp_coords"] = gp_model.gp_coords[idx]
    if gp_model.gp_rand_coef_data is not None:
        kw["gp_rand_coef_data"] = gp_model.gp_rand_coef_data[idx]
    if gp_model.cluster_ids is not None:
        kw["cluster_ids"] = gp_model.cluster_ids[idx]
    if gp_model.weights is not None:
        kw["weights"] = gp_model.weights[idx]
    m = GPModel(**kw)
    defaults = OptimConfig()
    keep = {}
    for k, v in gp_model.params.__dict__.items():
        if k == "init_cov_pars":
            continue    # data-dependent: the clone derives its own
        if v is not None and not np.all(
                np.asarray(v) == np.asarray(getattr(defaults, k, None))):
            keep[k] = v
    m.set_optim_params(keep)
    return m


class CVBooster:
    """The fold boosters of cv(return_cvbooster=True) (engine.py
    CVBooster)."""

    def __init__(self, boosters):
        self.boosters = boosters
        self.best_iteration = -1

    def predict(self, data, **kwargs):
        return [b.predict(data, **kwargs) for b in self.boosters]


class _FoldData:
    """What feval sees of a fold's held-out rows: .data and get_label()."""

    def __init__(self, X, y):
        self.data = X
        self._y = y

    def get_label(self):
        return self._y


def cv(params=None, train_set=None, num_boost_round=100, gp_model=None,
       use_gp_model_for_validation=True, folds=None, nfold=5, stratified=False,
       shuffle=True, metrics=None, seed=0, early_stopping_rounds=None,
       eval_train_metric=False, return_cvbooster=False, verbose_eval=False,
       fit_GP_cov_pars_OOS=False, device=None, **kwargs):
    """K-fold cross-validation of (GP)boosting (engine.py:575).

    All folds advance one round at a time; with early_stopping_rounds the
    loop stops when the mean metric over the folds has not improved for
    that many rounds (auc maximizes; a callable `eval` sets its direction
    with its first value). Returns {"<metric>-mean": [...],
    "<metric>-stdv": [...], "best_iter": int}, with "train <metric>-..."
    under eval_train_metric and {"cvbooster": CVBooster} under
    return_cvbooster. device: where the fold boosters run (default: the GP
    model's device, else the first CUDA card)."""
    params = dict(params or {})
    X = train_set.data
    y = train_set.get_label()
    n = len(y)
    fold_idx = _make_folds(y, nfold, folds, seed, stratified)
    feval = kwargs.get("eval") if callable(kwargs.get("eval")) else None
    metric = metrics if isinstance(metrics, str) else (
        metrics[0] if metrics else _default_metric(gp_model, params))
    if params.get("metric") and metrics is None:
        metric = params["metric"] if isinstance(params["metric"], str) \
            else params["metric"][0]
    canon = _METRIC_ALIASES.get(metric, metric)
    if canon in _GP_TRAIN_METRICS:
        raise ValueError(f"metric '{metric}' is a training-data metric and "
                         "cannot be used for cross-validation")
    use_var_metric = canon in _VAR_METRICS
    mfn = None
    if feval is None and not use_var_metric:
        mfn = _metric_fn(metric)
    maximize = metric_higher_better(metric)

    folds_state = []
    for test_idx in fold_idx:
        test_mask = np.zeros(n, dtype=bool)
        test_mask[test_idx] = True
        tr = ~test_mask
        ds_tr = Dataset(X[tr], label=y[tr], max_bin=train_set.max_bin,
                        categorical_feature=train_set.categorical_feature
                        or None)
        bst = Booster(params=params, train_set=ds_tr,
                      gp_model=_clone_gp_model(gp_model, tr), device=device)
        pred_kw = {}
        if gp_model is not None and use_gp_model_for_validation:
            if gp_model.group_data is not None:
                pred_kw["group_data_pred"] = gp_model.group_data[test_mask]
            if gp_model.group_rand_coef_data is not None:
                pred_kw["group_rand_coef_data_pred"] = \
                    gp_model.group_rand_coef_data[test_mask]
            if gp_model.gp_coords is not None:
                pred_kw["gp_coords_pred"] = gp_model.gp_coords[test_mask]
            if gp_model.gp_rand_coef_data is not None:
                pred_kw["gp_rand_coef_data_pred"] = \
                    gp_model.gp_rand_coef_data[test_mask]
            if gp_model.cluster_ids is not None:
                pred_kw["cluster_ids_pred"] = gp_model.cluster_ids[test_mask]
        score = _RunningScore(bst, X[test_mask])
        score_tr = _RunningScore(bst, X[tr]) if eval_train_metric else None
        folds_state.append((bst, test_mask, tr, pred_kw, score, score_tr))

    def _score_fold(bst, yv, score, pred_kw):
        if use_var_metric:
            F_raw = score.advance(bst)
            if pred_kw and bst.gp_model is not None:
                if bst.gp_model.likelihood == "gaussian":
                    pred = bst._predict_output(F_raw, predict_var=True,
                                               **pred_kw)
                    return _var_metric_fn(canon)(yv, pred["response_mean"],
                                                 pred["response_var"])
                pred = bst._predict_output(F_raw, pred_latent=True,
                                           predict_var=True, **pred_kw)
                lik = bst.gp_model._likelihood_obj
                return lik.test_neg_log_likelihood(
                    yv, np.asarray(pred["fixed_effect"]
                                   + pred["random_effect_mean"]),
                    np.asarray(pred["random_effect_var"]),
                    bst.gp_model._fit_result.aux_pars)
            return _var_metric_fn(canon)(yv, F_raw, bst._train_resid_var())
        if feval is not None:
            p = bst._point_prediction(score.advance(bst), **pred_kw)
            return feval(np.asarray(p), _FoldData(score.X, yv))[1]
        return mfn(yv, bst._point_prediction(score.advance(bst), **pred_kw))

    per_iter = []
    per_iter_train = []
    best_mean = -np.inf if maximize else np.inf
    best_it = 0
    rounds_no_improve = 0
    feval_dir_known = feval is None
    for it in range(num_boost_round):
        scores = []
        scores_train = []
        for bst, test_mask, tr, pred_kw, score, score_tr in folds_state:
            bst.update()
            if not feval_dir_known:
                p = bst._point_prediction(score.advance(bst), **pred_kw)
                _, val, hib = feval(np.asarray(p), _FoldData(X[test_mask],
                                                             y[test_mask]))
                maximize = bool(hib)
                best_mean = -np.inf if maximize else np.inf
                feval_dir_known = True
                scores.append(val)
            else:
                scores.append(_score_fold(bst, y[test_mask], score, pred_kw))
            if eval_train_metric:
                scores_train.append(_score_fold(bst, y[tr], score_tr, {}))
        per_iter.append(scores)
        if eval_train_metric:
            per_iter_train.append(scores_train)
        mean_score = float(np.mean(scores))
        improved = (mean_score > best_mean) if maximize \
            else (mean_score < best_mean)
        if improved:
            best_mean = mean_score
            best_it = it
            rounds_no_improve = 0
        else:
            rounds_no_improve += 1
        if early_stopping_rounds and rounds_no_improve >= early_stopping_rounds:
            break

    per_iter = np.asarray(per_iter)                     # (iters, folds)
    out = {f"{metric}-mean": list(per_iter.mean(axis=1)),
           f"{metric}-stdv": list(per_iter.std(axis=1))}
    if eval_train_metric:
        pt = np.asarray(per_iter_train)
        out[f"train {metric}-mean"] = list(pt.mean(axis=1))
        out[f"train {metric}-stdv"] = list(pt.std(axis=1))
    out["best_iter"] = best_it + 1
    if return_cvbooster:
        cvb = CVBooster([fs[0] for fs in folds_state])
        cvb.best_iteration = best_it + 1
        out["cvbooster"] = cvb
    return out


def grid_search_tune_parameters(param_grid, params=None, num_try_random=None,
                                folds=None, nfold=5, gp_model=None,
                                use_gp_model_for_validation=True,
                                train_set=None, num_boost_round=100,
                                early_stopping_rounds=None, seed=0,
                                metrics=None, verbose_eval=1, device=None,
                                **kwargs):
    """Grid or random search over boosting parameters by `cv`
    (engine.py:906). Returns {"best_params", "best_iter", "best_score"}.
    device is passed on to `cv`."""
    keys = list(param_grid)
    combos = list(itertools.product(*[param_grid[k] for k in keys]))
    rng = np.random.RandomState(seed)
    if num_try_random is not None and num_try_random < len(combos):
        sel = rng.choice(len(combos), num_try_random, replace=False)
        combos = [combos[i] for i in sel]
    metric = metrics if isinstance(metrics, str) else (
        metrics[0] if metrics else _default_metric(gp_model, params))
    maximize = metric_higher_better(metric)
    best = {"best_score": -np.inf if maximize else np.inf,
            "best_params": None, "best_iter": None}
    for combo in combos:
        trial = dict(params or {})
        trial.update(dict(zip(keys, combo)))
        res = cv(params=trial, train_set=train_set,
                 num_boost_round=num_boost_round, gp_model=gp_model,
                 use_gp_model_for_validation=use_gp_model_for_validation,
                 folds=folds, nfold=nfold, metrics=metric, seed=seed,
                 early_stopping_rounds=early_stopping_rounds, device=device)
        scores = res[f"{metric}-mean"]
        sc = float(np.max(scores) if maximize else np.min(scores))
        better = (sc > best["best_score"]) if maximize \
            else (sc < best["best_score"])
        if better:
            it = int(np.argmax(scores) if maximize else np.argmin(scores)) + 1
            best = {"best_score": sc,
                    "best_params": dict(zip(keys, combo)),
                    "best_iter": it}
    return best
