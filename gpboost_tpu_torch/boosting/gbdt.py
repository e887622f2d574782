"""Booster for tree boosting alone (the LightGBM objectives), or combined
with a Gaussian GP model (the GPBoost algorithm) or a non-Gaussian one
(LaGaBoost); counterpart of gpboost_tpu/boosting/gbdt.py, host-loop path.

One boosting round (gbdt.cpp:412 TrainOneIter with the GP hooks):

  1. gradients at the current score F: without a GP model those of the
     objective (gbdt.py:954-1109): the L2, quantile, L1, Huber, Fair, MAPE,
     Tweedie, cross-entropy and LightGBM-binary formulas, or -d1 and -d2
     of a likelihood of likelihoods/base.py (binary, poisson, gamma, ...),
     on the device, times the Dataset weights if it has them; with a
     Gaussian GP model, those of the marginal NLL, grad = Psi~^-1 (F - y) /
     sigma2 through the GP model's engine (dense, Woodbury or Vecchia);
     with a non-Gaussian one, the gradient in F of the Laplace-approximated
     NLL at the current mode (gbdt.py:1127-1139), in data order for every
     engine (grouped, dense or Vecchia-Laplace); hess = 1;
  2. the bagging and feature-fraction draws (gbdt.py:1230-1256, the same
     numpy RandomState draws), then one leaf-wise tree on the in-bag rows
     and the drawn features (tree_learner.py, histogram kernels); for l1,
     quantile and mape the leaf values are renewed to the residual
     percentiles of their in-bag rows (RenewTreeOutput); with a Gaussian GP
     model and leaves_newton_update the leaf values are re-solved by GLS,
     with line_search_step_length the tree is scaled by the 1-D GLS
     optimum;
  3. F += learning_rate * tree output, for every row, in the bag or not;
  4. with a GP model, the covariance parameters are refitted on the new
     residuals (Gaussian) or at the new F (non-Gaussian): a full fit with
     the GP model's optimizer settings in the first round, warm-started
     Nesterov GD after.

With use_nesterov_acc (gbdt.cpp:421 ApplyMomentumStep,
nesterov_boosting.h:19) each round starts with a momentum step on the
score, F <- (1 + mu) F - mu F_prev with mu from `_nesterov_schedule`, and
with a GP model a refit on the post-momentum residuals: two refits a round.
`predict` replays the recursion over the trees (gbdt_prediction.cpp:22-34).

The objective of LaGaBoost is the GP model's likelihood, whatever the
`objective` parameter says (gbdt.py:647); its init score is the
intercept-only Laplace fit at the initial covariance parameters
(gbdt.py:857-887, FindInitialValueBoosting). A likelihood with two
predictor sets (the regression zero models, gaussian_heteroscedastic;
gbdt.py:733-740) grows two trees a round on the two halves of one
gradient, the first block's then the second's, interleaved in `trees`
(even ones the first block, odd ones the second, as `predict`,
`num_iteration` and the model dict's num_sets read them); its F stacks
both blocks, each with its own init score, and every round refits with a
full fit, as the reference does (no warm GD refit for two sets).

`train` takes validation sets, early stopping, callbacks and feval
(gbdt.py:2443-2656). Each validation set keeps a running raw score that
takes each new tree (`_RunningScore`, LightGBM's valid score updater), in
the order `predict` sums, so the metric recorded after k rounds is that of
`predict(num_iteration=k)` bit for bit; with a GP model and the set's
`gp_valid_data`, the random-effect part is predicted anew each round.

Gaussian-regression boosting can grow its trees over a torch.distributed
group (num_parallel_devices = the group's size, tree_learner data, feature
or voting); each rank then keeps the score of the rows its learner holds.

The booster's modes (gbdt.py:1258-1475, ranking.py): boosting="dart"
drops trees with the reference's draws from drop_seed before the
gradients (their contributions are their current leaf values at the leaf
slots each tree routed the rows to, kept on the device as int32) and
renormalises them by k / (k + 1) after the new tree of weight lr / (k +
1); "goss" keeps the top_rate rows by |grad hess| and an other_rate
sample of the rest, amplified by (1 - a) / b, after int(1 / lr) warm-up
rounds (the rows sorted on the device, the sample's positions from
bagging_seed's RandomState); "rf" grows every tree on the gradients at
the init score over a fresh bag, unshrunk, and averages them (it needs
bagging and no GP model). DART and GOSS run with a GP model too.
linear_tree fits each leaf's ridge regression on its path's numeric
features on the device (`_fit_linear_leaves`). Multi-output objectives
grow one tree a block and round: multiclass (K blocks, softmax
gradients, init scores the log class priors, (n, K) probabilities) and
mean_scale_regression (the mean and the log variance, {"pred_mean",
"pred_var"}); tobit is Grabit's censored Gaussian (sigma, yl, yu);
lambdarank and rank_xendcg take a Dataset group and compute their
per-query gradients on the device (`ranking.QueryLayout`), with ndcg and
map for validation sets at eval_at's first k. `refit` refits the leaf
values of the trees on new data with refit_decay_rate. The modes run on
the single-device learner only.

The training score F and the labels live on the booster's device in
float64; the trees are host numpy objects (tree.py), as in the reference.
The reference's `_psi_tilde_inv_mat` (gbdt.py:2395) is each engine's
`psi_tilde_inv_mat` here, on the device.
The reference's fused multi-round `lax.scan` paths wait (ROADMAP A13):
`train` always runs the host loop. Every parameter of the reference's
defaults (gbdt.py:448-521) and aliases (:523-539) is read or checked.
What the reference refuses raises as there (a random forest without
bagging or with a GP model, multiclass or a two-predictor likelihood with
another boosting type than gbdt, ranking without query information,
refit with a GP model or several predictor blocks); the options outside
the port raise NotImplementedError naming the ROADMAP item that ports
them: init_model (A14); a GP model, a non-Gaussian objective, sampling,
DART, GOSS, random forests, linear trees or the split options below on a
parallel tree learner (A15). boost_from_average=False starts plain
boosting from score 0.

The tree learner's split breadth passes through (gbdt.py:560-644):
categorical features, missing values (use_missing, zero_as_missing), EFB
bundles (the Dataset's enable_bundle), monotone_constraints,
interaction_constraints, forcedsplits_filename, the CEGB penalties,
path_smooth and extra_trees (extra_seed + 131 * trees so far seeds a
tree's thresholds). `predict` re-encodes rows into the learner's bins for
EFB, and gives pred_leaf (leaf indices) and pred_contrib (TreeSHAP); the
model dict carries the EFB encoder and the pandas categories.
"""

import numpy as np
import torch

from .ranking import (DEFAULT_LABEL_GAIN, QueryLayout, check_rank_labels,
                      map_metric, ndcg_metric, query_boundaries)
from .tree import Tree
from .tree_learner import SerialTreeLearner, _to_device
from ..likelihoods.base import get_likelihood
from ..models.jit_gd import gd_fit_engine, gd_fit_laplace_engine
from ..parallel.group import default_group
from ..utils.device import resolve_device

_OBJ_ALIASES = {
    "regression": "gaussian", "regression_l2": "gaussian", "l2": "gaussian",
    "mean_squared_error": "gaussian", "mse": "gaussian",
    "gaussian": "gaussian",
    "binary": "bernoulli_logit", "binary_logloss": "bernoulli_logit",
    "poisson": "poisson", "gamma": "gamma",
    "multiclass": "multiclass", "softmax": "multiclass",
    "quantile": "quantile",
    "regression_l1": "l1", "l1": "l1", "mae": "l1",
    "mean_absolute_error": "l1",
    "huber": "huber", "fair": "fair",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "tweedie": "tweedie",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "tobit": "tobit", "grabit": "tobit",
    "mean_scale_regression": "mean_scale_regression",
    "lambdarank": "lambdarank", "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
}
# objectives with their own gradient formulas instead of the likelihood
# registry (regression_objective.hpp, binary_objective.hpp,
# xentropy_objective.hpp, multiclass_objective.hpp, rank_objective.hpp)
_SPECIAL_OBJECTIVES = ("multiclass", "quantile", "cross_entropy", "tobit",
                       "mean_scale_regression", "lambdarank", "rank_xendcg",
                       "l1", "huber", "fair", "mape", "tweedie", "binary_lgb",
                       "cross_entropy_lambda")
_RANK_OBJECTIVES = ("lambdarank", "rank_xendcg")
_BINARY_OBJECTIVES = ("bernoulli_logit", "bernoulli_probit", "cross_entropy",
                      "binary_lgb")
# boosting types (gbdt.py:795-797); random_forest is rf's alias
_BOOSTING_TYPES = ("gbdt", "gbrt", "dart", "goss", "rf", "random_forest")

# the reference's defaults (gbdt.py:448-521): every parameter the port
# reads or checks
_BOOST_PARAM_DEFAULTS = dict(
    learning_rate=0.1, num_leaves=31, max_depth=-1, min_data_in_leaf=20,
    lambda_l2=0.0, lambda_l1=0.0, min_sum_hessian_in_leaf=1e-3,
    min_gain_to_split=0.0, objective="regression",
    train_gp_model_cov_pars=True, use_gp_model_for_validation=True,
    maxit_gp=10, reuse_learning_rates_gp_model=True, verbose=1, max_bin=255,
    boosting="gbdt", leaves_newton_update=False,
    line_search_step_length=False, use_nesterov_acc=False,
    nesterov_acc_rate=0.5, momentum_offset=0, momentum_schedule_version=1,
    boost_from_average=True,
    # the objectives' settings (config.h alpha, sigmoid, is_unbalance,
    # scale_pos_weight, fair_c, tweedie_variance_power)
    alpha=0.9, sigmoid=1.0, is_unbalance=False, scale_pos_weight=1.0,
    fair_c=1.0, tweedie_variance_power=1.5,
    # bagging and feature subsampling with their seeds
    bagging_fraction=1.0, bagging_freq=0, feature_fraction=1.0,
    bagging_seed=3, feature_fraction_seed=2,
    path_smooth=0.0, extra_trees=False, linear_tree=False,
    monotone_constraints=None, interaction_constraints=None,
    forcedsplits_filename="", cegb_penalty_split=0.0,
    cegb_penalty_feature_coupled=None, cegb_penalty_feature_lazy=None,
    num_parallel_devices=None, tree_learner="serial", top_k=20,
    # the categorical search (config.h cat_smooth, cat_l2,
    # max_cat_threshold, min_data_per_group), CEGB's tradeoff, the
    # extra-trees seed and the missing-value handling
    cat_smooth=10.0, cat_l2=10.0, max_cat_threshold=32,
    min_data_per_group=100, cegb_tradeoff=1.0, extra_seed=6,
    use_missing=True, zero_as_missing=False,
    # DART (dart.hpp), GOSS (goss.hpp), multiclass, ranking
    # (rank_objective.hpp) and refit's leaf decay
    drop_rate=0.1, max_drop=50, skip_drop=0.5, drop_seed=4, top_rate=0.2,
    other_rate=0.1, num_class=1, lambdarank_norm=True,
    lambdarank_truncation_level=30, refit_decay_rate=0.9,
    label_gain=None, objective_seed=5, eval_at=(1, 2, 3, 4, 5),
)
# tree_learner values and their aliases -> the learner's parallel_mode
# (gbdt.py:590-596)
_TREE_LEARNERS = {
    "serial": "data", "data": "data", "data_parallel": "data",
    "feature": "feature", "feature_parallel": "feature",
    "voting": "voting", "voting_parallel": "voting",
}

_PARAM_ALIASES = {
    "shrinkage_rate": "learning_rate", "eta": "learning_rate",
    "num_leaf": "num_leaves", "min_data": "min_data_in_leaf",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "lambda": "lambda_l2", "reg_lambda": "lambda_l2",
    "reg_alpha": "lambda_l1", "l1_regularization": "lambda_l1",
    "min_split_gain": "min_gain_to_split",
    "num_iterations": "num_boost_round", "num_trees": "num_boost_round",
    "n_estimators": "num_boost_round", "num_round": "num_boost_round",
    "boosting_type": "boosting", "boost": "boosting",
    "monotone_constraint": "monotone_constraints",
    "sub_row": "bagging_fraction", "subsample": "bagging_fraction",
    "bagging": "bagging_fraction", "subsample_freq": "bagging_freq",
    "sub_feature": "feature_fraction", "colsample_bytree": "feature_fraction",
    "unbalance": "is_unbalance", "unbalanced_sets": "is_unbalance",
}


def _nesterov_schedule(i, version=1, rate=0.5, offset=0):
    """Momentum rate at boosting iteration i (gbdt.h:399
    NesterovSchedule)."""
    if i < offset:
        return 0.0
    if version == 0:
        return float(rate)
    if version == 1:
        return 1.0 - 3.0 / (6.0 + i)
    return 0.0


def _weighted_percentile(v, w, alpha):
    """Common::Percentile / WeightedPercentileFun (utils/common.h:919-985):
    percentile of v; the weighted variant accumulates sorted weights to the
    alpha cut (gbdt.py:51-62)."""
    v = np.asarray(v, dtype=np.float64)
    if w is None:
        return float(np.percentile(v, alpha * 100.0))
    w = np.asarray(w, dtype=np.float64)
    o = np.argsort(v)
    cw = np.cumsum(w[o])
    i = int(np.searchsorted(cw, alpha * cw[-1]))
    return float(v[o[min(i, len(v) - 1)]])


def _segment_percentiles(v, key, counts, w, alpha):
    """`_weighted_percentile` of v over each segment of rows with the same
    key, on the device, with no per-segment host work: one sort keyed by
    (key, v), then per segment np.percentile's linear interpolation
    (unweighted) or the first sorted row whose cumulative weight reaches
    alpha times the segment's total (weighted). counts: host numpy, rows
    per key. The cumulative weights are summed row by row within each
    segment, as np.cumsum does, over a (segments, longest) zero-padded
    matrix. The per-segment host values go up in one copy. Returns (k,)
    values for the keys with rows, in key order."""
    dev = v.device
    o1 = torch.sort(v, stable=True).indices
    order = o1[torch.sort(key[o1], stable=True).indices]
    vs = v[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    keys = np.flatnonzero(counts > 0)
    c = counts[keys].astype(np.int64)
    if w is None:
        # np.percentile, method "linear" (function_base _quantile): the
        # virtual index (c - 1) q, its floor and ceiling, and _lerp, whose
        # form flips at t = 0.5
        q = (alpha * 100.0) / 100.0
        virt = (c - 1).astype(np.float64) * q
        prev = np.floor(virt)
        top = virt >= c - 1
        lo = np.where(top, c - 1, prev.astype(np.int64))
        hi = np.where(top, c - 1, lo + 1)
        t = np.where(top, 0.0, virt - prev)
        up = torch.as_tensor(np.stack([starts[keys] + lo, starts[keys] + hi,
                                       t, 1.0 - t]), device=dev)
        a, b = vs[up[0].long()], vs[up[1].long()]
        diff = b - a
        return torch.where(up[2] >= 0.5, b - diff * up[3], a + diff * up[2])
    m = int(c.sum())
    up = torch.as_tensor(np.concatenate([starts, starts[keys], keys, c - 1]),
                         device=dev)
    nk = len(keys)
    starts_d, kstart, keys_d, last = (up[:len(starts)],
                                      up[len(starts):len(starts) + nk],
                                      up[len(starts) + nk:-nk], up[-nk:])
    ks = key[order][:m]
    pos = torch.arange(m, device=dev) - starts_d[ks]
    W = torch.zeros((len(counts), int(c.max())), dtype=torch.float64,
                    device=dev)
    W[ks, pos] = w[order][:m]
    cw = torch.cumsum(W, dim=1)[keys_d]
    i = torch.searchsorted(cw, (alpha * cw[:, -1])[:, None])[:, 0]
    return vs[kstart + torch.minimum(i, last)]


def _parse_params(raw):
    """The booster's parameters, with the reference's aliases and its
    checks of the boosting type (gbdt.py:795-799)."""
    p = dict(_BOOST_PARAM_DEFAULTS)
    for k, v in (raw or {}).items():
        p[_PARAM_ALIASES.get(k, k)] = v
    if p["boosting"] not in _BOOSTING_TYPES:
        raise ValueError(f"unknown boosting type {p['boosting']!r}")
    if p["boosting"] == "random_forest":
        p["boosting"] = "rf"
    if p["use_nesterov_acc"] and p["boosting"] != "gbdt":
        raise ValueError("use_nesterov_acc requires boosting='gbdt'")
    if str(p["tree_learner"]) not in _TREE_LEARNERS:
        raise ValueError(f"Unknown tree_learner '{p['tree_learner']}'")
    return p


def _raw_X(data):
    X = np.asarray(data, dtype=np.float64)
    return X[:, None] if X.ndim == 1 else X


def _load_forced_splits(path):
    """forcedsplits_filename: the nested JSON of forced splits, or None."""
    if not path:
        return None
    import json
    with open(path) as f:
        return json.load(f)


def _parse_interaction_constraints(ic):
    """config.h interaction_constraints: LightGBM's string form
    "[0,1,2],[2,3]" or a list of index lists; a list of lists or None."""
    if ic is None or ic == "":
        return None
    if isinstance(ic, str):
        import json
        return json.loads(f"[{ic}]")
    return [list(s) for s in ic]


def _cegb_config(p, num_features):
    """The tradeoff-scaled CEGB penalties of the parameters
    (cost_effective_gradient_boosting.hpp; gbdt.py:597-621): a dict with
    'coupled' (p,), 'split' and 'lazy' (p,) or None, or None when CEGB is
    off."""
    coupled = p.get("cegb_penalty_feature_coupled")
    lazy = p.get("cegb_penalty_feature_lazy")
    if coupled is None and lazy is None \
            and float(p["cegb_penalty_split"]) <= 0.0:
        return None
    tr = float(p["cegb_tradeoff"])
    out = {"coupled": np.zeros(num_features), "lazy": None,
           "split": tr * float(p["cegb_penalty_split"])}
    for key, name in (("coupled", "cegb_penalty_feature_coupled"),
                      ("lazy", "cegb_penalty_feature_lazy")):
        v = p.get(name)
        if v is not None:
            v = np.asarray(v, dtype=np.float64)
            if len(v) != num_features:
                raise ValueError(f"{name} must have one entry per feature")
            out[key] = tr * v
    return out


class _RunningScore:
    """The raw ensemble score of one data set, advanced tree by tree as
    the booster grows (LightGBM's ScoreUpdater of a validation set), one
    score per predictor block (tree i adds to block i % nsets). Each new
    tree is added, with the Nesterov recursion replayed, by the float
    operations `Booster.predict` does, in its order (trees summed from 0, a
    random forest's sum divided by its trees, the init score added last),
    so the score after k rounds equals `predict(num_iteration=k,
    raw_score=True)` bit for bit (the blocks stacked). A DART round that
    rescaled grown trees makes the score start again from tree 0, as
    the reference's per-round predict does."""

    def __init__(self, booster, data):
        self.X = booster._prep_X(data)
        self._restart(booster)

    def _restart(self, booster):
        self.F = [np.zeros(len(self.X)) for _ in range(booster._nsets)]
        self.lag = None
        self.k = 0
        self.rescales = booster._rescales

    def advance(self, booster):
        """Take the trees grown since the last call; returns the raw score
        with the init score (the predictor blocks stacked for a
        multi-output model)."""
        if self.rescales != booster._rescales:
            self._restart(booster)
        K = len(self.F)
        while self.k < len(booster.trees):
            F, self.lag = booster._add_tree(self.F[self.k % K], self.lag,
                                            self.k, self.X)
            self.F[self.k % K] = F
            self.k += 1
        F = self.F
        if booster.params["boosting"] == "rf" and self.k:
            F = [s / self.k for s in F]
        return np.concatenate([s + c for s, c in zip(
            F, booster._block_inits())])


class Booster:
    """Tree-boosting model for the LightGBM objectives, alone or combined
    with a GPModel, and for a non-Gaussian GPModel's likelihood
    (basic.py:2315 Booster)."""

    def __init__(self, params=None, train_set=None, gp_model=None,
                 model_dict=None, device=None, init_model=None):
        if init_model is not None:
            raise NotImplementedError("init_model (continued training) is "
                                      "not ported yet (ROADMAP A14)")
        self.best_iteration = -1
        self.best_score = None
        if model_dict is not None:
            self._load(model_dict, device)
            return
        laplace = gp_model is not None and gp_model.likelihood != "gaussian"
        self.params = _parse_params(params)
        p = self.params
        if p["boosting"] == "rf":
            # rf.hpp Init (gbdt.py:798-807)
            if gp_model is not None:
                raise ValueError("boosting='rf' cannot be combined with a "
                                 "gp_model; use boosting='gbdt'")
            if not (int(p["bagging_freq"]) > 0
                    and 0.0 < float(p["bagging_fraction"]) < 1.0):
                raise ValueError(
                    "boosting='rf' requires bagging_freq > 0 and "
                    "0 < bagging_fraction < 1 (rf.hpp Init)")
        if gp_model is not None:
            if int(p["num_parallel_devices"] or 1) > 1:
                raise NotImplementedError("a GP model with a parallel tree "
                                          "learner is not ported yet "
                                          "(ROADMAP A15)")
            group = None
        else:
            group = default_group(p["num_parallel_devices"])
        if device is None and gp_model is not None:
            device = gp_model.device
        self.device = resolve_device(device)
        self.train_set = train_set
        self._pandas_categorical = getattr(train_set, "pandas_categorical",
                                           None)
        self.gp_model = gp_model
        raw = {_PARAM_ALIASES.get(k, k) for k in (params or {})}
        if not train_set._constructed and raw & {"use_missing",
                                                 "zero_as_missing"}:
            # the missing-value handling comes with the train parameters
            # when the Dataset was built without its own (config.h
            # use_missing; gbdt.py:564-569)
            train_set.use_missing = bool(p["use_missing"])
            train_set.zero_as_missing = bool(p["zero_as_missing"])
        train_set.construct()
        self.n = train_set.num_data
        y = train_set.get_label()
        if y is None:
            raise ValueError("train_set has no label")
        y = np.asarray(y, dtype=np.float64)
        w = train_set.weight
        self._lik = None
        self._aux = None
        self._binary_lw = None
        self._label_gain = None
        if laplace:
            self.objective_name = gp_model.likelihood
        else:
            self.objective_name = self._set_objective(y, w, gp_model,
                                                      train_set)
        if group is not None and (
                self.objective_name != "gaussian"
                or float(p["bagging_fraction"]) < 1.0
                and int(p["bagging_freq"]) > 0
                or float(p["feature_fraction"]) < 1.0
                or p["boosting"] != "gbdt" or p["linear_tree"]):
            raise NotImplementedError(
                "a non-Gaussian objective, bagging, feature_fraction, DART, "
                "GOSS, random forests or linear trees on a parallel tree "
                "learner are not ported yet (ROADMAP A15)")
        cegb = _cegb_config(p, train_set.num_features)
        self.learner = SerialTreeLearner(
            train_set, num_leaves=int(p["num_leaves"]),
            max_depth=int(p["max_depth"]),
            min_data_in_leaf=int(p["min_data_in_leaf"]),
            lambda_l2=float(p["lambda_l2"]), lambda_l1=float(p["lambda_l1"]),
            min_sum_hessian_in_leaf=float(p["min_sum_hessian_in_leaf"]),
            min_gain_to_split=float(p["min_gain_to_split"]),
            device=self.device,
            parallel_mode=_TREE_LEARNERS[str(p["tree_learner"])],
            top_k=int(p["top_k"]), group=group,
            monotone_constraints=p["monotone_constraints"],
            path_smooth=float(p["path_smooth"]), cegb=cegb,
            extra_trees=bool(p["extra_trees"]),
            forced_splits=_load_forced_splits(p["forcedsplits_filename"]),
            cat_params=(float(p["cat_smooth"]), float(p["cat_l2"]),
                        float(p["max_cat_threshold"]),
                        float(p["min_data_per_group"])),
            interaction_constraints=_parse_interaction_constraints(
                p["interaction_constraints"]))
        # CEGB's model-wide record of the features split on (coupled
        # penalty)
        self._cegb_used = None if cegb is None \
            else np.zeros(self.learner.p, dtype=np.float32)
        self.trees = []
        # multi-output boosting, one tree a block and round, interleaved in
        # self.trees (gbdt.py:721-742): multiclass (num_class blocks),
        # mean_scale_regression (mean and log variance) and a likelihood
        # with two predictor sets (num_sets_fixed_effects = 2,
        # c_api.cpp:132)
        self._nsets = 1
        self.init_score2 = 0.0
        self._init_scores = None
        if self.objective_name == "multiclass":
            self._nsets = int(p["num_class"])
            if p["boosting"] != "gbdt":
                raise ValueError("objective='multiclass' supports "
                                 "boosting='gbdt' only")
        elif self.objective_name == "mean_scale_regression":
            self._nsets = 2
        if laplace and getattr(gp_model._likelihood_obj, "num_sets_fe",
                               1) == 2:
            self._nsets = 2
            if p["boosting"] != "gbdt":
                raise ValueError("two-predictor likelihoods support "
                                 "boosting='gbdt' only")
        if self.objective_name == "multiclass":
            # boost from the log class priors (multiclass BoostFromScore)
            counts = np.bincount(y.astype(int), minlength=self._nsets)
            self._init_scores = np.log(np.maximum(counts, 1)
                                       / float(self.n))
            self.init_score = float(self._init_scores[0])
        elif self.objective_name == "mean_scale_regression":
            # BoostFromScore per block: the mean and the log variance
            # (regression_objective.hpp:1056-1095 MeanScaleLoss)
            self._init_scores = np.array([
                float(np.mean(y)), float(np.log(max(np.var(y), 1e-30)))])
            self.init_score = float(self._init_scores[0])
            self.init_score2 = float(self._init_scores[1])
        elif laplace:
            # the intercept-only Laplace fit, one intercept per predictor
            # set, from the closed-form intercepts (FindInitialValueBoosting,
            # re_model.cpp:634-690)
            lik = gp_model._likelihood_obj
            tv = self._gp_total_re_var(y)
            c0 = [lik.init_intercept(y, tv)]
            if self._nsets == 2:
                c0.append(float(lik.init_intercept2(y, tv))
                          if hasattr(lik, "init_intercept2") else 0.0)
            c = self._find_init_score_gp(y, c0)
            self.init_score = c[0]
            if self._nsets == 2:
                self.init_score2 = c[1]
        else:
            self.init_score = self._boost_from_average(y, w)
        # the score and labels of the rows this rank's learner holds
        self.y = torch.as_tensor(y[self.learner.rows], device=self.device)
        self.F = torch.cat([
            torch.full((self.learner.n,), c, dtype=torch.float64,
                       device=self.device) for c in self._block_inits()])
        # Dataset weights scale grad and hess without a GP model
        # (gbdt.py:1107-1108); with one the reference ignores them
        self._w = None if w is None or gp_model is not None \
            else torch.as_tensor(w[self.learner.rows], device=self.device)
        if self._lik is not None:
            self._aux = torch.as_tensor(self._lik.init_aux(y),
                                        device=self.device)
        self._onehot = self._rank = None
        if self.objective_name == "multiclass":
            onehot = np.zeros((self._nsets, self.n))
            onehot[y.astype(int), np.arange(self.n)] = 1.0
            self._onehot = torch.as_tensor(onehot, device=self.device)
        elif self.objective_name in _RANK_OBJECTIVES:
            self._rank = QueryLayout(
                query_boundaries(train_set.group), y, self.device,
                self._label_gain, int(p["lambdarank_truncation_level"]),
                int(p["objective_seed"])
                if self.objective_name == "rank_xendcg" else None)
        self._gp_init_pars = None
        self._gp_lr = 0.1
        self._gp_refit_iter = -1
        self._F_lag1 = None
        self.current_iteration_ = 0
        self._bag_rng = np.random.RandomState(int(p["bagging_seed"]))
        self._feat_rng = np.random.RandomState(int(p["feature_fraction_seed"]))
        self._row_mask = None
        # DART's draws, each tree's leaf slot of every row (the rows'
        # routes for a later drop) and the count of rounds that rescaled
        # grown trees, random forests' fixed gradients and tree sum, linear
        # leaves' raw features on the device
        self._drop_rng = np.random.RandomState(int(p["drop_seed"]))
        self._tree_slots = []
        self._rescales = 0
        self._rf_grad = None
        self._rf_sum = 0.0
        self._X_lin = None

    def _block_inits(self):
        """The init score of each predictor block."""
        if self._nsets == 1:
            return [self.init_score]
        if self._init_scores is not None:
            return [float(c) for c in self._init_scores]
        return [self.init_score, self.init_score2]

    # ------------------------------------------------------------------
    def _set_objective(self, y, w, gp_model, train_set):
        """The objective without a non-Gaussian GP model, with its label
        checks and state (gbdt.py:646-718): the binary label weights of
        binary_lgb, multiclass' class count, the ranking objectives' query
        information and label gains, the likelihood of a registry
        objective."""
        p = self.params
        obj = p["objective"]
        name = _OBJ_ALIASES.get(obj, obj)
        if gp_model is not None:
            if name != "gaussian":
                raise NotImplementedError(
                    f"objective '{obj}' with a Gaussian GP model: the GP "
                    "model's likelihood sets the objective")
            return name
        if name == "bernoulli_logit" and (
                float(p["sigmoid"]) != 1.0 or bool(p["is_unbalance"])
                or float(p["scale_pos_weight"]) != 1.0):
            # LightGBM's binary loss with sigmoid scaling or class weights
            # (binary_objective.hpp:27-33)
            name = "binary_lgb"
        if name == "cross_entropy":
            if not np.all((y >= 0) & (y <= 1)):
                raise ValueError("cross_entropy labels must be in [0, 1]")
        elif name == "binary_lgb":
            if not np.all((y == 0) | (y == 1)):
                raise ValueError("binary labels must be 0 or 1")
            npos = float(np.sum(y > 0))
            nneg = float(len(y)) - npos
            w0 = w1 = 1.0
            if bool(p["is_unbalance"]):
                if float(p["scale_pos_weight"]) != 1.0:
                    raise ValueError("Cannot set is_unbalance and "
                                     "scale_pos_weight at the same time")
                if npos > 0 and nneg > 0:
                    if npos > nneg:
                        w0 = npos / nneg
                    else:
                        w1 = nneg / npos
            w1 *= float(p["scale_pos_weight"])
            self._binary_lw = (w0, w1)
        elif name == "cross_entropy_lambda":
            if not np.all((y >= 0) & (y <= 1)):
                raise ValueError("cross_entropy_lambda labels must be in "
                                 "[0, 1]")
            if w is not None and np.any(np.asarray(w) <= 0):
                raise ValueError("cross_entropy_lambda requires positive "
                                 "weights")
        elif name == "multiclass":
            K = int(p["num_class"])
            if K < 2:
                raise ValueError("objective='multiclass' needs num_class >= 2")
            yv = y.astype(int)
            if not np.all((yv >= 0) & (yv < K)):
                raise ValueError(f"multiclass labels must be in [0, {K})")
        elif name in _RANK_OBJECTIVES:
            if train_set.group is None:
                raise ValueError("Ranking tasks require query information: "
                                 "Dataset(..., group=...)")
            if int(np.sum(train_set.group)) != len(y):
                raise ValueError("sum(group) must equal the number of data "
                                 "points")
            self._label_gain = DEFAULT_LABEL_GAIN \
                if p["label_gain"] is None \
                else np.asarray(p["label_gain"], dtype=np.float64)
            check_rank_labels(y, self._label_gain)
        elif name != "gaussian" and name not in _SPECIAL_OBJECTIVES:
            self._lik = get_likelihood(name)
            self._lik.check_y(y)
        return name

    def _boost_from_average(self, y, w):
        """BoostFromScore (regression_objective.hpp:239-283; gbdt.py:
        894-953): each objective's init score, 0 with
        boost_from_average=False without a GP model."""
        name = self.objective_name
        p = self.params
        if self.gp_model is not None:
            return float(np.mean(y))
        if not p["boost_from_average"]:
            return 0.0
        if name == "quantile":
            return _weighted_percentile(y, w, float(p["alpha"]))
        if name == "l1":
            return _weighted_percentile(y, w, 0.5)
        if name == "mape":
            # weighted median with label weights 1/max(1,|y|) (*w)
            # (regression_objective.hpp:744-751)
            lw = 1.0 / np.maximum(1.0, np.abs(y))
            return _weighted_percentile(y, lw if w is None else lw * w, 0.5)
        if name in ("huber", "fair"):
            return float(np.average(y, weights=w))
        if name == "tweedie":
            # RegressionPoissonLoss::BoostFromScore: SafeLog(weighted mean)
            return float(np.log(max(np.average(y, weights=w), 1e-35)))
        if name == "cross_entropy":
            pbar = float(np.clip(np.mean(y), 1e-12, 1 - 1e-12))
            return float(np.log(pbar / (1.0 - pbar)))
        if name == "binary_lgb":
            # binary_objective.hpp:140-160 (kEpsilon clip, /sigmoid)
            pavg = float(np.clip(np.average(y > 0, weights=w),
                                 1e-15, 1 - 1e-15))
            return float(np.log(pavg / (1.0 - pavg))
                         / float(p["sigmoid"]))
        if name == "cross_entropy_lambda":
            # xentropy_objective.hpp:244-265: log(exp(havg) - 1)
            havg = float(np.average(y, weights=w))
            return float(np.log(max(np.exp(havg) - 1.0, 1e-15)))
        if name in _RANK_OBJECTIVES:
            # ranking objectives do not boost from an average score
            # (rank_objective.hpp: BoostFromScore not overridden)
            return 0.0
        if self._lik is not None:
            return self._lik.init_intercept(y, 1.0)
        # Gaussian regression: the unweighted mean, as the reference
        return float(np.mean(y))

    def _gp_init_cov_pars(self, y):
        gp = self.gp_model
        init = gp.params.init_cov_pars
        if init is None:
            init = gp._default_init_cov_pars(y)
        return np.asarray(init, dtype=np.float64)

    def _gp_total_re_var(self, y):
        """Total variance of the random effects at the GP model's initial
        covariance parameters (GetTotalVarComps, re_model_template.h:1240):
        the rand_eff_var of the closed-form initial intercept."""
        pars = self._gp_init_cov_pars(y)
        tot = sum(float(pars[off]) for off in self.gp_model._engine.par_offsets)
        return max(tot, 1e-10)

    def _find_init_score_gp(self, y, c0):
        """The intercept-only ML fit of the Laplace marginal likelihood at
        the initial covariance and aux parameters (gbdt.py:857-887):
        L-BFGS-B over one intercept per predictor set (c0 their starting
        values), the mode warm-started."""
        from scipy.optimize import minimize
        from ..models.optimize import OptimConfig, _laplace_u0
        gp = self.gp_model
        eng = gp._engine
        cfg = OptimConfig(**{**gp.params.__dict__,
                             "init_cov_pars": self._gp_init_cov_pars(y)})
        u = _laplace_u0(eng, y, cfg)
        yd = eng.prep_y(gp._likelihood_obj.check_y(y))
        state = {"a": eng.zero_mode()}
        n, K = len(y), len(c0)

        def fun(c):
            nll, _, gF, a = eng.laplace_vag_F(
                u, yd, np.repeat(np.asarray(c, dtype=np.float64), n),
                state["a"])
            state["a"] = a
            if not np.isfinite(nll):
                return 1e30, np.zeros(K)
            return float(nll), np.asarray(gF).reshape(K, n).sum(1)

        r = minimize(fun, np.asarray(c0, dtype=np.float64), jac=True,
                     method="L-BFGS-B", options={"maxiter": 50})
        x = r.x if np.all(np.isfinite(r.x)) else np.asarray(c0)
        return [float(v) for v in x]

    def _gradients(self):
        """(grad, hess) at the current score F, as device tensors."""
        if self.gp_model is None:
            return self._objective_gradients()
        # covariance parameters are refitted after each tree (update());
        # here only when no fit for the current F exists yet
        if self._gp_refit_iter != self.current_iteration_:
            self._refit_gp_cov()
        gp = self.gp_model
        eng = gp._engine
        if gp._likelihood_obj is not None:
            # LaGaBoost: the gradient in F of the Laplace marginal NLL
            r = gp._fit_result
            u = eng._u_from_pars(r.cov_pars, r.aux_pars, gp.y)
            a = r.mode_state if r.mode_state is not None \
                else eng.zero_mode()
            _, _, gF, _ = eng.vag_F_device(u, self.y, self.F, a,
                                           value=False)
            return gF, torch.ones_like(gF)
        # grad = Sigma^-1 (F - y) = Psi~^-1 resid / sigma2 on the
        # nugget-scaled parameterization (re_model_template.h:9691)
        t = eng.transform_pars(gp._fit_result.cov_pars)
        resid = self.F - self.y
        grad = eng.psi_tilde_inv_mat(t, resid[:, None])[:, 0] / float(t[0])
        return grad, torch.ones_like(grad)

    def _objective_gradients(self):
        """The objective's (grad, hess) without a GP model (gbdt.py:
        959-1109) on the device, times the Dataset weights (inside the loss
        for cross_entropy_lambda, tiled over the blocks of multiclass and
        mean_scale_regression): elementwise formulas, multiclass' softmax
        over its K blocks, the ranking objectives' per-query gradients
        (`QueryLayout`)."""
        F, y, w = self.F, self.y, self._w
        name = self.objective_name
        p = self.params
        if name == "multiclass":
            # softmax gradients (multiclass_objective.hpp:87-108)
            K = self._nsets
            S = F.reshape(K, -1)
            S = S - S.max(0, keepdim=True).values
            P = torch.exp(S)
            P = P / P.sum(0, keepdim=True)
            g = (P - self._onehot).reshape(-1)
            h = torch.clamp_min(K / (K - 1.0) * P * (1.0 - P),
                                1e-12).reshape(-1)
            if w is not None:
                g, h = g * w.repeat(K), h * w.repeat(K)
            return g, h
        if name == "mean_scale_regression":
            # (regression_objective.hpp:1010-1034 MeanScaleLoss)
            m, sv = F.reshape(2, -1)
            inv_var = torch.exp(-sv)
            neg_resid = m - y
            h2 = inv_var * neg_resid ** 2 / 2.0
            g = torch.cat([inv_var * neg_resid, -h2 + 0.5])
            h = torch.clamp_min(torch.cat([inv_var, h2]), 1e-12)
            if w is not None:
                g, h = g * w.repeat(2), h * w.repeat(2)
            return g, h
        one = torch.ones_like(F)
        if name == "gaussian":
            if w is None:
                return F - y, one
            return (F - y) * w, w
        if name == "quantile":
            # pinball loss (regression_objective.hpp:601-616)
            a = float(p["alpha"])
            g = torch.where(F - y >= 0, _full(F, 1.0 - a), _full(F, -a))
            h = one
        elif name == "l1":
            # RegressionL1loss (regression_objective.hpp:300-330)
            g, h = torch.sign(F - y), one
        elif name == "huber":
            # RegressionHuberLoss (regression_objective.hpp:414-440)
            a = float(p["alpha"])
            g, h = torch.clamp(F - y, -a, a), one
        elif name == "fair":
            # RegressionFairLoss (regression_objective.hpp:466-482)
            c = float(p["fair_c"])
            d = F - y
            g = c * d / (torch.abs(d) + c)
            h = c * c / (torch.abs(d) + c) ** 2
        elif name == "mape":
            # RegressionMAPELOSS (regression_objective.hpp:724-740): label
            # weight 1/max(1,|y|); the sample weight multiplies in below
            lw = 1.0 / torch.clamp_min(torch.abs(y), 1.0)
            g, h = torch.sign(F - y) * lw, one
        elif name == "tweedie":
            # RegressionTweedieLoss (regression_objective.hpp:840-856)
            rho = float(p["tweedie_variance_power"])
            e1 = torch.exp((1.0 - rho) * F)
            e2 = torch.exp((2.0 - rho) * F)
            g = -y * e1 + e2
            h = torch.clamp_min(-y * (1.0 - rho) * e1 + (2.0 - rho) * e2,
                                1e-12)
        elif name == "cross_entropy" or (name == "cross_entropy_lambda"
                                         and w is None):
            # (xentropy_objective.hpp:84-85)
            z = 1.0 / (1.0 + torch.exp(-F))
            g, h = z - y, torch.clamp_min(z * (1.0 - z), 1e-12)
            if name == "cross_entropy_lambda":
                return g, h
        elif name == "tobit":
            # censored-Gaussian (Grabit) gradients
            # (regression_objective.hpp:938-960); scipy's norm.logpdf and
            # norm.logcdf (log_ndtr)
            sig = float(p.get("sigma", 1.0))
            yl = float(p.get("yl", -np.inf))
            yu = float(p.get("yu", np.inf))
            diff = (y - F) / sig
            logpdf = -diff ** 2 / 2.0 - np.log(np.sqrt(2 * np.pi))
            r_lo = torch.exp(logpdf - torch.special.log_ndtr(diff))
            r_up = torch.exp(logpdf - torch.special.log_ndtr(-diff))
            lower, upper = y <= yl, y >= yu
            g = torch.where(lower, r_lo / sig,
                            torch.where(upper, -r_up / sig, -diff / sig))
            h = torch.where(lower, (r_lo * diff + r_lo ** 2) / sig ** 2,
                            torch.where(upper,
                                        (-r_up * diff + r_up ** 2) / sig ** 2,
                                        _full(F, 1.0 / sig ** 2)))
            h = torch.clamp_min(h, 1e-12)
        elif name == "lambdarank":
            g, h = self._rank.lambdarank(F, sigmoid=float(p["sigmoid"]),
                                         norm=bool(p["lambdarank_norm"]))
            h = torch.clamp_min(h, 1e-12)
        elif name == "rank_xendcg":
            g, h = self._rank.xendcg(F)
            h = torch.clamp_min(h, 1e-12)
        elif name == "binary_lgb":
            # (binary_objective.hpp:106-137)
            sig = float(p["sigmoid"])
            lab = torch.where(y > 0, _full(y, 1.0), _full(y, -1.0))
            lw = torch.where(y > 0, _full(y, self._binary_lw[1]),
                             _full(y, self._binary_lw[0]))
            resp = -lab * sig / (1.0 + torch.exp(lab * sig * F))
            ar = torch.abs(resp)
            g = resp * lw
            h = torch.clamp_min(ar * (sig - ar) * lw, 1e-12)
        elif name == "cross_entropy_lambda":
            # (xentropy_objective.hpp:192-216): the weight sits inside the
            # loss and is not applied again
            epf = torch.exp(F)
            hhat = torch.log1p(epf)
            z = 1.0 - torch.exp(-w * hhat)
            g = (1.0 - y / z) * w / (1.0 + 1.0 / epf)
            c = 1.0 / (1.0 - z)
            d = 1.0 + epf
            a = w * epf / (d * d)
            d2 = c - 1.0
            b = (c / (d2 * d2)) * (1.0 + w * epf - c)
            return g, torch.clamp_min(a * (1.0 + y * b), 1e-12)
        else:
            # a likelihood of the registry: the derivatives of its log
            # density (torch.func)
            g = -self._lik.d1(y, F, self._aux)
            h = torch.clamp_min(-self._lik.d2(y, F, self._aux), 1e-12)
        if w is not None:
            g, h = g * w, h * w
        return g, h

    def _refit_gp_cov(self):
        """(Re-)estimate the covariance parameters on the residuals of the
        current ensemble (gbdt.cpp:549): a full fit the first time, then
        the warm-started GD from the previous optimum
        (reuse_learning_rates_gp_model, config.h:181)."""
        gp = self.gp_model
        if gp._likelihood_obj is not None:
            self._refit_laplace()
            self._gp_refit_iter = self.current_iteration_
            return
        resid = self.F - self.y
        if self.params["train_gp_model_cov_pars"]:
            if self._gp_init_pars is None:
                gp.fit(y=resid)
                self._gp_init_pars = gp._fit_result.cov_pars
                self._gp_lr = 0.1
            else:
                lr0 = self._gp_lr \
                    if self.params["reuse_learning_rates_gp_model"] else 0.1
                pars, nll, lr, _ = gd_fit_engine(
                    gp._engine, self._gp_init_pars, resid, lr0=lr0,
                    max_iter=int(self.params["maxit_gp"]))
                self._gp_lr = min(max(lr, 1e-8) * 2.0, 0.1)
                self._gp_init_pars = pars
                gp._fit_result.cov_pars = pars
                gp._fit_result.neg_log_likelihood = nll
        elif not gp.model_has_been_fitted:
            gp.fit(y=resid)
            self._gp_init_pars = gp._fit_result.cov_pars
        self._gp_refit_iter = self.current_iteration_

    def _refit_laplace(self):
        """The non-Gaussian refit at the current F (gbdt.py:1181-1227): a
        full fit with the GP model's own settings the first time (or
        whenever the fast path does not apply: covariates, two predictor
        sets), then the warm-started GD refit of the parameters and the
        mode, with the learning rate restarted at its default each
        round."""
        gp = self.gp_model
        if not (self.params["train_gp_model_cov_pars"]
                or not gp.model_has_been_fitted):
            return
        eng = gp._engine
        if gp.model_has_been_fitted and gp.X is None \
                and eng.num_sets_fe == 1:
            r = gp._fit_result
            a0 = r.mode_state if r.mode_state is not None \
                else eng.zero_mode()
            lr0 = float(gp.params.lr_cov) if gp.params.lr_cov > 0 else 0.1
            pars, aux, nll, _, _, a = gd_fit_laplace_engine(
                eng, r.cov_pars, r.aux_pars if eng.num_aux else None,
                self.y, self.F, a0, lr0=lr0,
                max_iter=int(self.params["maxit_gp"]),
                est_aux=bool(gp.params.estimate_aux_pars))
            r.cov_pars = pars
            if aux is not None:
                r.aux_pars = aux
            r.neg_log_likelihood = nll
            r.mode_state = a
            self._gp_init_pars = pars
        else:
            fp = {}
            if self._gp_init_pars is not None:
                fp["init_cov_pars"] = self._gp_init_pars
            gp.fit(y=self.y.cpu().numpy(), offset=self.F.cpu().numpy(),
                   params=fp)
            self._gp_init_pars = gp._fit_result.cov_pars

    def _newton_leaf_values(self, tree, slot_of_row, leaf_value_of_slot):
        """Joint GLS re-solve of the leaf values given the tree's
        structure, a* = (H' Psi~^-1 H)^-1 H' Psi~^-1 (y - F) with H the
        (n, leaves) leaf incidence (re_model_template.h:4947
        NewtonUpdateLeafValues; gbdt.py:1411-1430), on the device."""
        eng = self.gp_model._engine
        t = eng.transform_pars(self.gp_model._fit_result.cov_pars)
        slots = torch.unique(slot_of_row)
        H = (slot_of_row[:, None] == slots[None, :]).to(torch.float64)
        PiH = eng.psi_tilde_inv_mat(t, H)
        A = H.T @ PiH + 1e-12 * torch.eye(len(slots), dtype=torch.float64,
                                          device=H.device)
        vals = torch.linalg.solve(A, PiH.T @ (self.y - self.F))
        for s_, v_ in zip(slots.tolist(), vals.tolist()):
            leaf_value_of_slot[s_] = v_
            node = tree.slot_to_node.get(s_)
            if node is not None:
                tree.leaf_value[node] = v_

    def _line_search(self, tree, slot_of_row, leaf_value_of_slot):
        """Optimal step length of the Gaussian GPBoost algorithm: the 1-D
        GLS optimum alpha = h' Psi~^-1 r / h' Psi~^-1 h, clipped to [0, 10]
        (re_model.cpp:697 LineSearchLearningRate; gbdt.py:1431-1450).
        Returns the scaled leaf values; the tree is scaled in place."""
        eng = self.gp_model._engine
        t = eng.transform_pars(self.gp_model._fit_result.cov_pars)
        h = torch.as_tensor(leaf_value_of_slot,
                            device=self.device)[slot_of_row]
        Pih = eng.psi_tilde_inv_mat(t, h[:, None])[:, 0]
        denom, num = torch.stack([h @ Pih, (self.y - self.F) @ Pih]).tolist()
        if denom > 1e-300:
            alpha = min(max(num / denom, 0.0), 10.0)
            tree.shrinkage(alpha)
            leaf_value_of_slot = leaf_value_of_slot * alpha
        return leaf_value_of_slot

    # ------------------------------------------------------------------
    def _sampling_masks(self):
        """(row_mask, feat_mask) for this round, device tensors or None
        (gbdt.py:1230-1256): every bagging_freq rounds a new
        bagging_fraction subset of the rows (the tree grows on it, and
        every row's score is updated); a new feature_fraction subset of the
        features for every tree. The draws are the reference's numpy
        RandomState draws, copied to the device without a host sync."""
        p = self.params
        row_mask = None
        bf = float(p["bagging_fraction"])
        freq = int(p["bagging_freq"])
        if bf < 1.0 and freq > 0:
            if self._row_mask is None or self.current_iteration_ % freq == 0:
                k = max(1, int(round(bf * self.n)))
                sel = self._bag_rng.choice(self.n, size=k, replace=False)
                m = np.zeros(self.n)
                m[sel] = 1.0
                self._row_mask = _to_device(torch.as_tensor(m), self.device)
            row_mask = self._row_mask
        feat_mask = None
        ff = float(p["feature_fraction"])
        pfeat = self.learner.p
        if ff < 1.0 and pfeat > 1:
            k = max(1, int(round(ff * pfeat)))
            sel = self._feat_rng.choice(pfeat, size=k, replace=False)
            m = np.zeros(pfeat, dtype=np.float32)
            m[sel] = 1.0
            feat_mask = _to_device(torch.as_tensor(m), self.device)
        return row_mask, feat_mask

    def _renew_leaf_values(self, tree, slot_of_row, leaf_value_of_slot,
                           row_mask):
        """RenewTreeOutput for l1, quantile and mape (serial_tree_learner.
        cpp:685; regression_objective.hpp:351/:647/:755; gbdt.py:
        1386-1410): each leaf's value becomes the (weighted) percentile of
        the residuals y - F of its in-bag rows, on the device. Two host
        reads: the rows per leaf, then the values."""
        name = self.objective_name
        alpha = float(self.params["alpha"]) if name == "quantile" else 0.5
        w = self._w
        if name == "mape":
            lw = 1.0 / torch.clamp_min(torch.abs(self.y), 1.0)
            w = lw if w is None else lw * w
        nslot = len(leaf_value_of_slot)
        # out-of-bag rows go to one more segment, which is not renewed
        key = slot_of_row if row_mask is None else torch.where(
            row_mask > 0, slot_of_row, torch.full_like(slot_of_row, nslot))
        counts = torch.zeros(nslot + 1, dtype=torch.int64,
                             device=key.device).index_add_(
            0, key, torch.ones_like(key)).cpu().numpy()
        counts[nslot] = 0
        vals = _segment_percentiles(self.y - self.F, key, counts, w,
                                    alpha).cpu().numpy()
        for s_, v_ in zip(np.flatnonzero(counts > 0), vals):
            leaf_value_of_slot[int(s_)] = v_
            node = tree.slot_to_node.get(int(s_))
            if node is not None:
                tree.leaf_value[node] = v_

    def _note_cegb_usage(self, tree):
        """Record the features the model has split on, for the coupled
        CEGB penalty (cost_effective_gradient_boosting.hpp:93-103
        UpdateUsed; gbdt.py:1477)."""
        if self._cegb_used is None:
            return
        nn = tree.num_nodes
        self._cegb_used[tree.split_feature[:nn][~tree.is_leaf[:nn]]] = 1.0

    def _momentum_mu(self, i):
        p = self.params
        return _nesterov_schedule(i, int(p["momentum_schedule_version"]),
                                  float(p["nesterov_acc_rate"]),
                                  int(p["momentum_offset"]))

    def _slot_values(self, tree):
        """A tree's current leaf values by the learner's leaf slot, on the
        device (copied without a host sync)."""
        v = np.zeros(self.learner.num_leaves + 8)
        for slot, node in tree.slot_to_node.items():
            v[slot] = tree.leaf_value[node]
        return _to_device(torch.as_tensor(v), self.device)

    def _dart_drop(self):
        """DART dropout (dart.hpp:97 DroppingTrees, uniform mode;
        gbdt.py:1258-1280): with the reference's draws from drop_seed's
        RandomState (one for skip_drop, then one per tree), a subset of the
        trees leaves the training score. Each dropped tree's contribution
        is its current leaf values at the leaf slots it routed the rows to
        when it grew, on the device. Returns (indices, contributions)."""
        p = self.params
        if self._drop_rng.rand() < float(p["skip_drop"]):
            return [], []
        drop_rate = float(p["drop_rate"])
        max_drop = int(p["max_drop"])
        if max_drop > 0:
            drop_rate = min(drop_rate, max_drop / max(len(self.trees), 1.0))
        drop_idx = [i for i in range(len(self.trees))
                    if self._drop_rng.rand() < drop_rate]
        if max_drop > 0:
            drop_idx = drop_idx[:max_drop]
        contribs = []
        for i in drop_idx:
            c = self._slot_values(self.trees[i])[self._tree_slots[i]]
            self.F = self.F - c
            contribs.append(c)
        return drop_idx, contribs

    def _goss_mask(self, grad, hess):
        """Gradient-based one-side sampling (goss.hpp; gbdt.py:1282-1301):
        after int(1 / learning_rate) warm-up rounds, the top_rate share of
        the rows by |grad hess| and an other_rate sample of the rest,
        amplified by (1 - a) / b (a float32 factor, as the reference's
        mask). The rows are ordered on the device; the sample's positions
        in that order come from bagging_seed's RandomState, as in the
        reference, and go up without a host read. np.argsort is not stable,
        so rows with tied |grad hess| may be ordered otherwise than the
        reference orders them. Returns a float32 (n,) mask or None."""
        p = self.params
        if self.current_iteration_ < int(1.0 / float(p["learning_rate"])):
            return None
        a, b = float(p["top_rate"]), float(p["other_rate"])
        n = self.learner.n
        top_k = max(1, int(round(a * n)))
        rest_k = max(1, int(round(b * n)))
        order = torch.sort(torch.abs(grad * hess), descending=True,
                           stable=True).indices
        # index_fill_ takes the value as a scalar argument: no host copy,
        # no sync (an indexed assignment copies the value up and waits)
        mask = torch.zeros(n, dtype=torch.float32, device=grad.device)
        mask.index_fill_(0, order[:top_k], 1.0)
        if n > top_k:
            sel = self._bag_rng.choice(n - top_k, size=min(rest_k, n - top_k),
                                       replace=False)
            mask.index_fill_(0, order[top_k + _to_device(
                torch.as_tensor(sel), grad.device)], (1.0 - a) / b)
        return mask

    def _fit_linear_leaves(self, tree, grad, hess, slot_of_row):
        """Linear leaves (linear_tree_learner.cpp; gbdt.py:2659-2696): each
        leaf's ridge regression of the Newton targets on the numeric
        features of its path (categorical split features left out,
        nan_to_num on X), M = A'HA + (linear_lambda + lambda_l2 + 1e-8) I,
        rhs = -A'g with A = [1, X_path], over every row of the leaf. A leaf
        with no such feature, fewer than 2 (d + 1) rows or a solve that is
        not finite keeps its constant. On the device: one index_add_ of
        h A A' per leaf slot over rows padded to the longest path (the
        padded block's identity keeps the solve that of the leaf's own
        size), one batched solve, one host read of the solutions. The
        constant part replaces the leaf value; the slopes go to
        tree.leaf_linear. Returns A = [1, X_path] (n, D + 1) on the device
        (zeros past each row's own leaf model) for `_linear_score`, or None
        when no leaf has a model to fit."""
        p = self.params
        lam = float(p.get("linear_lambda", 0.0)) + float(p["lambda_l2"])
        path = {0: []}
        for node in range(tree.num_nodes):
            if not tree.is_leaf[node]:
                f = int(tree.split_feature[node])
                base = path.get(node, [])
                path[int(tree.left[node])] = base + [f]
                path[int(tree.right[node])] = base + [f]
        cat = {int(tree.split_feature[nd]) for nd in tree.cat_left_bins}
        fits = {}
        for slot, node in tree.slot_to_node.items():
            feats = sorted(set(f for f in path.get(node, []) if f not in cat))
            # the learner's cover is the leaf's row count, every row
            if feats and round(tree.cover[node]) >= 2 * (len(feats) + 1):
                fits[slot] = feats
        if not fits:
            return None
        n, S = self.learner.n, self.learner.num_leaves + 8
        D = max(len(f) for f in fits.values())
        fi = np.full((S, D), -1, dtype=np.int64)
        for slot, feats in fits.items():
            fi[slot, :len(feats)] = feats
        fi = _to_device(torch.as_tensor(fi), self.device)
        if self._X_lin is None:
            self._X_lin = torch.as_tensor(np.nan_to_num(np.asarray(
                self.train_set.data, dtype=np.float64)[self.learner.rows]),
                device=self.device)
        # each row's leaf model's raw features (0 where the leaf has fewer)
        f = fi[slot_of_row]
        x = torch.gather(self._X_lin, 1, f.clamp_min(0))
        A = torch.cat([torch.ones((n, 1), dtype=torch.float64,
                                  device=self.device),
                       torch.where(f >= 0, x, torch.zeros_like(x))], dim=1)
        M = torch.zeros((S, D + 1, D + 1), dtype=torch.float64,
                        device=self.device)
        # rows in chunks of at most 2^24 products
        step = max(1, (1 << 24) // (D + 1) ** 2)
        for r in range(0, n, step):
            Ar = A[r:r + step]
            M.index_add_(0, slot_of_row[r:r + step],
                         hess[r:r + step, None, None] * Ar[:, :, None]
                         * Ar[:, None, :])
        rhs = torch.zeros((S, D + 1), dtype=torch.float64,
                          device=self.device).index_add_(
            0, slot_of_row, -A * grad[:, None])
        dims = (fi >= 0).sum(1)
        j = torch.arange(D + 1, device=self.device)
        ridge = torch.where(j[None, :] <= dims[:, None],
                            torch.full((S, D + 1), lam + 1e-8,
                                       dtype=torch.float64,
                                       device=self.device),
                            torch.ones((S, D + 1), dtype=torch.float64,
                                       device=self.device))
        W, info = torch.linalg.solve_ex(M + torch.diag_embed(ridge),
                                        rhs[:, :, None])
        W = torch.cat([W[:, :, 0], info[:, None].to(torch.float64)],
                      dim=1).cpu().numpy()
        for slot, feats in fits.items():
            d = len(feats)
            w = W[slot, :d + 1]
            if W[slot, -1] != 0 or not np.all(np.isfinite(w)):
                continue
            node = tree.slot_to_node[slot]
            tree.leaf_value[node] = w[0]
            tree.leaf_linear[node] = (np.asarray(feats, dtype=int),
                                      w[1:].copy())
        return A

    def _linear_score(self, tree, A, slot_of_row):
        """A tree with linear leaves on the training rows (Tree.predict_raw
        by the rows' leaf slots): each row's A = [1, X_path] from
        `_fit_linear_leaves` times its leaf's current constant and slopes
        (a leaf without slopes keeps its constant), on the device."""
        coef = np.zeros((self.learner.num_leaves + 8, A.shape[1]))
        for slot, node in tree.slot_to_node.items():
            coef[slot, 0] = tree.leaf_value[node]
            if node in tree.leaf_linear:
                c = tree.leaf_linear[node][1]
                coef[slot, 1:1 + len(c)] = c
        coef = _to_device(torch.as_tensor(coef), self.device)
        return (A * coef[slot_of_row]).sum(1)

    def update(self):
        """One boosting iteration (gbdt.cpp:412 TrainOneIter; gbdt.py:
        1311-1475): one tree per predictor block, each on its block's part
        of one gradient (multiclass, mean_scale_regression and a
        two-predictor likelihood; interleaved in self.trees), then the
        refit. A single-block model runs its boosting type: DART drops
        trees before the gradients and renormalises them after the new
        tree, GOSS samples the rows by |grad hess|, a random forest fits
        every tree to the gradients at the init score and averages them;
        with linear_tree the leaves get their linear models."""
        K, n = self._nsets, self.learner.n
        p = self.params
        boosting = p["boosting"] if K == 1 else "gbdt"
        if p["use_nesterov_acc"] and K == 1:
            # the momentum step on the score comes before the gradients;
            # with a GP model the covariance parameters are refitted on the
            # post-momentum residuals (gbdt.cpp:428 condition iii)
            if self._F_lag1 is None:
                self._F_lag1 = self.F.clone()
            mu = self._momentum_mu(self.current_iteration_)
            F_new = (1.0 + mu) * self.F - mu * self._F_lag1
            self._F_lag1, self.F = self.F, F_new
            if self.gp_model is not None:
                self._refit_gp_cov()
        drop_idx, drop_contrib = [], []
        if boosting == "dart" and self.trees:
            drop_idx, drop_contrib = self._dart_drop()
        if boosting == "rf":
            # random forest (rf.hpp): the gradients at the init score,
            # taken once
            if self._rf_grad is None:
                F_save = self.F
                self.F = torch.full_like(F_save, self.init_score)
                self._rf_grad = self._gradients()
                self.F = F_save
            grad, hess = self._rf_grad
        else:
            grad, hess = self._gradients()
        row_mask, feat_mask = self._sampling_masks()
        if boosting == "goss":
            gm = self._goss_mask(grad, hess)
            if gm is not None:
                row_mask = gm
        lr = float(p["learning_rate"])
        if boosting == "dart":
            # dart.hpp:137: the new tree's weight lr / (k + 1)
            lr = lr / (1.0 + len(drop_idx))
        linear = K == 1 and bool(p["linear_tree"])
        for k in range(K):
            blk = slice(k * n, (k + 1) * n)
            tree, slot_of_row, leaf_value_of_slot = self.learner.train(
                grad[blk], hess[blk], row_mask=row_mask, feat_mask=feat_mask,
                cegb_used=self._cegb_used,
                extra_seed=int(p["extra_seed"]) + 131 * len(self.trees))
            self._note_cegb_usage(tree)
            A_lin = self._fit_linear_leaves(tree, grad, hess, slot_of_row) \
                if linear else None
            if K == 1 and self.gp_model is None and not linear \
                    and self.objective_name in ("l1", "quantile", "mape"):
                self._renew_leaf_values(tree, slot_of_row,
                                        leaf_value_of_slot, row_mask)
            if K == 1 and self.gp_model is not None \
                    and self.gp_model._likelihood_obj is None:
                if p["leaves_newton_update"]:
                    self._newton_leaf_values(tree, slot_of_row,
                                             leaf_value_of_slot)
                if p["line_search_step_length"]:
                    leaf_value_of_slot = self._line_search(
                        tree, slot_of_row, leaf_value_of_slot)
            lv = _to_device(torch.as_tensor(leaf_value_of_slot), self.device)
            if boosting == "rf":
                # trees unshrunk; the score is the init score plus their
                # mean
                self._rf_sum = self._rf_sum + lv[slot_of_row]
                self.trees.append(tree)
                self.current_iteration_ = len(self.trees)
                self.F = self.init_score + self._rf_sum / len(self.trees)
                return False
            tree.shrinkage(lr)
            F = self.F.clone()
            if tree.leaf_linear:
                F[blk] += self._linear_score(tree, A_lin, slot_of_row)
            else:
                F[blk] += lr * lv[slot_of_row]
            self.F = F
            if boosting == "dart":
                self._tree_slots.append(slot_of_row.to(torch.int32))
            self.trees.append(tree)
        if drop_idx:
            # dart.hpp:158 Normalize: the dropped trees keep k / (k + 1) of
            # their weight, and so their contributions to the score
            kk = float(len(drop_idx))
            for i, c in zip(drop_idx, drop_contrib):
                self.trees[i].shrinkage(kk / (kk + 1.0))
                self.F = self.F + c * (kk / (kk + 1.0))
            self._rescales += 1
        self.current_iteration_ = len(self.trees) // K
        # refit on the post-tree residuals so get_cov_pars(), predictions
        # and the next round's gradients see the current ensemble
        if self.gp_model is not None:
            self._refit_gp_cov()
        return False

    # ------------------------------------------------------------------
    def _add_tree(self, F, lag, it, X):
        """Tree `it` added to the raw score F of its block (the trees
        before it summed from 0, no init score), with the Nesterov
        recursion replayed (gbdt.py:2035-2050; a two-predictor model takes
        no momentum step, as in update): returns the new (F, lag)."""
        if self.params["use_nesterov_acc"] and self._nsets == 1:
            if it == 1:
                lag = F.copy()
            elif it > 1:
                mu = self._momentum_mu(it)
                F, lag = (1.0 + mu) * F - mu * lag, F
        return F + self._tree_predict(self.trees[it], X), lag

    def _tree_leaf_index(self, tree, X):
        """Leaf node index per raw row; with EFB bundles the rows are
        re-encoded into the learner's bins, where the bundle splits live
        (gbdt.py:2202-2208)."""
        if getattr(self.train_set, "bundles", None):
            return tree.leaf_index_binned(self.train_set.encode_raw(X))
        return tree.leaf_index_raw(X)

    def _tree_predict(self, tree, X):
        """One tree's output on raw rows (`_tree_leaf_index`)."""
        if getattr(self.train_set, "bundles", None):
            return tree.leaf_value[self._tree_leaf_index(tree, X)]
        return tree.predict_raw(X)

    def _prep_X(self, data):
        """Raw rows as the trees read them (gbdt.py:1910-1927): a pandas
        frame coded with the training categories, then use_missing=False
        maps NaN to 0 and zero_as_missing maps 0 to NaN, as the binning
        did."""
        if hasattr(data, "dtypes") and hasattr(data, "columns"):
            from .dataset import _data_from_pandas
            data = _data_from_pandas(
                data, pandas_categorical=self._pandas_categorical)[0]
        X = _raw_X(data)
        if not self.params.get("use_missing", True):
            X = np.nan_to_num(X, nan=0.0)
        elif self.params.get("zero_as_missing", False):
            X = np.where(X == 0.0, np.nan, X)
        return X

    def _raw_predict(self, X, start_iteration, num_iteration, pred_early_stop,
                     pred_early_stop_freq, pred_early_stop_margin):
        """The ensemble's raw score on X over trees [start_iteration,
        start_iteration + num_iteration), the init score added when the
        slice starts at 0 (gbdt.py:1967-2074); a multi-output model's K
        blocks stacked, a random forest's trees averaged."""
        s = int(start_iteration)
        K = self._nsets
        if K > 1:
            # interleaved trees: tree i adds to block i % K (gbdt.py:
            # 1967-2030), each block summed from 0 and its init score added
            # last, as _RunningScore sums them
            nit = len(self.trees) // K - s if num_iteration is None \
                or num_iteration <= 0 else int(num_iteration)
            used = self.trees[K * s: K * (s + nit)]
            inits = np.asarray(self._block_inits() if s == 0 else [0.0] * K)
            Fk = [np.zeros(len(X)) for _ in range(K)]
            if pred_early_stop and self.objective_name == "multiclass":
                # per-row early stopping on the top1 - top2 margin of the
                # raw scores, checked every freq * K trees
                # (prediction_early_stop.cpp:38 MulticlassScoreFunction)
                active = np.ones(len(X), dtype=bool)
                freq = max(1, int(pred_early_stop_freq)) * K
                for i, tree in enumerate(used):
                    if i and i % freq == 0:
                        top2 = np.sort(np.stack(Fk)[:, active]
                                       + inits[:, None], axis=0)[-2:]
                        active[np.flatnonzero(active)[
                            (top2[1] - top2[0])
                            >= float(pred_early_stop_margin)]] = False
                        if not active.any():
                            break
                    Fk[i % K][active] += self._tree_predict(tree, X[active])
            else:
                for i, tree in enumerate(used):
                    Fk[i % K] = Fk[i % K] + self._tree_predict(tree, X)
            if s == 0:
                Fk = [f + c for f, c in zip(Fk, inits)]
            return np.concatenate(Fk)
        ntrees = len(self.trees) - s if num_iteration is None \
            or num_iteration <= 0 else int(num_iteration)
        used = range(s, min(s + ntrees, len(self.trees)))
        F = np.zeros(len(X))
        if self.params["use_nesterov_acc"]:
            if s > 1 and len(used):
                raise ValueError("use_nesterov_acc: the momentum recursion "
                                 "needs the trees before start_iteration; "
                                 "predict with start_iteration 0 or 1")
            lag = None
            for it in used:
                F, lag = self._add_tree(F, lag, it, X)
        elif pred_early_stop and self.objective_name in _BINARY_OBJECTIVES:
            # per-row prediction early stopping: the binary margin is |raw
            # score| with the init score (prediction_early_stop.cpp:60)
            active = np.ones(len(X), dtype=bool)
            freq = max(1, int(pred_early_stop_freq))
            for i, it in enumerate(used):
                if i and i % freq == 0:
                    active[np.flatnonzero(active)[
                        np.abs(F[active] + self.init_score)
                        >= float(pred_early_stop_margin)]] = False
                    if not active.any():
                        break
                F[active] += self._tree_predict(self.trees[it], X[active])
        else:
            for it in used:
                F = F + self._tree_predict(self.trees[it], X)
        if self.params["boosting"] == "rf" and len(used):
            F = F / len(used)       # rf.hpp: average_output_
        if s == 0:
            # the init score belongs to iteration 0, so raw slices over
            # start_iteration sum to the full prediction
            F = F + self.init_score
        return F

    def predict(self, data, start_iteration=0, num_iteration=None,
                raw_score=False, pred_latent=False, pred_contrib=False,
                group_data_pred=None, group_rand_coef_data_pred=None,
                gp_coords_pred=None, gp_rand_coef_data_pred=None,
                cluster_ids_pred=None, predict_var=False,
                predict_cov_mat=False, ignore_gp_model=False,
                pred_early_stop=False, pred_early_stop_freq=10,
                pred_early_stop_margin=10.0, cov_pars=None, pred_leaf=False,
                sample_posterior=False, sample_prior=False,
                num_post_samples=100, num_prior_samples=None, seed=None):
        """Fixed effect from the trees plus the GP model's random effect
        (basic.py:3455; gbdt.py:1890-2153). Without a GP model (or with
        ignore_gp_model) the objective's output, (n,) numpy: the raw score
        with raw_score, else its transform (probabilities for the binary
        objectives, exp for tweedie and the log-link likelihoods). With a
        GP model a dict: fixed_effect, random_effect_mean,
        random_effect_cov (the covariance matrix with predict_cov_mat, else
        the variances), random_effect_var, and the response's mean and
        variance unless pred_latent. start_iteration / num_iteration slice
        the trees (num_iteration None or <= 0: all of them; the best
        iteration of early stopping is not applied by default, as in the
        reference); pred_early_stop stops a binary model's rows whose
        margin exceeds pred_early_stop_margin, checked every
        pred_early_stop_freq trees. sample_posterior / sample_prior (with
        num_post_samples, num_prior_samples and seed) pass to
        `GPModel.predict`; the samples come back under 'posterior_samples'
        / 'prior_samples' with the trees' fixed effect added (for a
        non-Gaussian model only with pred_latent, as the reference,
        gbdt.py:2117-2150)."""
        X = self._prep_X(data)
        if pred_leaf or pred_contrib:
            K = self._nsets
            nit = num_iteration if num_iteration and num_iteration > 0 \
                else len(self.trees) // K - int(start_iteration)
            used = self.trees[K * int(start_iteration):
                              K * (int(start_iteration) + int(nit))]
            if pred_leaf:
                # the leaf node index of every row in every tree used
                # (basic.py predict pred_leaf; gbdt.py:1933-1942)
                return np.stack([self._tree_leaf_index(t, X) for t in used],
                                axis=1).astype(np.int32)
            # TreeSHAP (gbdt.py:1943-1966): (n, p + 1) per predictor block,
            # the expected value last; the init scores belong to iteration 0
            mats = [self._shap_matrix(used[k::K], X) for k in range(K)]
            if self.params["boosting"] == "rf" and used:
                mats = [m / len(used) for m in mats]
            if int(start_iteration) == 0:
                for k, c in enumerate(self._block_inits()):
                    mats[k][:, -1] += c
            return np.concatenate(mats, axis=1)
        F_pred = self._raw_predict(
            X, start_iteration, num_iteration, pred_early_stop,
            pred_early_stop_freq, pred_early_stop_margin)
        return self._predict_output(
            F_pred, raw_score=raw_score, pred_latent=pred_latent,
            group_data_pred=group_data_pred,
            group_rand_coef_data_pred=group_rand_coef_data_pred,
            gp_coords_pred=gp_coords_pred,
            gp_rand_coef_data_pred=gp_rand_coef_data_pred,
            cluster_ids_pred=cluster_ids_pred, predict_var=predict_var,
            predict_cov_mat=predict_cov_mat, ignore_gp_model=ignore_gp_model,
            cov_pars=cov_pars, sample_posterior=sample_posterior,
            sample_prior=sample_prior, num_post_samples=num_post_samples,
            num_prior_samples=num_prior_samples, seed=seed)

    def _shap_matrix(self, used, X):
        """(n, p + 1) TreeSHAP contributions of the trees `used` on raw rows
        X, the expected value last (gbdt.py:1838-1889; the native
        gpb_tree_shap). With EFB the trees are read in the learner's bins
        (a numeric feature's missing bin as NaN, so that it follows the
        split's default direction, as the bins do) and each bundle
        column's attribution goes to the row's active member, split evenly
        when none is. A categorical split reads one more column, whether
        the row goes left there, whose attribution goes to its feature:
        the rows sum to the prediction, and a feature split once on a
        path gets its exact TreeSHAP value."""
        from ..native import tree_shap
        ds = self.train_set
        bundles = getattr(ds, "bundles", None)
        if bundles:
            bins = ds.encode_raw(X)
            Xs = bins.astype(np.float64)
            for lj, j in enumerate(ds.kept_features):
                m = ds.mappers[j]
                if not getattr(m, "is_categorical", False) \
                        and getattr(m, "has_nan", False):
                    Xs[bins[:, lj] == m.nan_bin, lj] = np.nan
        else:
            Xs = X
        n, ps = Xs.shape
        phi_s = np.zeros((n, ps + 1))
        for tree in used:
            shadow, Xe, back = _shap_tree(tree, Xs, bool(bundles))
            if not back:
                tree_shap(shadow, Xe, phi_s)
                continue
            phi_e = np.zeros((n, Xe.shape[1] + 1))
            tree_shap(shadow, Xe, phi_e)
            phi_s[:, :ps] += phi_e[:, :ps]
            phi_s[:, -1] += phi_e[:, -1]
            for k, f in enumerate(back):
                phi_s[:, f] += phi_e[:, ps + k]
        if not bundles:
            return phi_s
        phi = np.zeros((n, X.shape[1] + 1))
        kept = ds.kept_features
        for lj, j in enumerate(kept):
            phi[:, j] = phi_s[:, lj]
        for bi, b in enumerate(bundles):
            col = phi_s[:, len(kept) + bi]
            members = np.asarray(b.feature_ids)
            active = np.isfinite(X[:, members]) & (X[:, members] != 0.0)
            any_active = active.any(axis=1)
            first = np.argmax(active, axis=1)
            for mi, f in enumerate(members):
                hit = any_active & (first == mi)
                phi[hit, f] += col[hit]
                phi[~any_active, f] += col[~any_active] / len(members)
        phi[:, -1] = phi_s[:, -1]
        return phi

    def _predict_output(self, F_pred, raw_score=False, pred_latent=False,
                        group_data_pred=None, group_rand_coef_data_pred=None,
                        gp_coords_pred=None, gp_rand_coef_data_pred=None,
                        cluster_ids_pred=None, predict_var=False,
                        predict_cov_mat=False, ignore_gp_model=False,
                        cov_pars=None, **sampling):
        """`predict` from the ensemble's raw score F_pred (gbdt.py:
        1967-2153): the objective's output transform, or the GP model's
        prediction around it. Multiclass gives (n, K) probabilities (raw
        scores with raw_score), mean_scale_regression {"pred_mean",
        "pred_var"} (its two stacked blocks with raw_score)."""
        if self.gp_model is None or ignore_gp_model:
            name = self.objective_name
            if name == "multiclass":
                Fk = F_pred.reshape(self._nsets, -1)
                if raw_score:
                    return Fk.T
                S = Fk - Fk.max(0, keepdims=True)
                P = np.exp(S)
                P /= P.sum(0, keepdims=True)
                return P.T
            if raw_score:
                return F_pred
            if name == "mean_scale_regression":
                m, sv = F_pred.reshape(2, -1)
                return {"pred_mean": m, "pred_var": np.exp(sv)}
            if name == "cross_entropy":
                return 1.0 / (1.0 + np.exp(-F_pred))
            if name == "tweedie":
                # RegressionPoissonLoss::ConvertOutput (inherited)
                return np.exp(F_pred)
            if name == "binary_lgb":
                return 1.0 / (1.0 + np.exp(
                    -float(self.params["sigmoid"]) * F_pred))
            if name == "cross_entropy_lambda":
                # the exponential parameter lambda = log(1 + e^F), not a
                # probability (xentropy_objective.hpp:218-237)
                return np.log1p(np.exp(F_pred))
            if self._lik is None:
                return F_pred
            return self._lik.cond_mean(
                torch.as_tensor(F_pred), self._aux.cpu()).numpy()
        if self.gp_model._likelihood_obj is not None:
            return self._predict_laplace(
                F_pred, group_data_pred, group_rand_coef_data_pred,
                gp_coords_pred, gp_rand_coef_data_pred, cluster_ids_pred,
                predict_var, predict_cov_mat, pred_latent, cov_pars,
                sampling)
        resid = (self.y - self.F).cpu().numpy()
        pred = self.gp_model.predict(
            y=resid, group_data_pred=group_data_pred,
            group_rand_coef_data_pred=group_rand_coef_data_pred,
            gp_coords_pred=gp_coords_pred,
            gp_rand_coef_data_pred=gp_rand_coef_data_pred,
            cluster_ids_pred=cluster_ids_pred, predict_var=predict_var,
            predict_cov_mat=predict_cov_mat,
            predict_response=not pred_latent, cov_pars=cov_pars, **sampling)
        out = {"fixed_effect": F_pred, "random_effect_mean": pred["mu"],
               "random_effect_cov": pred["cov"] if predict_cov_mat
               else pred["var"],
               "random_effect_var": pred["var"],
               "response_mean": F_pred + pred["mu"]}
        if not pred_latent:
            out["response_var"] = pred["var"]
        for k in ("posterior_samples", "prior_samples"):
            if pred.get(k) is not None:
                # the samples carry the ensemble's fixed effect
                out[k] = pred[k] + F_pred[:, None]
        return out

    def _point_prediction(self, F_pred, **kwargs):
        """The point prediction a metric scores: `_predict_output`'s value
        without a GP model, its response mean (or the latent mean with
        pred_latent) with one."""
        pred = self._predict_output(F_pred, **kwargs)
        if isinstance(pred, dict) and "pred_mean" in pred:
            pred = pred["pred_mean"]
        elif isinstance(pred, dict):
            pred = pred.get("response_mean",
                            pred["fixed_effect"] + pred["random_effect_mean"])
        return np.asarray(pred)

    def _predict_laplace(self, F_pred, group_data_pred,
                         group_rand_coef_data_pred, gp_coords_pred,
                         gp_rand_coef_data_pred, cluster_ids_pred,
                         predict_var, predict_cov_mat, pred_latent, cov_pars,
                         sampling):
        """LaGaBoost predictions (gbdt.py:2126-2150): random_effect_mean is
        the latent random effect without the trees; the ensemble enters
        the response predictions as fixed_effects_pred."""
        pred = self.gp_model.predict(
            y=self.y.cpu().numpy(), offset=self.F.cpu().numpy(),
            group_data_pred=group_data_pred,
            group_rand_coef_data_pred=group_rand_coef_data_pred,
            gp_coords_pred=gp_coords_pred,
            gp_rand_coef_data_pred=gp_rand_coef_data_pred,
            cluster_ids_pred=cluster_ids_pred, predict_var=predict_var,
            predict_cov_mat=predict_cov_mat,
            predict_response=not pred_latent, cov_pars=cov_pars,
            fixed_effects_pred=None if pred_latent else F_pred, **sampling)
        out = {"fixed_effect": F_pred, "random_effect_mean": pred["mu"],
               "random_effect_cov": pred["cov"] if predict_cov_mat
               else pred["var"],
               "random_effect_var": pred["var"]}
        if not pred_latent:
            out["response_mean"] = pred["mu"]
            out["response_var"] = pred["var"]
        for k in ("posterior_samples", "prior_samples"):
            if pred.get(k) is not None:
                # the ensemble is added to latent samples only, as the
                # reference does (gbdt.py:2143-2149)
                out[k] = pred[k] + F_pred[:, None] if pred_latent \
                    else pred[k]
        return out

    def predict_training_data_random_effects(self, predict_var=False):
        """The random effects at the training points with the current
        ensemble as fixed effects (basic.py:3407; gbdt.py:2155)."""
        if self.gp_model is None:
            raise ValueError("predict_training_data_random_effects: "
                             "Booster has no gp_model")
        if self.gp_model._likelihood_obj is not None:
            return self.gp_model.predict_training_data_random_effects(
                predict_var=predict_var, offset=self.F.cpu().numpy())
        # the Gaussian hook works on residuals: refresh them to the current
        # ensemble
        self.gp_model.y = (self.y - self.F).cpu().numpy()
        return self.gp_model.predict_training_data_random_effects(
            predict_var=predict_var)

    def refit(self, data, label, decay_rate=None):
        """A new booster with this one's tree structures and their leaf
        values refitted on new data (basic.py:3804 Booster.refit;
        gbdt.cpp:314 RefitTree; gbdt.py:2217-2259): tree by tree, at the
        score of the trees refitted before it, each leaf's value becomes
        decay_rate * old + (1 - decay_rate) * new, with new the Newton step
        -sum g / (sum h + lambda_l2) (sum g soft-thresholded by lambda_l1)
        times the tree's shrinkage; decay_rate defaults to
        refit_decay_rate. The gradients and the leaf sums are on the device
        (one host read a tree); the rows' leaves are found on the host.
        Not with a GP model or a multi-output objective, as in the
        reference."""
        import copy
        if self.gp_model is not None:
            raise NotImplementedError("refit with a gp_model is not "
                                      "supported; retrain instead")
        if self._nsets > 1:
            raise NotImplementedError("refit is not supported for "
                                      "multi-output objectives")
        if decay_rate is None:
            decay_rate = float(self.params.get("refit_decay_rate", 0.9))
        X = _raw_X(data)
        y = np.asarray(label, dtype=np.float64)
        new = copy.copy(self)
        new.trees = [copy.deepcopy(t) for t in self.trees]
        new.train_set = None
        new.n = len(y)
        new.y = torch.as_tensor(y, device=self.device)
        new._w = None
        new.F = torch.full((len(y),), self.init_score, dtype=torch.float64,
                           device=self.device)
        lam = float(self.params["lambda_l2"])
        l1 = float(self.params["lambda_l1"])
        for tree in new.trees:
            g, h = new._objective_gradients()
            leaves, node = np.unique(tree.leaf_index_raw(X),
                                     return_inverse=True)
            node = _to_device(torch.as_tensor(node.reshape(-1)), self.device)
            sums = torch.zeros((2, len(leaves)), dtype=torch.float64,
                               device=self.device).index_add_(
                1, node, torch.stack([g, h])).cpu().numpy()
            sg, sh = sums[0], sums[1] + 1e-15
            sg = np.sign(sg) * np.maximum(np.abs(sg) - l1, 0.0)
            newv = -sg / (sh + lam) * tree.shrinkage_applied
            tree.leaf_value[leaves] = (decay_rate * tree.leaf_value[leaves]
                                       + (1.0 - decay_rate) * newv)
            new.F = new.F + _to_device(torch.as_tensor(
                tree.leaf_value[leaves]), self.device)[node]
        return new

    # ------------------------------------------------------------------
    def reset_parameter(self, params):
        """Update training parameters between rounds (the reset_parameter
        callback; basic.py Booster.reset_parameter), aliases resolved."""
        for k, v in (params or {}).items():
            self.params[_PARAM_ALIASES.get(k, k)] = v
        return self

    def num_trees(self):
        return len(self.trees)

    def current_iteration(self):
        return self.current_iteration_

    def eval_train(self):
        """[("training", "l2", mean squared residual, False)] for Gaussian
        regression, else [] (gbdt.py:2275)."""
        if self.objective_name != "gaussian":
            return []
        return [("training", "l2",
                 float(torch.mean((self.F - self.y) ** 2)), False)]

    def _train_resid_var(self):
        """The training residuals' variance, the plug-in predictive
        variance of the variance metrics without a GP model
        (regression_metric.hpp:473-480; gbdt.py:2541)."""
        return float(np.var((self.y - self.F[:len(self.y)]).cpu().numpy(),
                            ddof=1))

    # ------------------------------------------------------------------
    def model_to_dict(self):
        """The reference's model dict (gbdt.py:2282) for this booster,
        with the likelihood objective's aux parameters under
        "likelihood_aux" (a key the reference does not read)."""
        d = {
            "init_score": self.init_score,
            "objective": self.objective_name,
            "params": {k: v for k, v in self.params.items()
                       if isinstance(v, (int, float, str, bool))},
            "trees": [t.to_dict() for t in self.trees],
            "has_gp_model": int(self.gp_model is not None),
            "num_sets": self._nsets,
            "init_score2": self.init_score2,
        }
        if self._init_scores is not None:
            d["init_scores"] = np.asarray(self._init_scores).tolist()
        if self._binary_lw is not None:
            d["binary_label_weights"] = list(self._binary_lw)
        if self._pandas_categorical:
            d["pandas_categorical"] = {str(k): v for k, v
                                       in self._pandas_categorical.items()}
        ds = self.train_set
        if getattr(ds, "bundles", None):
            # the EFB encoder (gbdt.py:2306-2314), and what the JAX
            # package's dict leaves out: which kept features have a missing
            # bin, and a categorical kept feature's categories
            kept = list(ds.kept_features)
            cats = {str(j): np.asarray(ds.mappers[j].categories).tolist()
                    for j in kept
                    if getattr(ds.mappers[j], "is_categorical", False)}
            d["efb"] = {
                "kept_features": kept,
                "kept_upper_bounds": [
                    np.asarray(getattr(ds.mappers[j], "upper_bounds",
                                       [])).tolist() for j in kept],
                "kept_has_nan": [bool(getattr(ds.mappers[j], "has_nan",
                                              False)) for j in kept],
                "kept_categories": cats,
                "bundles": [b.to_dict() for b in ds.bundles],
                "num_features": ds.num_features,
            }
        if self._lik is not None:
            d["likelihood_aux"] = self._aux.cpu().numpy().tolist()
        if self.gp_model is not None and self.gp_model.model_has_been_fitted:
            d["gp_model"] = self.gp_model.model_to_dict()
            d["residual_or_y"] = (
                self.y if self.gp_model._likelihood_obj is not None
                else self.y - self.F).cpu().numpy().tolist()
            d["fixed_effect_train"] = self.F.cpu().numpy().tolist()
        return d

    def _load(self, d, device):
        """Rebuild a booster that predicts from a model dict (gbdt.py:2330
        _load), with its GP model, if it has one, on `device`."""
        from ..gp_model import GPModel
        laplace = bool(d.get("has_gp_model")) \
            and d["gp_model"]["likelihood"] not in ("gaussian", "regression")
        self._nsets = int(d.get("num_sets", 1))
        if self._nsets != 1 and d.get("has_gp_model") and not (
                self._nsets == 2 and laplace and getattr(
                    get_likelihood(d["gp_model"]["likelihood"]),
                    "num_sets_fe", 1) == 2):
            # with a GP model, several predictor blocks come only from a
            # likelihood with two predictor sets
            raise NotImplementedError(
                f"model dict with {self._nsets} predictor sets and a GP "
                f"model of likelihood '{d['gp_model']['likelihood']}'")
        self._init_scores = None if d.get("init_scores") is None \
            else np.asarray(d["init_scores"], dtype=np.float64)
        self.params = dict(_BOOST_PARAM_DEFAULTS)
        self.params.update(d.get("params", {}))
        self.init_score = float(d["init_score"])
        self.init_score2 = float(d.get("init_score2", 0.0))
        self.objective_name = d["objective"]
        self.trees = [Tree.from_dict(td) for td in d["trees"]]
        self._pandas_categorical = {
            int(k): v for k, v in d.get("pandas_categorical", {}).items()} \
            or None
        self.train_set = _efb_dataset(d["efb"], self.trees) \
            if d.get("efb") else None
        self.current_iteration_ = len(self.trees) // self._nsets
        self.device = resolve_device(device)
        self.gp_model = None
        self._binary_lw = None
        if d.get("binary_label_weights") is not None:
            self._binary_lw = tuple(d["binary_label_weights"])
        self._lik = None
        self._aux = None
        if not laplace and self.objective_name != "gaussian" \
                and self.objective_name not in _SPECIAL_OBJECTIVES:
            self._lik = get_likelihood(self.objective_name)
            aux = d.get("likelihood_aux", self._lik.default_aux)
            self._aux = torch.as_tensor(np.asarray(aux, dtype=np.float64),
                                        device=self.device)
        if not d.get("has_gp_model"):
            return
        self.gp_model = GPModel(model_dict=d["gp_model"], device=self.device)
        F = np.asarray(d["fixed_effect_train"], dtype=np.float64)
        y = np.asarray(d["residual_or_y"], dtype=np.float64)
        if not laplace:
            y = F + y
        self.F = torch.as_tensor(F, device=self.device)
        self.y = torch.as_tensor(y, device=self.device)
        self.n = len(F)


def _full(t, value):
    return torch.full_like(t, value)


def _efb_dataset(efb, trees):
    """A bare Dataset that carries a model dict's EFB encoder
    (gbdt.py:2345-2367): the kept features' mappers and the bundles. A
    dict without "kept_has_nan" (the JAX package's) gives a kept feature
    the missing bin that the trees' splits on it record."""
    from .dataset import (BinMapper, CategoricalBinMapper, Dataset,
                          FeatureBundle)
    ds = Dataset.__new__(Dataset)
    ds.bundles = [FeatureBundle.from_dict(bd) for bd in efb["bundles"]]
    ds.kept_features = list(efb["kept_features"])
    ds.num_features = efb["num_features"]
    ds.categorical_feature = []
    mappers = [None] * ds.num_features
    cats = efb.get("kept_categories") or {}
    has_nan = efb.get("kept_has_nan")
    if has_nan is None:
        split_nan = {int(t.split_feature[i]) for t in trees
                     for i in range(t.num_nodes)
                     if not t.is_leaf[i] and t.missing_bin[i] >= 0}
        has_nan = [lj in split_nan for lj in range(len(ds.kept_features))]
    for j, ub, nan in zip(ds.kept_features, efb["kept_upper_bounds"],
                          has_nan):
        if str(j) in cats:
            m = CategoricalBinMapper.__new__(CategoricalBinMapper)
            m.categories = np.asarray(cats[str(j)], dtype=np.float64)
            m.num_bins = len(m.categories) + 1
            m.other_bin = m.nan_bin = m.num_bins - 1
            m.has_nan = False
            ds.categorical_feature.append(j)
        else:
            m = BinMapper.__new__(BinMapper)
            m.upper_bounds = np.asarray(ub)
            m.has_nan = bool(nan)
            m.num_bins = len(m.upper_bounds) + int(m.has_nan)
            m.nan_bin = m.num_bins - 1 if m.has_nan else -1
        mappers[j] = m
    for b in ds.bundles:
        for fid, bm in zip(b.feature_ids, b.mappers):
            mappers[fid] = bm
    ds.mappers = mappers
    ds._constructed = True
    return ds


def _shap_tree(tree, Xs, binned):
    """(shadow tree, input, features) for `native.tree_shap`: the tree's
    arrays with thresholds in the bins (binned) or the raw values, and
    each categorical split rewritten as a split at 0.5 on one more column
    of Xs, 0 where the row goes left there; `features` lists the feature
    of each added column."""
    import types
    nn = tree.num_nodes
    sf = tree.split_feature[:nn].copy()
    thr = tree.threshold_bin[:nn].astype(np.float64) if binned \
        else tree.threshold_real[:nn].copy()
    cols, back = [], []
    p = Xs.shape[1]
    for node in sorted(tree.cat_left_bins if binned
                       else tree.cat_left_values):
        x = Xs[:, sf[node]]
        if binned:
            lb = tree.cat_left_bins[node]
            left = lb[np.clip(x.astype(np.int64), 0, len(lb) - 1)]
        else:
            left = np.isin(x, tree.cat_left_values[node]) & np.isfinite(x)
        cols.append(np.where(left, 0.0, 1.0))
        back.append(int(sf[node]))
        sf[node] = p + len(back) - 1
        thr[node] = 0.5
    shadow = types.SimpleNamespace(
        num_nodes=nn, split_feature=sf, threshold_real=thr, left=tree.left,
        right=tree.right, is_leaf=tree.is_leaf, leaf_value=tree.leaf_value,
        cover=tree.cover, default_left=tree.default_left)
    return shadow, np.column_stack([Xs] + cols) if cols else Xs, back


def train(params, train_set, num_boost_round=100, gp_model=None,
          valid_sets=None, valid_names=None, callbacks=None,
          early_stopping_rounds=None, verbose_eval=False, init_model=None,
          keep_training_booster=False, evals_result=None, feval=None,
          device=None):
    """Train a boosting model, with or without a GP model (engine.py:22
    train; gbdt.py:2443-2656), with the host loop: one `Booster.update` a
    round, then the validation metrics and the callbacks.

    valid_sets: Datasets with labels, scored after every round by the
    `metric` parameter (or feval(preds, dataset) -> (name, value,
    higher_better)); ndcg and map (ndcg by default for the ranking
    objectives, multi_logloss for multiclass) score the raw score of a set
    with a group, reported as "ndcg@k" at eval_at's first k; with
    early_stopping_rounds, training stops when the
    first set's metric has not improved (by more than 1e-15) for that many
    rounds, and best_iteration is the round of its best value. Predictions
    go through the GP model when use_gp_model_for_validation and the set
    carries the GP model's prediction inputs as a dict in .gp_valid_data;
    the metrics neg_log_likelihood and approx_neg_marginal_log_likelihood
    read the GP model's training NLL, test_neg_log_likelihood and
    crps_gaussian the predictive variance. evals_result collects every
    value; verbose_eval (True or a period) logs them. Callbacks run before
    (reset_parameter) and after each round (log_evaluation,
    record_evaluation, early_stopping, in their order). predict uses every
    tree unless given num_iteration, as in the reference.

    Run inside an initialised torch.distributed group with
    num_parallel_devices equal to its size, Gaussian-regression trees grow
    over the group (tree_learner data, feature or voting).
    init_model and keep_training_booster wait (ROADMAP A14)."""
    from ..callback import CallbackEnv, EarlyStopException, log_evaluation
    from ..engine import (_GP_TRAIN_METRICS, _METRIC_ALIASES, _RANK_METRICS,
                          _VAR_METRICS, _metric_fn, _var_metric_fn,
                          metric_higher_better)
    if keep_training_booster:
        raise NotImplementedError("keep_training_booster is not ported yet "
                                  "(ROADMAP A14)")
    raw = dict(params or {})
    nbr = num_boost_round
    for k in list(raw):
        if _PARAM_ALIASES.get(k, k) == "num_boost_round":
            nbr = int(raw.pop(k))
    booster = Booster(params=raw, train_set=train_set, gp_model=gp_model,
                      device=device, init_model=init_model)

    vsets = []
    if valid_sets is not None:
        vsets = valid_sets if isinstance(valid_sets, (list, tuple)) \
            else [valid_sets]
        vsets = [v for v in vsets if v is not train_set]
    names = valid_names or [f"valid_{i}" for i in range(len(vsets))]
    chosen = raw.get("metric")
    if isinstance(chosen, (list, tuple)):
        chosen = chosen[0] if chosen else None
    if chosen is None and booster.objective_name in _RANK_OBJECTIVES:
        chosen = "ndcg"
    chosen_canon = _METRIC_ALIASES.get(chosen, chosen) if chosen else None
    if vsets and chosen_canon in _GP_TRAIN_METRICS and gp_model is None:
        raise ValueError(f"metric '{chosen}' requires a gp_model")
    # each validation set's running raw score, advanced once a round
    scores = [_RunningScore(booster, v.data) for v in vsets]

    def _rank_metric(v, F_raw):
        """ndcg@k or map@k of a validation set with query information
        (rank_metric.hpp, map_metric.hpp; gbdt.py:2484-2500), reported at
        the first of eval_at."""
        if v.group is None:
            raise ValueError(f"metric '{chosen}' requires query information "
                             "on the validation Dataset (group=...)")
        qb = query_boundaries(v.group)
        ks = np.atleast_1d(np.asarray(booster.params["eval_at"], dtype=int))
        if chosen_canon == "ndcg":
            lg = booster._label_gain if booster._label_gain is not None \
                else DEFAULT_LABEL_GAIN
            vals = ndcg_metric(v.get_label(), F_raw, qb, ks, lg)
        else:
            vals = map_metric(v.get_label(), F_raw, qb, ks)
        return f"{chosen_canon}@{int(ks[0])}", vals[int(ks[0])]

    def _metric(y, p):
        if chosen:
            return chosen, _metric_fn(chosen)(y, p)
        if booster.objective_name == "multiclass":
            return "multi_logloss", _metric_fn("multi_logloss")(y, p)
        if booster.objective_name == "gaussian":
            return "l2", float(np.mean((y - p) ** 2))
        if "bernoulli" in booster.objective_name:
            pc = np.clip(p, 1e-15, 1 - 1e-15)
            return "binary_logloss", float(-np.mean(
                y * np.log(pc) + (1 - y) * np.log(1 - pc)))
        return "rmse", float(np.sqrt(np.mean((y - p) ** 2)))

    def _var_metric(yv, F_raw, pk, use_gp):
        """test_neg_log_likelihood / crps_gaussian of one set
        (regression_metric.hpp:373-494; gbdt.py:2514-2543)."""
        if use_gp:
            if gp_model.likelihood == "gaussian":
                pred = booster._predict_output(F_raw, predict_var=True, **pk)
                return _var_metric_fn(chosen_canon)(
                    yv, pred["response_mean"], pred["response_var"])
            # non-Gaussian: adaptive Gauss-Hermite log predictive density
            # over the latent predictive distribution (likelihoods.h:10157)
            if chosen_canon == "crps_gaussian":
                raise ValueError("crps_gaussian requires a Gaussian "
                                 "likelihood")
            pred = booster._predict_output(F_raw, pred_latent=True,
                                           predict_var=True, **pk)
            return float(gp_model._likelihood_obj.test_neg_log_likelihood(
                yv, pred["fixed_effect"] + pred["random_effect_mean"],
                pred["random_effect_var"], gp_model._fit_result.aux_pars))
        # no GP model (or not used): a plug-in Gaussian with the training
        # residuals' variance (regression_metric.hpp:473-480)
        return _var_metric_fn(chosen_canon)(yv, F_raw,
                                            booster._train_resid_var())

    maximize = metric_higher_better(chosen) if chosen else False
    maximize_feval = None       # feval's direction, from its first value
    cbs = list(callbacks or [])
    if verbose_eval is True or (not isinstance(verbose_eval, bool)
                                and int(verbose_eval) > 0):
        cbs.append(log_evaluation(1 if verbose_eval is True
                                  else int(verbose_eval)))
    cbs = sorted(cbs, key=lambda c: getattr(c, "order", 0))
    cbs_before = [c for c in cbs if getattr(c, "before_iteration", False)]
    cbs_after = [c for c in cbs if not getattr(c, "before_iteration", False)]
    best_score = -np.inf if maximize else np.inf
    best_iter = -1
    rounds_no_improve = 0
    if evals_result is not None:
        for nm in names:
            evals_result.setdefault(nm, {})
    for it in range(nbr):
        for cb in cbs_before:
            cb(CallbackEnv(model=booster, params=booster.params, iteration=it,
                           begin_iteration=0, end_iteration=nbr,
                           evaluation_result_list=[]))
        booster.update()
        eval_list = []
        if vsets:
            for v, nm, sc in zip(vsets, names, scores):
                pk = dict(getattr(v, "gp_valid_data", None) or {})
                use_gp = (gp_model is not None
                          and booster.params["use_gp_model_for_validation"]
                          and bool(pk))
                yv = v.get_label()
                if chosen_canon in _GP_TRAIN_METRICS:
                    mname = chosen
                    score = float(gp_model._fit_result.neg_log_likelihood)
                elif chosen_canon in _VAR_METRICS:
                    mname = chosen
                    score = _var_metric(yv, sc.advance(booster), pk, use_gp)
                elif feval is not None:
                    mname, score, hib = feval(booster._point_prediction(
                        sc.advance(booster), ignore_gp_model=not use_gp,
                        **pk), v)
                    if maximize_feval is None:
                        maximize_feval = bool(hib)
                        maximize = maximize_feval
                        best_score = -np.inf if maximize else np.inf
                elif chosen_canon in _RANK_METRICS:
                    mname, score = _rank_metric(v, sc.advance(booster))
                else:
                    mname, score = _metric(yv, booster._point_prediction(
                        sc.advance(booster), ignore_gp_model=not use_gp,
                        **pk))
                if evals_result is not None:
                    evals_result[nm].setdefault(mname, []).append(score)
                eval_list.append((nm, mname, score, maximize))
                if nm == names[0]:
                    improved = (score > best_score + 1e-15) if maximize \
                        else (score < best_score - 1e-15)
                    if improved:
                        best_score = score
                        best_iter = it + 1
                        rounds_no_improve = 0
                    else:
                        rounds_no_improve += 1
            if early_stopping_rounds \
                    and rounds_no_improve >= early_stopping_rounds:
                break
        if cbs_after:
            try:
                for cb in cbs_after:
                    cb(CallbackEnv(model=booster, params=booster.params,
                                   iteration=it, begin_iteration=0,
                                   end_iteration=nbr,
                                   evaluation_result_list=eval_list))
            except EarlyStopException as e:
                booster.best_iteration = e.best_iteration + 1
                booster.best_score = best_score if vsets else None
                return booster
    booster.best_iteration = best_iter if vsets else -1
    booster.best_score = best_score if vsets else None
    return booster
