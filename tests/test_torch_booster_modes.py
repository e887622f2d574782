"""The booster's modes in the PyTorch port against the JAX package: DART,
GOSS, random forests, multiclass, mean_scale_regression, Grabit (tobit),
lambdarank and rank_xendcg with ndcg and map, linear trees and refit.

* Against `gpboost_tpu.train`'s host loop (on the CPU) at n = 400, 8
  leaves, 3 rounds, with seeded numpy data: every tree splits alike
  (feature, bin, shape), leaf values, linear-leaf slopes, the training
  score and predictions agree to 1e-6 (float32 histogram sums in another
  order), DART's drop sets and the GOSS / bagging row masks are equal, and
  each model's dict loads in the other package and predicts the same to
  1e-10. DART, GOSS and linear leaves also run inside grouped-random-effects
  GPBoost (covariance parameters to 1e-6 relative). refit agrees to 1e-6.
* The device ranking gradients (`QueryLayout`) against the numpy copies
  to 1e-12, with ties, one-document and all-zero queries.
* The A12b cases of test_boosting.py (TestDartGoss, TestRandomForest),
  test_boosting_breadth.py (TestMulticlass, TestLinearTree, TestRefit, the
  multiclass cases of TestPredEarlyStop and TestPredictionAndInitOptions),
  test_ranking.py (all but the sklearn ranker, which waits for the sklearn
  wrappers) and test_grabit_meanscale.py run on the port through their own
  test bodies, at their own tolerances and sizes.

GOSS orders the rows by |grad hess| with np.argsort, which is not stable:
on data with tied products the two packages may order tied rows otherwise
and so sample other rows. The data here has no ties.
"""

import copy
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
from gpboost_tpu.boosting import ranking as jrank

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting import gbdt as tgbdt
from gpboost_tpu_torch.boosting import ranking as trank
from gpboost_tpu_torch.convert import booster_from_jax_dict

sys.path.insert(0, os.path.dirname(__file__))
import test_boosting as gboost  # noqa: E402
import test_boosting_breadth as gbreadth  # noqa: E402
import test_grabit_meanscale as ggrabit  # noqa: E402
import test_ranking as grank  # noqa: E402
from test_boosting import reg_data  # noqa: E402,F401
from test_grabit_meanscale import grabit_data  # noqa: E402,F401

torch.set_num_threads(1)

N, ROUNDS = 400, 3
BASE = {"num_leaves": 8, "learning_rate": 0.3, "min_data_in_leaf": 5,
        "verbose": 0}


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 5)
    y = 2 * X[:, 0] + np.sin(4 * X[:, 1]) + 0.3 * rng.randn(n)
    cls = np.argmax(X[:, :3] + 0.2 * rng.randn(n, 3), 1).astype(float)
    rel = np.clip(np.floor(y - y.min()), 0, 4)
    return X, y, cls, rel


X, Y, CLS, REL = _data()
GROUP = np.full(20, 20)
# a grouped random intercept for GPBoost
GP_GROUP = np.random.RandomState(3).randint(0, 20, N)
YG = Y + 0.5 * np.random.RandomState(4).randn(20)[GP_GROUP]
# (params, label, Dataset keywords)
MODES = {
    "dart": ({"boosting": "dart", "drop_rate": 0.8, "skip_drop": 0.0}, Y, {}),
    "goss": ({"boosting": "goss", "learning_rate": 0.5, "top_rate": 0.3,
              "other_rate": 0.2}, Y, {}),
    "rf": ({"boosting": "rf", "bagging_fraction": 0.6, "bagging_freq": 1,
            "feature_fraction": 0.8}, Y, {}),
    "linear_tree": ({"linear_tree": True, "linear_lambda": 0.1}, Y, {}),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, CLS, {}),
    "mean_scale": ({"objective": "mean_scale_regression"}, Y, {}),
    "tobit": ({"objective": "tobit", "yl": 0.5, "yu": 2.0, "sigma": 0.8},
              Y, {}),
    "lambdarank": ({"objective": "lambdarank", "lambdarank_truncation_level":
                    5}, REL, {"group": GROUP}),
    "rank_xendcg": ({"objective": "rank_xendcg", "objective_seed": 3}, REL,
                    {"group": GROUP}),
}


def _recorded(monkeypatch, cls, name, log):
    """Wrap cls.name so that each call's return lands in log."""
    fn = getattr(cls, name)

    def wrapped(self, *a, **k):
        out = fn(self, *a, **k)
        log.append(out)
        return out
    monkeypatch.setattr(cls, name, wrapped)


def _pair(params, y, ds_kw=None, gp=False, rounds=ROUNDS):
    ds_kw = ds_kw or {}
    kj, kp = {}, {}
    if gp:
        kj["gp_model"] = gpb.GPModel(group_data=GP_GROUP)
        kp["gp_model"] = gpt.GPModel(group_data=GP_GROUP, device="cpu")
    bj = gpb.train({**BASE, **params}, gpb.Dataset(X, label=y, **ds_kw),
                   num_boost_round=rounds, callbacks=[lambda env: None],
                   **kj)
    bp = gpt.train({**BASE, **params}, gpt.Dataset(X, label=y, **ds_kw),
                   num_boost_round=rounds, device="cpu", **kp)
    return bj, bp


def _assert_same_trees(bj, bp):
    """Equal splits; leaf values and slopes to 1e-6 (float32 histogram
    sums in another order)."""
    assert len(bj.trees) == len(bp.trees)
    for tj, tp in zip(bj.trees, bp.trees):
        nn = tj.num_nodes
        assert tp.num_nodes == nn
        for attr in ("split_feature", "threshold_bin", "left", "right",
                     "is_leaf"):
            np.testing.assert_array_equal(getattr(tp, attr)[:nn],
                                          getattr(tj, attr)[:nn],
                                          err_msg=attr)
        np.testing.assert_allclose(tp.leaf_value[:nn], tj.leaf_value[:nn],
                                   rtol=0, atol=1e-6)
        assert tp.shrinkage_applied == pytest.approx(tj.shrinkage_applied,
                                                     rel=1e-12)
        assert sorted(tp.leaf_linear) == sorted(tj.leaf_linear)
        for k, (f, c) in tj.leaf_linear.items():
            np.testing.assert_array_equal(tp.leaf_linear[k][0], f)
            np.testing.assert_allclose(tp.leaf_linear[k][1], c, rtol=0,
                                       atol=1e-6)


def _close(a, b, atol):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol,
                                       err_msg=k)
    else:
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_against_jax(mode, monkeypatch):
    params, y, ds_kw = MODES[mode]
    drops_j, drops_p, masks_j, masks_p = [], [], [], []
    _recorded(monkeypatch, gpb.Booster, "_dart_drop", drops_j)
    _recorded(monkeypatch, gpb.Booster, "_goss_mask", masks_j)
    _recorded(monkeypatch, gpb.Booster, "_sampling_masks", masks_j)
    _recorded(monkeypatch, tgbdt.Booster, "_dart_drop", drops_p)
    _recorded(monkeypatch, tgbdt.Booster, "_goss_mask", masks_p)
    _recorded(monkeypatch, tgbdt.Booster, "_sampling_masks", masks_p)
    bj, bp = _pair(params, y, ds_kw)
    _assert_same_trees(bj, bp)
    np.testing.assert_allclose(bp.F.numpy(), np.asarray(bj.F), rtol=0,
                               atol=1e-6)
    # DART's drop sets and the sampled rows (bagging, GOSS) are equal
    assert [d[0] for d in drops_p] == [d[0] for d in drops_j]
    assert len(masks_p) == len(masks_j)
    for mp, mj in zip(masks_p, masks_j):
        for a, b in (zip(mp, mj) if isinstance(mj, tuple) else [(mp, mj)]):
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if mode == "dart":
        assert any(d[0] for d in drops_p)
    if mode == "goss":
        assert any(m is not None for m in masks_p[-1:])
    Xn = np.random.RandomState(7).rand(50, 5)
    for kw in ({}, {"raw_score": True}, {"num_iteration": 2}):
        _close(bp.predict(Xn, **kw), bj.predict(Xn, **kw), 1e-6)
    if mode == "multiclass":
        P = bp.predict(Xn)
        assert P.shape == (50, 3)
        np.testing.assert_allclose(P.sum(1), 1.0, rtol=1e-12)
    # pred_contrib rows sum to the raw score, block by block
    if mode not in ("linear_tree", "mean_scale"):
        c = bp.predict(Xn, pred_contrib=True)
        K = bp._nsets
        raw = bp.predict(Xn, raw_score=True).reshape(len(Xn), K) \
            if K > 1 else bp.predict(Xn, raw_score=True)
        np.testing.assert_allclose(c.reshape(len(Xn), K, -1).sum(2).squeeze(),
                                   raw, rtol=0, atol=1e-10)
    # model dicts both ways
    for d in (bp.model_to_dict(), bj.model_to_dict()):
        d = json.loads(json.dumps(d))
        bl, _ = booster_from_jax_dict(d, device="cpu")
        _close(bl.predict(Xn), bj.predict(Xn), 1e-6)
        _close(gpb.Booster(model_dict=d).predict(Xn), bp.predict(Xn), 1e-6)
        _close(bl.predict(Xn), gpb.Booster(model_dict=d).predict(Xn), 1e-10)


def test_dart_valid_set_against_jax():
    """DART rescales the dropped trees after each round: the validation
    scores, early stopping and best_iteration see the rescaled trees, as
    the JAX package's per-round predict does (l2 to 1e-6)."""
    params = {**BASE, **MODES["dart"][0], "metric": "l2"}
    Xv, yv, _, _ = _data(seed=5, n=200)
    out = []
    for pkg, kw in ((gpb, {"callbacks": [lambda env: None]}),
                    (gpt, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=Y)
        ev = {}
        bst = pkg.train(params, ds, num_boost_round=8,
                        valid_sets=[pkg.Dataset(Xv, label=yv, reference=ds)],
                        evals_result=ev, early_stopping_rounds=3, **kw)
        out.append((ev, bst.best_iteration))
    (ej, itj), (ep, itp) = out
    assert itp == itj
    np.testing.assert_allclose(ep["valid_0"]["l2"], ej["valid_0"]["l2"],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["dart", "goss", "linear_tree"])
def test_mode_in_grouped_gpboost(mode):
    params = {**MODES[mode][0], "learning_rate": 0.5}
    bj, bp = _pair(params, YG, gp=True)
    _assert_same_trees(bj, bp)
    np.testing.assert_allclose(bp.F.numpy(), np.asarray(bj.F), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(bp.gp_model.get_cov_pars(),
                               np.asarray(bj.gp_model.get_cov_pars()),
                               rtol=1e-6)
    Xn = np.random.RandomState(8).rand(20, 5)
    gn = np.arange(20) + 10
    pj = bj.predict(Xn, group_data_pred=gn, predict_var=True)
    pp = bp.predict(Xn, group_data_pred=gn, predict_var=True)
    for k in ("fixed_effect", "response_mean", "response_var"):
        np.testing.assert_allclose(pp[k], pj[k], rtol=0, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_refit_against_jax(objective):
    y = Y if objective == "regression" else (Y > np.median(Y)).astype(float)
    bj, bp = _pair({"objective": objective}, y)
    rng = np.random.RandomState(9)
    X2 = rng.rand(300, 5)
    y2 = -X2[:, 0] + 0.1 * rng.randn(300)
    if objective == "binary":
        y2 = (y2 > np.median(y2)).astype(float)
    rj = bj.refit(X2, y2, decay_rate=0.3)
    rp = bp.refit(X2, y2, decay_rate=0.3)
    for tj, tp in zip(rj.trees, rp.trees):
        np.testing.assert_allclose(tp.leaf_value[:tp.num_nodes],
                                   tj.leaf_value[:tj.num_nodes], rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(rp.F.numpy(), np.asarray(rj.F), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(rp.predict(X2), rj.predict(X2), rtol=0,
                               atol=1e-6)
    # the booster refitted from stays as it was
    np.testing.assert_array_equal(bp.predict(X2), gpt.Booster(
        model_dict=bp.model_to_dict(), device="cpu").predict(X2))
    with pytest.raises(NotImplementedError, match="multi-output"):
        _pair(MODES["multiclass"][0], CLS, rounds=1)[1].refit(X2, CLS[:300])


def _rank_cases():
    rng = np.random.RandomState(11)
    lens = rng.randint(1, 40, 25)
    lens[:3] = (1, 2, 35)
    n = int(lens.sum())
    y = rng.randint(0, 5, n)
    y[1:3] = 0                  # a query with no relevant document
    scores = rng.randn(n)
    tied = np.round(scores, 1)  # ties within queries
    return lens, y, scores, tied


@pytest.mark.parametrize("trunc,norm,sigmoid,tie", [
    (30, True, 1.0, False), (5, True, 1.7, True), (1, False, 0.5, False),
    (3, False, 2.0, True)])
def test_ranking_gradients_against_numpy(trunc, norm, sigmoid, tie):
    lens, y, scores, tied = _rank_cases()
    s = tied if tie else scores
    qb = trank.query_boundaries(lens)
    lay = trank.QueryLayout(qb, y, "cpu", truncation_level=trunc,
                            xendcg_seed=5)
    g, h = lay.lambdarank(torch.as_tensor(s), sigmoid=sigmoid, norm=norm)
    gn, hn = trank.lambdarank_gradients(y, s, qb, sigmoid=sigmoid, norm=norm,
                                        truncation_level=trunc)
    gj, hj = jrank.lambdarank_gradients(y, s, qb, sigmoid=sigmoid, norm=norm,
                                        truncation_level=trunc)
    np.testing.assert_array_equal(gn, gj)
    np.testing.assert_allclose(g.numpy(), gn, rtol=0, atol=1e-12)
    np.testing.assert_allclose(h.numpy(), hn, rtol=0, atol=1e-12)
    g, h = lay.xendcg(torch.as_tensor(s))
    gn, hn = trank.xendcg_gradients(y, s, qb, seed=5)
    np.testing.assert_array_equal(gn, jrank.xendcg_gradients(y, s, qb,
                                                             seed=5)[0])
    np.testing.assert_allclose(g.numpy(), gn, rtol=0, atol=1e-12)
    np.testing.assert_allclose(h.numpy(), hn, rtol=0, atol=1e-12)


def test_rank_metrics_in_train_against_jax():
    Xv, yv, _, relv = _data(seed=4, n=200)
    res = {}
    for pkg, dev in ((gpb, {"callbacks": [lambda env: None]}),
                     (gpt, {"device": "cpu"})):
        for metric in ("ndcg", "map"):
            ev = {}
            pkg.train({**BASE, "objective": "lambdarank", "metric": metric,
                       "eval_at": [3, 5]},
                      pkg.Dataset(X, label=REL, group=GROUP), 3,
                      valid_sets=[pkg.Dataset(Xv, label=relv,
                                              group=np.full(10, 20))],
                      evals_result=ev, **dev)
            res[pkg.__name__, metric] = ev["valid_0"]
    for metric in ("ndcg", "map"):
        j, p = res["gpboost_tpu", metric], res["gpboost_tpu_torch", metric]
        assert list(p) == list(j) == [f"{metric}@3"]
        np.testing.assert_allclose(p[f"{metric}@3"], j[f"{metric}@3"],
                                   rtol=1e-6)


def test_parallel_learner_modes_raise(tmp_path):
    """The modes on a parallel tree learner (a one-rank gloo group here)
    raise naming ROADMAP A15."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        for params in ({"boosting": "dart"}, {"boosting": "goss"},
                       {"linear_tree": True},
                       {"objective": "multiclass", "num_class": 3}):
            with pytest.raises(NotImplementedError, match="A15"):
                gpt.Booster({**BASE, **params, "num_parallel_devices": 1},
                            gpt.Dataset(X, label=CLS), device="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------
# the JAX package's own test bodies on the port
class _PortBooster(tgbdt.Booster):
    """The port's Booster with the JAX surface these bodies use:
    model_file and save_model as a JSON model dict."""

    def __init__(self, params=None, train_set=None, gp_model=None,
                 model_file=None, model_dict=None, **kw):
        if model_file is not None:
            with open(model_file) as f:
                model_dict = json.load(f)
        super().__init__(params=params, train_set=train_set,
                         gp_model=gp_model, model_dict=model_dict,
                         device="cpu")

    def save_model(self, filename, **kw):
        with open(filename, "w") as f:
            json.dump(self.model_to_dict(), f)
        return self

    def refit(self, *a, **k):
        out = super().refit(*a, **k)
        out.__class__ = _PortBooster
        return out


def _port_train(params, train_set, num_boost_round=100, **kw):
    bst = gpt.train(copy.deepcopy(params), train_set, num_boost_round,
                    device="cpu", **kw)
    bst.__class__ = _PortBooster
    return bst


def _port_gpmodel(*a, **k):
    return gpt.GPModel(*a, device="cpu", **k)


PORT = types.SimpleNamespace(train=_port_train, Dataset=gpt.Dataset,
                             Booster=_PortBooster, GPModel=_port_gpmodel)


def _port_grads(fn):
    """A numpy-in, numpy-out form of a QueryLayout gradient."""
    def run(labels, scores, boundaries, **kw):
        seed = kw.pop("seed", None)
        lay = trank.QueryLayout(boundaries, labels, "cpu",
                                truncation_level=kw.pop("truncation_level",
                                                        30),
                                xendcg_seed=seed)
        g, h = getattr(lay, fn)(torch.as_tensor(np.asarray(
            scores, dtype=np.float64)), **kw)
        return g.numpy(), h.numpy()
    return run


# (module, class or None, test, fixture, parameters)
BODIES = [
    (gboost, "TestDartGoss", "test_dart_fits_and_training_score_consistent",
     "reg_data", {}),
    (gboost, "TestDartGoss", "test_goss_fits", "reg_data", {}),
    (gboost, "TestDartGoss", "test_unknown_boosting_raises", "reg_data", {}),
    (gboost, "TestRandomForest", "test_rf_fits_and_averages", "reg_data", {}),
    (gboost, "TestRandomForest", "test_rf_requires_bagging", "reg_data", {}),
    (gboost, "TestRandomForest", "test_rf_rejects_gp_model", "reg_data", {}),
    (gbreadth, "TestMulticlass", "test_train_predict", "mc_data", {}),
    (gbreadth, "TestMulticlass", "test_multi_logloss_metric", "mc_data", {}),
    (gbreadth, "TestLinearTree",
     "test_linear_trees_beat_constant_leaves_on_linear_data", None, {}),
    (gbreadth, "TestLinearTree", "test_round_trip", None, {}),
    (gbreadth, "TestRefit", "test_refit_moves_toward_new_data", None, {}),
    (gbreadth, "TestRefit", "test_decay_one_is_identity", None, {}),
    (gbreadth, "TestRefit", "test_refit_same_data_improves_or_holds", None,
     {}),
    (gbreadth, "TestPredEarlyStop", "test_multiclass_early_stop_keeps_"
     "decisions", None, {}),
    (gbreadth, "TestPredictionAndInitOptions",
     "test_pred_leaf_multiclass_interleaved", None, {}),
    (gbreadth, "TestPredictionAndInitOptions",
     "test_refit_decay_rate_param", None, {}),
    (grank, None, "test_dcg_semantics", None, {}),
    (grank, None, "test_map_semantics", None, {}),
    (grank, None, "test_lambdarank_gradient_properties", None, {}),
    (grank, None, "test_xendcg_gradient_properties", None, {}),
    (grank, None, "test_rank_training_improves_ndcg", None,
     {"objective": "lambdarank"}),
    (grank, None, "test_rank_training_improves_ndcg", None,
     {"objective": "rank_xendcg"}),
    (grank, None, "test_rank_requires_group", None, {}),
    (grank, None, "test_label_gain_and_validation", None, {}),
    (grank, None, "test_map_metric_in_training", None, {}),
    (ggrabit, "TestGrabit", "test_simulation_matches_reference",
     "grabit_data", {}),
    (ggrabit, "TestGrabit", "test_tobit_without_limits_equals_l2",
     "grabit_data", {}),
    (ggrabit, "TestGrabit", "test_censored_fit_extrapolates_past_bounds",
     "grabit_data", {}),
    (ggrabit, "TestMeanScale", "test_mean_scale_regression", "grabit_data",
     {}),
    (ggrabit, "TestMeanScale", "test_raw_score_layout", "grabit_data", {}),
]


def _body_id(b):
    mod, cls, name, _, kw = b
    return ".".join([mod.__name__[5:], cls or "", name]
                    + [str(v) for v in kw.values()])


@pytest.mark.parametrize("case", BODIES, ids=[_body_id(b) for b in BODIES])
def test_jax_body_on_the_port(case, request, monkeypatch):
    mod, cls, name, fixture, kw = case
    monkeypatch.setattr(mod, "gpb", PORT)
    if mod is grank:
        for fn in ("dcg_at_k", "max_dcg_at_k", "ndcg_metric", "map_metric",
                   "query_boundaries", "DEFAULT_LABEL_GAIN"):
            monkeypatch.setattr(mod, fn, getattr(trank, fn))
        monkeypatch.setattr(mod, "lambdarank_gradients",
                            _port_grads("lambdarank"))
        monkeypatch.setattr(mod, "xendcg_gradients", _port_grads("xendcg"))
    if cls is None:
        getattr(mod, name)(**kw)
        return
    obj = getattr(mod, cls)()
    args = []
    if fixture == "mc_data":
        args.append(mod.TestMulticlass.__dict__["mc_data"].__wrapped__(obj))
    elif fixture is not None:
        args.append(request.getfixturevalue(fixture))
    getattr(obj, name)(*args, **kw)
