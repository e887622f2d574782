"""The tree learner's data and split breadth in the PyTorch port against
the JAX package: missing values, categorical splits, EFB bundles,
monotone and interaction constraints, path smoothing, forced splits and
the three CEGB penalties, with pred_leaf and pred_contrib.

Each case runs the same seeded numpy data through `gpboost_tpu.train`
(its host loop, on the CPU) and the port's `train(..., device="cpu")`
(the plain histogram version): n = 400, 8 leaves, 3 rounds. The trees
split alike (feature, bin, missing direction, categorical bit set, the
recorded threshold), leaf values and predictions agree to 1e-6 (float32
histogram sums in another order), pred_leaf is equal and pred_contrib
agrees to 1e-6. Model dicts with EFB bundles and with categorical splits
load in the other package and predict the same, and one grouped-GPBoost
round with categorical and NaN columns matches `gpb.train`.

Extra trees cannot match jax.random: its thresholds come from a CPU
torch.Generator, and it is held to the JAX package's property tests
(tests/test_boosting_breadth.py TestExtraTrees).
"""

import json

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.convert import booster_from_jax_dict

torch.set_num_threads(1)

N, ROUNDS = 400, 3
BASE = {"objective": "regression", "num_leaves": 8, "learning_rate": 0.3,
        "verbose": 0}
# the categorical search's thresholds cut to n = 400
CAT = {"min_data_per_group": 10, "cat_smooth": 2.0, "max_cat_threshold": 4}


def _data(seed=0, n=N, sparse=0, sparse_bins=None):
    """Mixed columns: 0 categorical (9 levels, one rare), 1 numeric with
    20 % NaN (missing rows shifted down, so they go left), 2 dense
    numeric, 3 dense with 15 % NaN (shifted up, so they go right; the
    values rise with the column, so no split that moves the lowest bin
    beside the missing rows comes close), 4 numeric with
    30 % zeros; then `sparse` columns of
    which each row has at most one non-zero (an EFB bundle), with
    `sparse_bins` distinct values each."""
    rng = np.random.RandomState(seed)
    cat = rng.choice(9, n, p=[.2, .15, .15, .1, .1, .1, .1, .07, .03])
    x1 = rng.randn(n)
    miss = rng.rand(n) < 0.2
    x1[miss] = np.nan
    dense = rng.rand(n, 2)
    miss3 = rng.rand(n) < 0.15
    x4 = np.where(rng.rand(n) < 0.3, 0.0, rng.rand(n))
    y = (np.array([0., 1, -1, 2, .5, -.5, 1.5, -2, 3])[cat]
         + np.where(miss, -2.0, np.tanh(np.nan_to_num(x1)))
         + 2 * dense[:, 0]
         + np.where(miss3, 2.0, 1.5 * dense[:, 1]) + x4)
    dense[miss3, 1] = np.nan
    cols = [cat.astype(float), x1, dense, x4]
    if sparse:
        sp = np.zeros((n, sparse))
        who = rng.randint(0, sparse + 2, n)
        for j in range(sparse):
            rows = who == j
            vals = rng.rand(rows.sum()) + 0.5
            if sparse_bins:
                vals = np.floor(vals * sparse_bins) + 1.0
            sp[rows, j] = vals
            y = y + 1.5 * (j % 3 - 1) * (sp[:, j] > 0)
        cols.append(sp)
    y = y + 0.2 * rng.randn(n)
    return np.column_stack(cols), y


def _pair(params, X, y, ds_params=None, categorical=(0,), rounds=ROUNDS):
    kw = dict(categorical_feature=list(categorical),
              params=dict(ds_params or {}))
    bj = gpb.train(dict(params), gpb.Dataset(X, label=y, **kw),
                   num_boost_round=rounds, callbacks=[lambda env: None])
    bp = gpt.train(dict(params), gpt.Dataset(X, label=y, **kw),
                   num_boost_round=rounds, device="cpu")
    return bj, bp


def _missing_reached(tree, bins):
    """(nodes,) bool: whether a training row whose split value is missing
    reaches the node. Where none does, the two missing directions split
    the rows alike and tie: their gains differ by the rounding residue of
    a histogram subtraction in the missing bin, another one in each
    package, and the direction changes nothing in training."""
    out = np.zeros(tree.num_nodes, dtype=bool)
    stack = [(0, np.arange(len(bins)))]
    while stack:
        i, rows = stack.pop()
        if tree.is_leaf[i]:
            continue
        b = bins[rows, tree.split_feature[i]]
        mb = tree.missing_bin[i]
        is_m = (mb >= 0) & (b == mb)
        out[i] = bool(is_m.any())
        go_left = np.where(is_m, tree.default_left[i],
                           b <= tree.threshold_bin[i])
        lb = tree.cat_left_bins.get(i)
        if lb is not None:
            go_left = lb[np.clip(b, 0, len(lb) - 1)]
        stack += [(tree.left[i], rows[go_left]),
                  (tree.right[i], rows[~go_left])]
    return out


def _assert_same_trees(bj, bp):
    assert len(bj.trees) == len(bp.trees)
    bins = bp.learner.bins_pos.numpy().astype(np.int64)
    for tj, tp in zip(bj.trees, bp.trees):
        nn = tj.num_nodes
        assert tp.num_nodes == nn
        for attr in ("split_feature", "threshold_bin", "missing_bin",
                     "left", "right", "is_leaf"):
            np.testing.assert_array_equal(getattr(tp, attr)[:nn],
                                          getattr(tj, attr)[:nn],
                                          err_msg=attr)
        reached = _missing_reached(tp, bins)
        np.testing.assert_array_equal(tp.default_left[:nn][reached],
                                      tj.default_left[:nn][reached])
        np.testing.assert_array_equal(tp.threshold_real[:nn],
                                      tj.threshold_real[:nn])
        assert sorted(tp.cat_left_bins) == sorted(tj.cat_left_bins)
        for k, v in tj.cat_left_bins.items():
            np.testing.assert_array_equal(tp.cat_left_bins[k], v)
            np.testing.assert_array_equal(tp.cat_left_values[k],
                                          tj.cat_left_values[k])
        np.testing.assert_array_equal(tp.cover[:nn], tj.cover[:nn])
        np.testing.assert_allclose(tp.leaf_value[:nn], tj.leaf_value[:nn],
                                   rtol=0, atol=1e-6)


def _assert_same_predictions(bj, bp, X, leaf=True, contrib=True):
    np.testing.assert_allclose(bp.predict(X), np.asarray(bj.predict(X)),
                               rtol=0, atol=1e-6)
    if leaf:
        np.testing.assert_array_equal(bp.predict(X, pred_leaf=True),
                                      bj.predict(X, pred_leaf=True))
    if contrib:
        pc = bp.predict(X, pred_contrib=True)
        np.testing.assert_allclose(pc, bj.predict(X, pred_contrib=True),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(pc.sum(1), bp.predict(X, raw_score=True),
                                   rtol=0, atol=1e-9)


def _directions(b):
    """The missing directions the trees chose on their NaN splits."""
    return {bool(t.default_left[i]) for t in b.trees
            for i in range(t.num_nodes)
            if not t.is_leaf[i] and t.missing_bin[i] >= 0}


# ---------------------------------------------------------------------
# one JAX model per option group
CASES = {
    "missing": ({}, {}),
    "no_missing": ({"use_missing": False}, {}),
    "zero_as_missing": ({"zero_as_missing": True}, {}),
    "categorical": (CAT, {}),
    "monotone": ({"monotone_constraints": [0, 1, 1, -1, 0]}, {}),
    "path_smooth": ({"path_smooth": 5.0}, {}),
    "interaction": ({"interaction_constraints": [[0, 2], [1, 3, 4]]}, {}),
    "cegb": ({"cegb_penalty_split": 0.002, "cegb_tradeoff": 0.5,
              "cegb_penalty_feature_coupled": [0.0, 5.0, 0.0, 1.0, 0.0],
              "cegb_penalty_feature_lazy": [0.0, 0.0, 0.02, 0.0, 0.01]},
             {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_option_matches_jax(case):
    extra, ds_params = CASES[case]
    X, y = _data(seed=1)
    categorical = (0,) if case == "categorical" else ()
    bj, bp = _pair({**BASE, **extra}, X, y, ds_params, categorical)
    _assert_same_trees(bj, bp)
    _assert_same_predictions(bj, bp, X, contrib=case != "categorical")
    if case == "missing":
        assert _directions(bp) == {False, True}
    if case == "categorical":
        assert any(t.cat_left_bins for t in bp.trees)
        pc = bp.predict(X, pred_contrib=True)
        np.testing.assert_allclose(pc.sum(1), bp.predict(X, raw_score=True),
                                   rtol=0, atol=1e-9)
    if case == "interaction":
        for t in bp.trees:
            used = {int(f) for f in t.split_feature[:t.num_nodes][
                ~t.is_leaf[:t.num_nodes]]}
            assert used <= {0, 2} or used <= {1, 3, 4}


def test_forced_splits_match_jax(tmp_path):
    X, y = _data(seed=2)
    path = tmp_path / "forced.json"
    path.write_text(json.dumps({"feature": 3, "threshold": 0.4,
                                "left": {"feature": 2, "threshold": 0.7}}))
    bj, bp = _pair({**BASE, "forcedsplits_filename": str(path)}, X, y,
                   categorical=())
    _assert_same_trees(bj, bp)
    _assert_same_predictions(bj, bp, X)
    for t in bp.trees:
        assert t.split_feature[0] == 3 and t.split_feature[t.left[0]] == 2
    np.testing.assert_allclose(
        [t.split_gain[0] for t in bp.trees],
        [t.split_gain[0] for t in bj.trees], rtol=1e-5)


@pytest.mark.parametrize("sparse_bins", [8, None],
                         ids=["efb_uint8", "efb_int32"])
def test_efb_matches_jax(sparse_bins):
    """EFB: 8 exclusive sparse columns bundle into one column; with 8
    values each the bundle holds fewer than 256 bins, with continuous
    values more, and the learner's bins are int32. Predictions re-encode the rows into the bundle's
    bins; pred_contrib decodes the bundle's share to the active member.
    The JAX package reads a tree's leaf index from the raw columns even
    when its splits index the bundled ones, so pred_leaf is held to its
    trees read through the bundle encoder, as its predict reads them.
    Its pred_contrib reads a kept feature's missing bin as a number under
    EFB, not by the split's default direction, so the rows with a missing
    value are held to the port's own prediction alone."""
    X, y = _data(seed=3, sparse=8, sparse_bins=sparse_bins)
    bj, bp = _pair({**BASE, "min_data_in_leaf": 5}, X, y,
                   {"enable_bundle": True, "min_data_in_bin": 1},
                   categorical=())
    assert len(bp.train_set.bundles) == 1
    big = sparse_bins is None
    assert (bp.train_set.num_bins > 256) == big
    assert bp.learner.bins_pos.dtype == (torch.int32 if big
                                         else torch.uint8)
    assert any(f == len(bp.train_set.kept_features)
               for t in bp.trees
               for f in t.split_feature[:t.num_nodes][
                   ~t.is_leaf[:t.num_nodes]])
    _assert_same_trees(bj, bp)
    _assert_same_predictions(bj, bp, X, leaf=False, contrib=False)
    pc = bp.predict(X, pred_contrib=True)
    np.testing.assert_allclose(pc.sum(1), bp.predict(X, raw_score=True),
                               rtol=0, atol=1e-9)
    whole = np.isfinite(X).all(axis=1)
    assert 100 < whole.sum() < N
    np.testing.assert_allclose(pc[whole],
                               bj.predict(X, pred_contrib=True)[whole],
                               rtol=0, atol=1e-6)
    enc = bj.train_set.encode_raw(X)
    np.testing.assert_array_equal(
        bp.predict(X, pred_leaf=True),
        np.stack([t.leaf_index_binned(enc) for t in bj.trees], axis=1))


def test_efb_model_dicts_both_ways():
    """The JAX package's efb dict does not say which kept features have a
    missing bin: the port reads that from the trees' missing bins, while
    the JAX package's loader bins a missing value of a kept feature as a
    number, so the port's dict is held to it on the rows without one."""
    X, y = _data(seed=3, sparse=8)
    bj, bp = _pair({**BASE, "min_data_in_leaf": 5}, X, y,
                   {"enable_bundle": True, "min_data_in_bin": 1},
                   categorical=())
    dj = json.loads(json.dumps(bj.model_to_dict()))
    dp = json.loads(json.dumps(bp.model_to_dict()))
    assert "efb" in dj and "efb" in dp
    from_j, _ = booster_from_jax_dict(dj, device="cpu")
    from_p = gpb.Booster(model_dict=dp)
    ref = np.asarray(bj.predict(X))
    np.testing.assert_allclose(from_j.predict(X), ref, rtol=0, atol=1e-6)
    whole = np.isfinite(X).all(axis=1)
    assert 100 < whole.sum() < N
    np.testing.assert_allclose(np.asarray(from_p.predict(X[whole])),
                               bp.predict(X[whole]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(from_j.predict(X, pred_contrib=True),
                               bp.predict(X, pred_contrib=True), rtol=0,
                               atol=1e-6)


def test_categorical_model_dicts_and_pandas_both_ways():
    pd = pytest.importorskip("pandas")
    X, y = _data(seed=4)
    levels = np.array(list("abcdefghi"))
    df = pd.DataFrame({"c": pd.Categorical(levels[X[:, 0].astype(int)]),
                       **{f"x{j}": X[:, j] for j in range(1, 5)}})
    params = {**BASE, **CAT}
    bj = gpb.train(dict(params), gpb.Dataset(df, label=y),
                   num_boost_round=ROUNDS, callbacks=[lambda env: None])
    bp = gpt.train(dict(params), gpt.Dataset(df, label=y),
                   num_boost_round=ROUNDS, device="cpu")
    _assert_same_trees(bj, bp)
    assert any(t.cat_left_bins for t in bp.trees)
    dj = json.loads(json.dumps(bj.model_to_dict()))
    dp = json.loads(json.dumps(bp.model_to_dict()))
    assert dp["pandas_categorical"] == dj["pandas_categorical"]
    from_j, _ = booster_from_jax_dict(dj, device="cpu")
    from_p = gpb.Booster(model_dict=dp)
    # a frame with its rows shuffled and the categories in another order
    df2 = df.sample(frac=1.0, random_state=0)
    df2["c"] = df2["c"].cat.reorder_categories(list("ihgfedcba"))
    ref = np.asarray(bj.predict(df2))
    np.testing.assert_allclose(bp.predict(df2), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(from_j.predict(df2), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(from_p.predict(df2)),
                               bp.predict(df2), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(from_j.predict(df2, pred_leaf=True),
                                  bj.predict(df2, pred_leaf=True))


def test_grouped_gpboost_round_with_categorical_and_nan():
    """One GPBoost round with grouped random effects on the mixed columns
    (the learner is the plain booster's): trees, covariance parameters
    and predictions against gpb.train's host loop."""
    X, y = _data(seed=5)
    group = np.random.RandomState(5).randint(0, 20, N)
    y = y + 0.8 * np.random.RandomState(6).randn(20)[group]
    params = {**BASE, **CAT}
    gj = gpb.GPModel(group_data=group)
    bj = gpb.train(dict(params), gpb.Dataset(X, label=y,
                                             categorical_feature=[0]),
                   num_boost_round=1, gp_model=gj,
                   callbacks=[lambda env: None])
    gp = gpt.GPModel(group_data=group, device="cpu")
    bp = gpt.train(dict(params), gpt.Dataset(X, label=y,
                                             categorical_feature=[0]),
                   num_boost_round=1, gp_model=gp)
    _assert_same_trees(bj, bp)
    np.testing.assert_allclose(gp.get_cov_pars(),
                               np.asarray(gj.get_cov_pars()), rtol=1e-5)
    gnew = np.arange(25) % 22
    pj = bj.predict(X[:25], group_data_pred=gnew)
    pp = bp.predict(X[:25], group_data_pred=gnew)
    for k in ("fixed_effect", "random_effect_mean"):
        np.testing.assert_allclose(pp[k], np.asarray(pj[k]), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------
# extra trees: the JAX package's property tests on the port
def test_extra_trees_learns_but_differs_from_exact_search():
    rng = np.random.RandomState(21)
    n = 2000
    X = rng.rand(n, 5)
    y = 2 * X[:, 0] + np.sin(5 * X[:, 1]) + 0.2 * rng.randn(n)
    params = {"objective": "regression", "num_leaves": 15,
              "learning_rate": 0.2, "verbose": 0}
    b0 = gpt.train(dict(params), gpt.Dataset(X, label=y),
                   num_boost_round=20, device="cpu")
    b1 = gpt.train(dict(params, extra_trees=True), gpt.Dataset(X, label=y),
                   num_boost_round=20, device="cpu")
    p0, p1 = b0.predict(X[:500]), b1.predict(X[:500])
    assert np.max(np.abs(p0 - p1)) > 1e-6
    assert 1 - np.var(y[:500] - p1) / np.var(y[:500]) > 0.7


def test_extra_trees_deterministic_given_seed():
    rng = np.random.RandomState(22)
    X = rng.rand(800, 4)
    y = X[:, 0] + 0.1 * rng.randn(800)
    params = {"objective": "regression", "num_leaves": 7, "verbose": 0,
              "extra_trees": True, "extra_seed": 11}

    def fit(**kw):
        return gpt.train(dict(params, **kw), gpt.Dataset(X, label=y),
                         num_boost_round=4, device="cpu").predict(X[:100])

    p1 = fit()
    np.testing.assert_array_equal(p1, fit())
    assert np.max(np.abs(p1 - fit(extra_seed=12))) > 1e-9
