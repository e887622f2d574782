"""Observation weights and cluster_ids in the Gaussian engines of the
PyTorch port, and Nesterov-accelerated GPBoost, against the JAX package.

The same numpy inputs (seeded) go through both packages in float64: the
dense engine with weights and with cluster_ids (NLL, gradient, Fisher
information, prediction, training random effects), the Woodbury engine with
weights (NLL, gradient, prediction, training random effects,
Psi~^-1 M), the dense Laplace engine with cluster_ids, 3 rounds of weighted
grouped GPBoost and 5 rounds of Nesterov GPBoost (trees equal, predictions
to 1e-6), and model dicts with weights, cluster_ids and vecchia_pred_type
both ways. tests/test_weights.py's TestWeights goldens
(test_near_one_weights_reproduce_unweighted,
test_heteroscedastic_weights_fix_nugget_bias) run on the port.

The weighted Woodbury GLS and coefficient gradient are held to the numpy
closed form (X' Psi~^-1 X)^-1 X' Psi~^-1 y, not to the JAX package: its
grouped_re.py:124, :283 and :300 use the unweighted X'X, X'y and X'r beside
the weighted Z'WX and Z'Wy, which gives NaN on this test's data.
"""

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
from gpboost_tpu.boosting.gbdt import _psi_tilde_inv_mat as jax_psi_inv_mat

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.convert import gp_model_from_jax_dict

torch.set_num_threads(1)

N, Q = 120, 10
PARS_GP = np.array([0.3, 0.6, 0.25])
PARS_RE = np.array([0.3, 0.5])


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(12)
    coords = rng.rand(N, 2)
    g = rng.randint(0, Q, N)
    w = 0.5 + 2.0 * rng.rand(N)
    y = np.sin(5 * coords[:, 0]) + rng.randn(Q)[g] + 0.4 * rng.randn(N)
    X = np.column_stack([np.ones(N), rng.rand(N)])
    cid = np.repeat([1, 2, 3, 4], N // 4)
    return dict(coords=coords, g=g, w=w, y=y, X=X, cid=cid,
                cp=rng.rand(15, 2), gp=rng.randint(0, Q + 3, 15),
                cidp=np.array([1, 2, 3, 4, 5] * 3))


def _both(**kw):
    return gpb.GPModel(**kw), gpt.GPModel(**kw, device="cpu")


def _engine_parity(je, pe, pars, y, rtol=1e-10):
    """NLL and the gradient wrt u = log(transformed pars)."""
    np.testing.assert_allclose(pe.neg_log_likelihood(pars, y),
                               je.neg_log_likelihood(pars, y), rtol=rtol)
    u = np.log(je.transform_pars(pars))
    jv, jg = je.vag_full(u, y)
    pv, pg = pe.vag_full(u, pe.prep_y(y))
    np.testing.assert_allclose(pv, float(jv), rtol=rtol)
    np.testing.assert_allclose(pg, np.asarray(jg), rtol=1e-8, atol=1e-10)


def _pred_parity(jm, pm, pars, **kw):
    ref = jm.predict(cov_pars=pars, predict_cov_mat=True, **kw)
    out = pm.predict(cov_pars=pars, predict_cov_mat=True, **kw)
    np.testing.assert_allclose(out["mu"], ref["mu"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(out["cov"], ref["cov"], rtol=1e-9,
                               atol=1e-12)


def _training_re_parity(je, pe, pars, y, predict_var=True):
    mj, vj = je.training_re(pars, y, predict_var=predict_var)
    mp, vp = pe.training_re(pars, y, predict_var=predict_var)
    np.testing.assert_allclose(mp, mj, rtol=1e-9, atol=1e-12)
    if predict_var:
        np.testing.assert_allclose(vp, vj, rtol=1e-9)


def test_dense_weights_match_jax(data):
    d = data
    jm, pm = _both(gp_coords=d["coords"], cov_function="exponential",
                   weights=d["w"])
    _engine_parity(jm._engine, pm._engine, PARS_GP, d["y"])
    np.testing.assert_allclose(pm._engine.fisher_original(PARS_GP),
                               np.asarray(jm._engine.fisher_original(
                                   PARS_GP)), rtol=1e-8)
    _pred_parity(jm, pm, PARS_GP, y=d["y"], gp_coords_pred=d["cp"])
    _training_re_parity(jm._engine, pm._engine, PARS_GP, d["y"])
    t = jm._engine.transform_pars(PARS_GP)
    M = np.random.RandomState(1).randn(N, 3)
    np.testing.assert_allclose(
        pm._engine.psi_tilde_inv_mat(t, torch.as_tensor(M)).numpy(),
        jax_psi_inv_mat(jm._engine, t, M), rtol=1e-9, atol=1e-12)


def test_woodbury_weights_match_jax(data):
    d = data
    jm, pm = _both(group_data=d["g"], weights=d["w"])
    _engine_parity(jm._engine, pm._engine, PARS_RE, d["y"])
    _pred_parity(jm, pm, PARS_RE, y=d["y"], group_data_pred=d["gp"])
    _training_re_parity(jm._engine, pm._engine, PARS_RE, d["y"])
    t = jm._engine.transform_pars(PARS_RE)
    M = np.random.RandomState(1).randn(N, 3)
    np.testing.assert_allclose(
        pm._engine.psi_tilde_inv_mat(t, torch.as_tensor(M)).numpy(),
        jax_psi_inv_mat(jm._engine, t, M), rtol=1e-9, atol=1e-12)
    # the iterative branch: the same weighted NLL up to its SLQ error
    it = gpt.GPModel(group_data=d["g"], weights=d["w"], device="cpu",
                     matrix_inversion_method="iterative")
    np.testing.assert_allclose(it.neg_log_likelihood(PARS_RE, d["y"]),
                               pm.neg_log_likelihood(PARS_RE, d["y"]),
                               rtol=1e-2)


def test_woodbury_weighted_gls_matches_closed_form(data):
    """The JAX package's weighted GLS uses the unweighted X'X, X'y and X'r
    (see the module docstring); the port's is the closed form."""
    d = data
    pm = gpt.GPModel(group_data=d["g"], weights=d["w"], device="cpu")
    eng = pm._engine
    t = eng.transform_pars(PARS_RE)
    psi_t = np.diag(1.0 / d["w"]) \
        + t[1] * (d["g"][:, None] == d["g"][None, :])
    P = np.linalg.inv(psi_t)
    X, y = d["X"], d["y"]
    Xt = torch.as_tensor(X)
    np.testing.assert_allclose(
        eng.wls_coef(np.log(t[1:]), eng.prep_y(y), Xt),
        np.linalg.solve(X.T @ P @ X, X.T @ P @ y), rtol=1e-9)
    r = y - X @ np.array([0.2, -0.4])
    np.testing.assert_allclose(
        eng.coef_grad(np.log(t[1:]), t[0], eng.prep_y(r), Xt),
        -(X.T @ P @ r) / t[0], rtol=1e-9)


def test_dense_cluster_ids_match_jax(data):
    d = data
    jm, pm = _both(gp_coords=d["coords"], cov_function="exponential",
                   cluster_ids=d["cid"])
    _engine_parity(jm._engine, pm._engine, PARS_GP, d["y"])
    _pred_parity(jm, pm, PARS_GP, y=d["y"], gp_coords_pred=d["cp"],
                 cluster_ids_pred=d["cidp"])
    _training_re_parity(jm._engine, pm._engine, PARS_GP, d["y"])
    with pytest.raises(ValueError):
        pm.predict(y=d["y"], gp_coords_pred=d["cp"], cov_pars=PARS_GP)
    # a GP with grouped effects: both components masked
    jm, pm = _both(gp_coords=d["coords"], cov_function="exponential",
                   group_data=d["g"], cluster_ids=d["cid"], weights=d["w"])
    pars = np.array([0.3, 0.4, 0.6, 0.25])
    _engine_parity(jm._engine, pm._engine, pars, d["y"])
    _training_re_parity(jm._engine, pm._engine, pars, d["y"])


def test_dense_laplace_cluster_ids_match_jax(data):
    d = data
    n = 60
    yb = (d["y"][:n] > np.median(d["y"][:n])).astype(float)
    kw = dict(gp_coords=d["coords"][:n], cov_function="exponential",
              likelihood="bernoulli_probit", cluster_ids=d["cid"][:n] % 2)
    jm, pm = _both(**kw)
    pars = np.array([1.0, 0.2])
    np.testing.assert_allclose(pm.neg_log_likelihood(pars, yb),
                               jm.neg_log_likelihood(pars, yb), rtol=1e-9)
    kp = dict(y=yb, gp_coords_pred=d["cp"][:6],
              cluster_ids_pred=np.array([0, 1, 0, 1, 2, 0]), cov_pars=pars,
              predict_var=True)
    for resp in (False, True):
        ref = jm.predict(predict_response=resp, **kp)
        out = pm.predict(predict_response=resp, **kp)
        np.testing.assert_allclose(out["mu"], ref["mu"], rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(out["var"], ref["var"], rtol=1e-8)


# ---------------------------------------------------------------------
# GPBoost with a weighted GP model, and Nesterov-accelerated GPBoost
P_FEAT = 4
BOOST = {"objective": "regression", "learning_rate": 0.1, "num_leaves": 7,
         "min_data_in_leaf": 20, "verbose": 0}


def _boost_data(n=400, seed=2):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, P_FEAT)
    g = rng.randint(0, 20, n)
    y = 2 * X[:, 0] + np.sin(6 * X[:, 1]) + 0.8 * rng.randn(20)[g] \
        + 0.3 * rng.randn(n)
    return X, g, y, 0.5 + 2.0 * rng.rand(n)


def _splits(tree):
    nn = tree.num_nodes
    internal = ~tree.is_leaf[:nn]
    return (tree.is_leaf[:nn].tolist(),
            tree.split_feature[:nn][internal].tolist(),
            tree.threshold_bin[:nn][internal].tolist())


def _gpboost_parity(extra, rounds, weighted):
    X, g, y, w = _boost_data()
    kw = dict(group_data=g, weights=w if weighted else None)
    jm, pm = _both(**kw)
    bj = gpb.train({**BOOST, **extra}, gpb.Dataset(X, label=y),
                   num_boost_round=rounds, gp_model=jm,
                   callbacks=[lambda env: None])
    bp = gpt.train({**BOOST, **extra}, gpt.Dataset(X, label=y),
                   num_boost_round=rounds, gp_model=pm)
    assert [_splits(t) for t in bp.trees] == [_splits(t) for t in bj.trees]
    np.testing.assert_allclose(pm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    rng = np.random.RandomState(5)
    Xn, gn = rng.rand(30, P_FEAT), rng.randint(0, 23, 30)
    pj = bj.predict(Xn, group_data_pred=gn, predict_var=True)
    pp = bp.predict(Xn, group_data_pred=gn, predict_var=True)
    for k in ("fixed_effect", "response_mean", "response_var"):
        np.testing.assert_allclose(pp[k], pj[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    return bj, bp


def test_weighted_gpboost_matches_jax():
    _gpboost_parity({}, 3, weighted=True)


def test_nesterov_gpboost_matches_jax():
    bj, bp = _gpboost_parity({"use_nesterov_acc": True}, 5, weighted=False)
    np.testing.assert_allclose(bp.F.numpy(), bj.F, rtol=0, atol=1e-6)
    # the replay of the momentum recursion in a loaded booster
    bl, _ = gpt.convert.booster_from_jax_dict(bj.model_to_dict(),
                                              device="cpu")
    Xn = np.random.RandomState(6).rand(20, P_FEAT)
    np.testing.assert_allclose(
        bl.predict(Xn, group_data_pred=np.arange(20))["fixed_effect"],
        bj.predict(Xn, group_data_pred=np.arange(20))["fixed_effect"],
        rtol=0, atol=1e-10)
    with pytest.raises(ValueError):
        X, g, y, _ = _boost_data()
        gpt.Booster({**BOOST, "use_nesterov_acc": True, "boosting": "dart"},
                    gpt.Dataset(X, label=y),
                    gp_model=gpt.GPModel(group_data=g, device="cpu"))


# ---------------------------------------------------------------------
def test_model_dicts_with_weights_clusters_and_pred_type(data):
    d = data
    n = 60
    y = d["y"][:n]
    for kw, pkw in (
            (dict(gp_coords=d["coords"][:n], cov_function="exponential",
                  gp_approx="vecchia", num_neighbors=8, weights=d["w"][:n]),
             dict(gp_coords_pred=d["cp"])),
            (dict(gp_coords=d["coords"][:n], cov_function="exponential",
                  cluster_ids=d["cid"][:n], weights=d["w"][:n]),
             dict(gp_coords_pred=d["cp"], cluster_ids_pred=d["cidp"]))):
        jm, pm = _both(**kw)
        for m_ in (jm, pm):
            m_.fit(y=y, params={"init_cov_pars": PARS_GP, "maxit": 3})
            m_.set_prediction_data(vecchia_pred_type="order_pred_first",
                                   num_neighbors_pred=12)
        pc = gp_model_from_jax_dict(jm.model_to_dict(), device="cpu")
        jl = gpb.GPModel(model_dict=pm.model_to_dict())
        for loaded, src in ((pc, jm), (jl, pm)):
            np.testing.assert_array_equal(loaded.weights, src.weights)
            assert loaded.vecchia_pred_type == "order_pred_first"
            assert loaded.num_neighbors_pred == 12
            np.testing.assert_allclose(
                loaded.predict(predict_var=True, **pkw)["mu"],
                src.predict(predict_var=True, **pkw)["mu"], rtol=1e-9,
                atol=1e-12)
        if "cluster_ids" in kw:
            np.testing.assert_array_equal(pc.cluster_ids, kw["cluster_ids"])


# ---------------------------------------------------------------------
# tests/test_weights.py::TestWeights goldens on the port
def _sim(n, c):
    return gpb.utils.datasim.sim_rand_unif(n, init_c=c, mod_lcg=134456,
                                           mult=8121, inc=28411)


def test_golden_near_one_weights_reproduce_unweighted():
    """test_GPModel_grouped_random_effects.R:66-71: weights 1.000000001
    give the unweighted golden results."""
    from gpboost_tpu.utils.datasim import qnorm
    n, m = 1000, 100
    group = np.repeat(np.arange(1, m + 1), n // m)
    y = qnorm(_sim(m, 0.546))[group - 1] + np.sqrt(0.5) * qnorm(_sim(n, 0.1))
    mw = gpt.GPModel(group_data=group, weights=np.full(n, 1.000000001),
                     device="cpu")
    mw.fit(y=y, params=dict(
        optimizer_cov="fisher_scoring", std_dev=True,
        convergence_criterion="relative_change_in_parameters"))
    exp = np.array([0.49348532, 0.02326312, 1.22299521, 0.17995161])
    got = np.asarray(mw.get_cov_pars(std_err=True)).T.ravel()
    assert np.sum(np.abs(got - exp)) < 1e-6
    assert mw.get_num_optim_iter() == 5


def test_golden_heteroscedastic_weights_fix_nugget_bias():
    rng = np.random.RandomState(0)
    n = 500
    g = rng.randint(0, 50, n)
    w = np.where(np.arange(n) < n // 2, 4.0, 0.25)
    y = rng.randn(50)[g] + 0.5 * rng.randn(n) / np.sqrt(w)
    mf = gpt.GPModel(group_data=g, weights=w, device="cpu").fit(
        y=y, params=dict(optimizer_cov="lbfgs"))
    assert abs(mf.get_cov_pars()[0] - 0.25) < 0.08   # true nugget 0.25
