"""Tapering, full-scale tapering (FSA) and full-scale Vecchia (VIF) on the
dense engines of the PyTorch port, against the JAX package.

ops/taper.py's adapters ride models/gaussian_gp.py (and the dense Laplace
engine) as gpboost_tpu/ops/taper.py's ride the JAX dense engines. On the R
suite's GP data (tests/conftest.py gp_sim_data, n = 100), float64: the
NLL and its gradient to rtol 1e-10 and predictions with variances to
1e-10 for each adapter (the inducing points and the correlation-based
VIF neighbour sets equal to the JAX package's; the distance-based sets
are the Vecchia engine's search, held in tests/test_torch_vecchia.py),
a non-Gaussian likelihood on a tapered kernel, and one GPBoost round on
the FSA adapter against the JAX host loop (rtol 1e-8). Then the goldens
of tests/test_tapering_fsa_golden.py
and tests/test_vif_golden.py (TestVIF, TestVIFFixedPars) on the port, at
those files' tolerances.
"""

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models.gaussian_gp import DenseGaussianEngine
from gpboost_tpu_torch.models.laplace import LaplaceDenseEngine

from conftest import TOLERANCE_LOOSE, TOLERANCE_MEDIUM, TOLERANCE_STRICT

torch.set_num_threads(1)

PARS = [0.1, 1.0, 0.15]
COORD_TEST = np.column_stack([[0.1, 0.2, 0.7], [0.9, 0.4, 0.55]])
X_TEST = np.column_stack([np.ones(3), [-0.5, 0.2, 0.4]])
GD_PARAMS = dict(
    optimizer_cov="gradient_descent", lr_cov=0.1, use_nesterov_acc=True,
    acc_rate_cov=0.5, delta_rel_conv=1e-6, optimizer_coef="gradient_descent",
    lr_coef=0.1,
    convergence_criterion="relative_change_in_log_likelihood",
)
BFGS = dict(optimizer_cov="lbfgs", optimizer_coef="lbfgs", maxit=1000)

# one case per adapter; the taper's shape 2 runs in TestFSA's goldens
APPROXES = [
    ("tapering", dict(cov_fct_taper_shape=0, cov_fct_taper_range=0.5)),
    ("full_scale_tapering_pred_var_exact",
     dict(num_ind_points=30, cov_fct_taper_shape=1,
          cov_fct_taper_range=0.3)),
    ("full_scale_vecchia_correlation_based",
     dict(num_ind_points=50, num_neighbors=10)),
]


@pytest.fixture(scope="module")
def reg_data(gp_sim_data):
    y = gp_sim_data["eps"] + gp_sim_data["X"] @ np.array([2.0, 2.0]) \
        + gp_sim_data["xi"]
    iu = np.triu_indices(100, k=1)
    md = np.mean(gp_sim_data["D"][iu])
    return dict(y=y, X=gp_sim_data["X"], coords=gp_sim_data["coords"],
                md=md)


@pytest.mark.parametrize("approx,extra", APPROXES,
                         ids=[a + str(i) for i, (a, _) in
                              enumerate(APPROXES)])
def test_dense_adapter_matches_jax(reg_data, approx, extra):
    kw = dict(gp_coords=reg_data["coords"], cov_function="exponential",
              gp_approx=approx, **extra)
    mj, mt = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    assert isinstance(mt._engine, DenseGaussianEngine)
    cj, ct = mj.components[0].cov_fn, mt.components[0].cov_fn
    if hasattr(cj, "ip"):
        np.testing.assert_array_equal(ct.ip, np.asarray(cj.ip))
    if hasattr(cj, "_nn_idx"):
        np.testing.assert_array_equal(ct.nn_idx, np.asarray(cj._nn_idx))
    r = reg_data["y"] - reg_data["X"] @ np.array([2.0, 2.0])
    t = mt._engine.transform_pars(PARS)
    (vj, _), gj = mj._engine.nll_profiled_vag(np.log(t[1:]), r)
    (vt, _), gt_ = mt._engine.nll_profiled_vag(np.log(t[1:]),
                                               mt._engine.prep_y(r))
    np.testing.assert_allclose(vt, float(vj), rtol=1e-10)
    np.testing.assert_allclose(gt_, np.asarray(gj), rtol=1e-10)
    # one JAX prediction with the covariance matrix, whose diagonal holds
    # the port's variances (a second JAX compile for predict_var only)
    kw = dict(y=r, gp_coords_pred=COORD_TEST, cov_pars=PARS)
    pj = mj.predict(**kw, predict_cov_mat=True)
    pc, pv = mt.predict(**kw, predict_cov_mat=True), \
        mt.predict(**kw, predict_var=True)
    for got, key, want in ((pc["mu"], "mu", pj["mu"]),
                           (pv["mu"], "mu", pj["mu"]),
                           (pc["cov"], "cov", pj["cov"]),
                           (pv["var"], "var", np.diag(pj["cov"]))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10,
                                   atol=1e-13, err_msg=key)


def test_large_taper_range_equals_exact(reg_data):
    """At a taper range far beyond the data, tapering and FSA equal the
    exact GP (the taper is 1 on every pair)."""
    r = reg_data["y"]
    exact = gpt.GPModel(gp_coords=reg_data["coords"],
                        cov_function="exponential", device="cpu")
    ref = exact.neg_log_likelihood(PARS, r)
    for approx in ("tapering", "full_scale_tapering"):
        m = gpt.GPModel(gp_coords=reg_data["coords"],
                        cov_function="exponential", gp_approx=approx,
                        num_ind_points=20, cov_fct_taper_range=1e6,
                        cov_fct_taper_shape=1, device="cpu")
        np.testing.assert_allclose(m.neg_log_likelihood(PARS, r), ref,
                                   rtol=1e-10)


def test_tapered_laplace_matches_jax(reg_data):
    """A non-Gaussian likelihood on a tapered kernel rides the dense
    Laplace engine (gp_model.py:329-335)."""
    y = (reg_data["y"] > np.median(reg_data["y"])).astype(float)
    kw = dict(gp_coords=reg_data["coords"], cov_function="exponential",
              gp_approx="tapering", cov_fct_taper_range=0.4,
              likelihood="bernoulli_probit")
    mj, mt = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    assert isinstance(mt._engine, LaplaceDenseEngine)
    np.testing.assert_allclose(mt.neg_log_likelihood([1.0, 0.2], y),
                               mj.neg_log_likelihood([1.0, 0.2], y),
                               rtol=1e-10)


@pytest.mark.parametrize("approx", ["tapering", "full_scale_tapering"])
def test_gpboost_on_an_adapter(reg_data, approx):
    """GPBoost with a tapering or FSA adapter on the dense engine (its
    Psi~^-1 for the gradients and Newton leaf updates): at a taper range
    of 1e6 it grows the exact GP's trees and predicts the same."""
    rng = np.random.RandomState(6)
    X = rng.rand(100, 3)
    y = reg_data["y"] + 2.0 * X[:, 0]
    params = {"objective": "regression", "learning_rate": 0.1,
              "num_leaves": 7, "min_data_in_leaf": 10, "verbose": 0,
              "leaves_newton_update": True}
    out = []
    for kw in ({}, dict(gp_approx=approx, cov_fct_taper_range=1e6,
                        num_ind_points=20)):
        gp = gpt.GPModel(gp_coords=reg_data["coords"],
                         cov_function="exponential", device="cpu", **kw)
        gp.set_optim_params({"optimizer_cov": "gradient_descent",
                             "maxit": 10})
        bst = gpt.train(params, gpt.Dataset(X, label=y), num_boost_round=2,
                        gp_model=gp)
        out.append(bst.predict(X[:10], gp_coords_pred=COORD_TEST[:2].repeat(
            5, 0), predict_var=True))
    for k in ("response_mean", "response_var"):
        np.testing.assert_allclose(out[1][k], out[0][k], rtol=1e-8)


def _splits(tree):
    nn = tree.num_nodes
    internal = ~tree.is_leaf[:nn]
    return (tree.is_leaf[:nn].tolist(),
            tree.split_feature[:nn][internal].tolist(),
            tree.threshold_bin[:nn][internal].tolist())


def test_gpboost_adapter_round_matches_jax(reg_data):
    """One GPBoost round on the FSA adapter at a taper range that cuts
    (0.1, 20 inducing points) against the JAX host loop: the taper and
    the low-rank residual reach Psi~^-1 in the gradients and the Newton
    leaf updates. The same trees; scores, parameters and predictions with
    variances to rtol 1e-8."""
    rng = np.random.RandomState(6)
    X = rng.rand(100, 3)
    y = reg_data["y"] + 2.0 * X[:, 0]
    params = {"objective": "regression", "learning_rate": 0.1,
              "num_leaves": 7, "min_data_in_leaf": 10, "verbose": 0,
              "leaves_newton_update": True}
    kw = dict(gp_coords=reg_data["coords"], cov_function="exponential",
              gp_approx="full_scale_tapering", cov_fct_taper_range=0.1,
              cov_fct_taper_shape=1, num_ind_points=20)
    opt = {"optimizer_cov": "gradient_descent", "maxit": 10}
    gj, gp = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    np.testing.assert_array_equal(gp.components[0].cov_fn.ip,
                                  np.asarray(gj.components[0].cov_fn.ip))
    gj.set_optim_params(params=opt)
    gp.set_optim_params(params=opt)
    bj = gpb.train(params, gpb.Dataset(X, label=y), num_boost_round=1,
                   gp_model=gj, callbacks=[lambda env: None])
    bp = gpt.train(params, gpt.Dataset(X, label=y), num_boost_round=1,
                   gp_model=gp)
    assert [_splits(t) for t in bp.trees] == [_splits(t) for t in bj.trees]
    np.testing.assert_allclose(bp.F.numpy(), bj.F, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-8)
    # at the dense adapter test's shapes, whose JAX compiles it shares
    pj = bj.predict(X[:3], gp_coords_pred=COORD_TEST, predict_var=True)
    pp = bp.predict(X[:3], gp_coords_pred=COORD_TEST, predict_var=True)
    for k in ("response_mean", "response_var"):
        np.testing.assert_allclose(pp[k], np.asarray(pj[k]), rtol=1e-8,
                                   err_msg=k)


# ---------------------------------------------------------------------
# the goldens of tests/test_tapering_fsa_golden.py on the port
def _fit(reg_data, params, **kw):
    m = gpt.GPModel(gp_coords=reg_data["coords"], device="cpu", **kw)
    return m.fit(y=reg_data["y"], X=reg_data["X"], params=params)


def _init(reg_data, div=3):
    v = np.var(reg_data["y"], ddof=1) / 2
    return [v, v, reg_data["md"] / div]


class TestTapering:
    def test_nll_large_taper_range_equals_exact(self, reg_data):
        m = gpt.GPModel(gp_coords=reg_data["coords"],
                        cov_function="exponential", gp_approx="tapering",
                        cov_fct_taper_shape=0, cov_fct_taper_range=1e6,
                        device="cpu")
        nll = m.neg_log_likelihood(y=reg_data["y"],
                                   cov_pars=_init(reg_data))
        assert abs(nll - 212.9854341) < TOLERANCE_STRICT

    def test_fit_large_taper_range(self, reg_data):
        m = _fit(reg_data, dict(GD_PARAMS, init_cov_pars=_init(reg_data)),
                 cov_function="exponential", gp_approx="tapering",
                 cov_fct_taper_shape=0, cov_fct_taper_range=1e6)
        assert np.sum(np.abs(m.get_cov_pars()
                             - [0.01621846, 0.99717680, 0.09616230])) \
            < TOLERANCE_MEDIUM
        assert np.sum(np.abs(m.get_coef() - [2.30554610, 1.89920767])) \
            < TOLERANCE_MEDIUM
        assert m.get_num_optim_iter() == 100
        pred = m.predict(gp_coords_pred=COORD_TEST, X_pred=X_TEST,
                         predict_cov_mat=True)
        expected_cov = np.array(
            [6.304732e-01, 1.313601e-05, 1.008080e-07, 1.313601e-05,
             3.524404e-01, 3.699813e-07, 1.008080e-07, 3.699813e-07,
             4.277339e-01]).reshape(3, 3)
        assert np.sum(np.abs(pred["mu"] - [1.195910242, 4.060125034,
                                           3.15963272])) < TOLERANCE_MEDIUM
        assert np.sum(np.abs(pred["cov"] - expected_cov)) < TOLERANCE_MEDIUM

    def test_fit_small_taper_range(self, reg_data):
        m = _fit(reg_data, dict(GD_PARAMS, init_cov_pars=_init(reg_data)),
                 cov_function="exponential", gp_approx="tapering",
                 cov_fct_taper_shape=0, cov_fct_taper_range=0.5)
        # the reference's GD uses untapered gradients, so the JAX package
        # (exact gradients) lands near its numbers (test_tapering_fsa_
        # golden.py:89-96); the port is held at the same tolerances
        assert np.sum(np.abs(m.get_cov_pars()
                             - [0.02593993, 0.99435221, 0.17712808])) \
            < TOLERANCE_LOOSE
        assert np.sum(np.abs(m.get_coef() - [2.32410488, 1.89498931])) \
            < 0.05
        assert abs(m.get_num_optim_iter() - 75) <= 2

    def test_fit_matern_taper_small_range_strict(self, reg_data):
        m = _fit(reg_data, dict(GD_PARAMS, std_dev=True,
                                init_cov_pars=_init(reg_data, 4.7)),
                 cov_function="matern", cov_fct_shape=1.5,
                 gp_approx="tapering", cov_fct_taper_shape=1,
                 cov_fct_taper_range=0.5)
        ref_opt = [0.18970609, 0.80493104, 0.11212289]
        r = reg_data["y"] - reg_data["X"] @ np.array([2.35889350,
                                                      1.87422223])
        nll_at_ref = m.neg_log_likelihood(cov_pars=ref_opt, y=r)
        assert abs(nll_at_ref - 121.93726329644426) < 1e-8
        assert m.get_current_neg_log_likelihood() \
            <= nll_at_ref + TOLERANCE_STRICT
        est_se = m.get_cov_pars(std_err=True).T.ravel()
        assert np.sum(np.abs(est_se - [0.18970609, 0.07263436, 0.80493104,
                                       0.20220891, 0.11212289,
                                       0.02562848])) < 0.1
        coef_se = m.get_coef(std_err=True).T.ravel()
        assert np.sum(np.abs(coef_se - [2.35889350, 0.17954660, 1.87422223,
                                        0.09831309])) < 0.1


class TestFSA:
    @pytest.fixture(scope="class")
    def no_approx_fit(self, reg_data):
        params = dict(GD_PARAMS, init_cov_pars=_init(reg_data))
        m = _fit(reg_data, params, cov_function="exponential")
        pred = m.predict(gp_coords_pred=COORD_TEST, X_pred=X_TEST,
                         predict_var=True, cov_pars=[0.1, 1, 0.1])
        return dict(model=m, params=params, pred=pred)

    def _check(self, m, ref, tol_var):
        assert np.sum(np.abs(m.get_cov_pars() - ref["model"].get_cov_pars())) \
            < TOLERANCE_LOOSE
        assert abs(m.get_current_neg_log_likelihood()
                   - ref["model"].get_current_neg_log_likelihood()) \
            < TOLERANCE_LOOSE
        pred = m.predict(gp_coords_pred=COORD_TEST, X_pred=X_TEST,
                         predict_var=True, cov_pars=[0.1, 1, 0.1])
        assert np.sum(np.abs(pred["mu"] - ref["pred"]["mu"])) \
            < TOLERANCE_LOOSE
        assert np.sum(np.abs(pred["var"] - ref["pred"]["var"])) < tol_var

    def test_large_taper_range_equals_exact(self, reg_data, no_approx_fit):
        m = _fit(reg_data, no_approx_fit["params"],
                 cov_function="exponential", gp_approx="full_scale_tapering",
                 num_ind_points=60, cov_fct_taper_shape=2,
                 cov_fct_taper_range=1e6)
        self._check(m, no_approx_fit, 0.2)
        assert np.sum(np.abs(m.get_coef()
                             - no_approx_fit["model"].get_coef())) \
            < TOLERANCE_LOOSE
        assert m.get_num_optim_iter() \
            == no_approx_fit["model"].get_num_optim_iter()

    def test_n_minus_1_ip_small_taper_equals_exact(self, reg_data,
                                                   no_approx_fit):
        m = _fit(reg_data, no_approx_fit["params"],
                 cov_function="exponential", gp_approx="full_scale_tapering",
                 num_ind_points=99, cov_fct_taper_shape=2,
                 cov_fct_taper_range=0.4)
        self._check(m, no_approx_fit, TOLERANCE_LOOSE)

    def test_50_ip_taper_05_near_reference(self, reg_data, no_approx_fit):
        m = _fit(reg_data, no_approx_fit["params"],
                 cov_function="exponential", gp_approx="full_scale_tapering",
                 num_ind_points=50, cov_fct_taper_shape=2,
                 cov_fct_taper_range=0.5)
        assert np.sum(np.abs(m.get_cov_pars()
                             - [0.01503776, 1.00219308, 0.09835141])) < 0.1
        assert np.sum(np.abs(m.get_coef() - [2.30508771, 1.89918852])) < 0.05


# ---------------------------------------------------------------------
# the goldens of tests/test_vif_golden.py on the port
@pytest.fixture(scope="module")
def vif_no_approx(reg_data):
    m = _fit(reg_data, dict(BFGS), cov_function="exponential")
    pred = m.predict(gp_coords_pred=COORD_TEST, X_pred=X_TEST,
                     predict_var=True, cov_pars=[0.1, 1, 0.1])
    return dict(model=m, pred=pred)


@pytest.mark.parametrize("gp_approx", ["full_scale_vecchia",
                                       "full_scale_vecchia_correlation_based"])
class TestVIF:
    def test_many_neighbors_equals_exact(self, reg_data, vif_no_approx,
                                         gp_approx):
        m = _fit(reg_data, dict(BFGS), cov_function="exponential",
                 gp_approx=gp_approx, num_ind_points=60, num_neighbors=50)
        ref = vif_no_approx["model"]
        assert np.sum(np.abs(m.get_cov_pars() - ref.get_cov_pars())) \
            < TOLERANCE_LOOSE
        assert np.sum(np.abs(m.get_coef() - ref.get_coef())) \
            < TOLERANCE_LOOSE
        assert abs(m.get_current_neg_log_likelihood()
                   - ref.get_current_neg_log_likelihood()) < TOLERANCE_LOOSE
        pred = m.predict(gp_coords_pred=COORD_TEST, X_pred=X_TEST,
                         predict_var=True, cov_pars=[0.1, 1, 0.1])
        assert np.sum(np.abs(pred["mu"] - vif_no_approx["pred"]["mu"])) < 0.1
        assert np.sum(np.abs(pred["var"] - vif_no_approx["pred"]["var"])) \
            < 0.2

    def test_n_minus_1_ip_few_neighbors(self, reg_data, vif_no_approx,
                                        gp_approx):
        m = _fit(reg_data, dict(BFGS), cov_function="exponential",
                 gp_approx=gp_approx, num_ind_points=99, num_neighbors=5)
        ref = vif_no_approx["model"]
        assert np.sum(np.abs(m.get_cov_pars() - ref.get_cov_pars())) \
            < TOLERANCE_LOOSE
        assert abs(m.get_current_neg_log_likelihood()
                   - ref.get_current_neg_log_likelihood()) < TOLERANCE_LOOSE
        pred = m.predict(gp_coords_pred=COORD_TEST, X_pred=X_TEST,
                         predict_var=True, cov_pars=[0.1, 1, 0.1])
        assert np.sum(np.abs(pred["mu"] - vif_no_approx["pred"]["mu"])) \
            < TOLERANCE_LOOSE
        assert np.sum(np.abs(pred["var"] - vif_no_approx["pred"]["var"])) \
            < TOLERANCE_LOOSE

    def test_50ip_15nn_near_reference_goldens(self, reg_data, gp_approx):
        m = _fit(reg_data, dict(BFGS), cov_function="exponential",
                 gp_approx=gp_approx, num_ind_points=50, num_neighbors=15)
        assert np.sum(np.abs(m.get_cov_pars()
                             - [0.009170148, 1.002068032, 0.095036760])) \
            < 0.1
        assert np.sum(np.abs(m.get_coef() - [2.305036, 1.899353])) < 0.05


class TestVIFFixedPars:
    def test_estimate_cov_par_index(self, reg_data):
        v = np.var(reg_data["y"], ddof=1) / 2
        init = [v, v, 0.17864807736]
        kw = dict(cov_function="exponential", gp_approx="full_scale_vecchia",
                  num_ind_points=50, num_neighbors=10)
        m = _fit(reg_data, dict(BFGS, init_cov_pars=init,
                                estimate_cov_par_index=[1, 0, 0]), **kw)
        assert np.sum(np.abs(m.get_cov_pars()[1:] - init[1:])) \
            < TOLERANCE_STRICT
        m2 = _fit(reg_data, dict(BFGS, init_cov_pars=init,
                                 estimate_cov_par_index=[0, 1, 0]), **kw)
        est2 = m2.get_cov_pars()
        assert abs(est2[0] - init[0]) < TOLERANCE_STRICT
        assert abs(est2[2] - init[2]) < TOLERANCE_STRICT
