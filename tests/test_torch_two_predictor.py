"""The families' model paths of the PyTorch port: two predictor sets, two
random-effect sets and the W+/W- split Cholesky.

* The R-suite goldens of test_two_predictor_golden.py,
  test_zi_hurdle_golden.py, test_censored_golden.py, test_egpd_golden.py,
  test_tweedie_golden.py and test_hetsk_fixed_and_random_golden.py run on
  the port through those files' own test bodies, with the port's GPModel
  (device="cpu") in place of the JAX package's, at those files' tolerances
  and sizes.
* Against the JAX package at n <= 200: one two-predictor LaGaBoost round on
  a grouped model (init scores to 1e-10; both trees, the refit's
  parameters and the predictions to 1e-6 relative, as the host L-BFGS-B
  fits on both sides end within about 1e-8 of each other) and its model
  dict loaded both ways (predictions to 1e-8); the dense Laplace
  engine's NLL, g_u and g_F on the W+/W- path (zero_inflated_poisson's
  observed Hessian, hurdle_gamma's exact zeros) and with two random-effect
  sets; the split Cholesky's half log-determinant against slogdet, with a
  gradient and a second derivative that autograd takes through its
  backward at W = 0.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import gpboost_tpu as gpb
from gpboost_tpu.models.components import GPComponent as JGP
from gpboost_tpu.models.laplace import LaplaceDenseEngine as JDense
from gpboost_tpu.likelihoods.base import get_likelihood as jlik
from gpboost_tpu.ops.cov_fcts import CovarianceFunction as JCF

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting.gbdt import _RunningScore
from gpboost_tpu_torch.likelihoods.base import get_likelihood as tlik
from gpboost_tpu_torch.models.components import GPComponent as TGP
from gpboost_tpu_torch.models.laplace import (LaplaceDenseEngine as TDense,
                                              _NegwHalfLogdet)
from gpboost_tpu_torch.ops.cov_fcts import CovarianceFunction as TCF

sys.path.insert(0, os.path.dirname(__file__))
import test_censored_golden as gcen  # noqa: E402
import test_egpd_golden as gegpd  # noqa: E402
import test_hetsk_fixed_and_random_golden as ghet  # noqa: E402
import test_tweedie_golden as gtw  # noqa: E402
import test_two_predictor_golden as g2  # noqa: E402
import test_zi_hurdle_golden as gzi  # noqa: E402
from test_censored_golden import cen_data  # noqa: E402,F401
from test_egpd_golden import egpd_data  # noqa: E402,F401
from test_hetsk_fixed_and_random_golden import het2_data  # noqa: E402,F401
from test_tweedie_golden import tw_data  # noqa: E402,F401
from test_two_predictor_golden import reg_data  # noqa: E402,F401
from test_zi_hurdle_golden import zi_data  # noqa: E402,F401

torch.set_num_threads(1)


# ---------------------------------------------------------------------
# the goldens on the port
class _PortGPModel(gpt.GPModel):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(*args, **kwargs)


def _port_fit_gp_model(y, X=None, params=None, **kwargs):
    return _PortGPModel(**kwargs).fit(y=y, X=X, params=copy.deepcopy(params))


# (module, class or None, test, its data fixture, parameters)
GOLDENS = [
    (g2, "TestHurdleRegressionLognormal", "test_eval_estimation_prediction",
     "reg_data", {}),
    (g2, "TestZICountRegression", "test_eval", "reg_data",
     {"fam": "zero_inflated_regression_negative_binomial"}),
    (g2, "TestZICountRegression", "test_estimation_prediction_poisson",
     "reg_data", {}),
    (g2, "TestZICountRegression", "test_vecchia_coupled", "reg_data", {}),
    (g2, "TestGaussianHeteroscedastic", "test_eval", "het", {}),
    (g2, "TestGaussianHeteroscedastic", "test_estimation_prediction", "het",
     {}),
    (gzi, "TestGroupedRE", "test_eval", "zi_data",
     {"fam": "zero_inflated_negative_binomial"}),
    (gzi, "TestGroupedRE", "test_estimation_prediction", "zi_data",
     {"fam": "hurdle_gamma"}),
    (gzi, "TestFisherLaplaceVariants", "test_fisher_eval_and_variant_"
     "relations", "zi_data", {"fam": "zero_inflated_poisson"}),
    (gzi, "TestHurdleGPDFamilies", "test_hurdle_gpd", "zi_data", {}),
    (gcen, "TestZoctn", "test_eval", "cen_data", {}),
    (gcen, "TestTransformedBeta", "test_eval", "cen_data", {}),
    (gcen, "TestShiftedGamma", "test_estimation_prediction", "cen_data", {}),
    (gegpd, "TestEGPDCarriers", "test_eval_given", "egpd_data",
     {"likelihood": "egpd_power_beta"}),
    (gtw, "TestTweedie", "test_grouped_with_covariates", "tw_data", {}),
    (ghet, None, "test_nll_evaluation", "het2_data", {}),
]


def _golden_id(g):
    mod, cls, name, _, kw = g
    return ".".join([mod.__name__[5:], cls or "", name]
                    + [str(v) for v in kw.values()])


@pytest.mark.parametrize("case", GOLDENS, ids=[_golden_id(g) for g in GOLDENS])
def test_golden_on_the_port(case, request, monkeypatch):
    mod, cls, name, data_name, kw = case
    monkeypatch.setattr(mod, "GPModel", _PortGPModel)
    if hasattr(mod, "fitGPModel"):
        monkeypatch.setattr(mod, "fitGPModel", _port_fit_gp_model)
    if cls is None:
        getattr(mod, name)(request.getfixturevalue(data_name), **kw)
        return
    obj = getattr(mod, cls)()
    fn = getattr(obj, name)
    if data_name == "het":
        # TestGaussianHeteroscedastic's class fixture
        fn(mod.TestGaussianHeteroscedastic.__dict__["het"].__wrapped__(obj),
           **kw)
        return
    data = request.getfixturevalue(data_name)
    args = [data]
    y_fix = getattr(mod, cls).__dict__.get("y")
    if y_fix is not None:
        # the censored classes' response fixture
        args.append(y_fix.__wrapped__(obj, data))
    fn(*args, **kw)


# ---------------------------------------------------------------------
# against the JAX package
def _zi_grouped(n=200, q=20, seed=1):
    rng = np.random.RandomState(seed)
    g = rng.randint(0, q, n)
    X = rng.rand(n, 3)
    eta = 0.3 + np.sin(3 * X[:, 0]) + 0.5 * rng.randn(q)[g]
    zeta = -0.5 + 1.5 * X[:, 1]
    y = np.where(rng.rand(n) < 1 / (1 + np.exp(-zeta)), 0.0,
                 rng.poisson(np.exp(eta))).astype(float)
    return X, g, y


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def test_two_predictor_lagaboost_round_against_jax():
    X, g, y = _zi_grouped()
    params = {"learning_rate": 0.1, "num_leaves": 4, "min_data_in_leaf": 5,
              "verbose": 0}
    lik = "zero_inflated_regression_poisson"
    mj = gpb.GPModel(group_data=g, likelihood=lik)
    bj = gpb.train(params, gpb.Dataset(X, y), gp_model=mj, num_boost_round=1)
    mt = gpt.GPModel(group_data=g, likelihood=lik, device="cpu")
    bt = gpt.train(params, gpt.Dataset(X, y), gp_model=mt, num_boost_round=1,
                   device="cpu")
    assert len(bt.trees) == len(bj.trees) == 2
    assert bt.current_iteration() == 1
    assert _rel([bt.init_score, bt.init_score2],
                [bj.init_score, bj.init_score2]) < 1e-10
    # both sides' first GP fit is a host L-BFGS-B run whose end point
    # agrees to about 1e-8, so the gradients (and the trees' leaf values,
    # sums of them) agree to 1e-6 relative
    for tt, tj in zip(bt.trees, bj.trees):
        dt, dj = tt.to_dict(), tj.to_dict()
        assert dt["split_feature"] == dj["split_feature"]
        np.testing.assert_allclose(dt["leaf_value"], dj["leaf_value"],
                                   rtol=1e-6, atol=1e-8)
    assert _rel(mt.get_cov_pars(), mj.get_cov_pars()) < 1e-6
    Xn, gn = np.random.RandomState(5).rand(6, 3), np.array([0, 1, 2, 3, 40,
                                                            41])
    pt = bt.predict(Xn, group_data_pred=gn, predict_var=True)
    pj = bj.predict(Xn, group_data_pred=gn, predict_var=True)
    for k in ("fixed_effect", "random_effect_mean", "response_mean",
              "response_var"):
        assert pt[k].shape == np.asarray(pj[k]).shape, k
        np.testing.assert_allclose(pt[k], pj[k], rtol=1e-6, atol=1e-10)
    assert pt["fixed_effect"].shape == (12,)
    lat = bt.predict(Xn, group_data_pred=gn, pred_latent=True)
    assert np.all(lat["random_effect_mean"][4:] == 0.0)
    # model dicts both ways: a dict saved by either package loads in both,
    # and the two predict the same to 1e-8 (a loaded model finds its mode
    # from zero; the trained one starts from its fit's mode, and the
    # Fisher-curvature Newton of the combined approximation stops within
    # the objective's 1e-8 relative change of either start)
    for d in (bt.model_to_dict(), bj.model_to_dict()):
        assert d["num_sets"] == 2 and len(d["trees"]) == 2
        bl = gpt.Booster(model_dict=d, device="cpu")
        assert bl._nsets == 2 and bl.current_iteration() == 1
        pl = bl.predict(Xn, group_data_pred=gn, predict_var=True)
        pjl = gpb.Booster(model_dict=d).predict(Xn, group_data_pred=gn,
                                                predict_var=True)
        for k in ("fixed_effect", "response_mean", "response_var"):
            np.testing.assert_allclose(pl[k], pjl[k], rtol=1e-8)
    # a validation set's running score (tree i to block i % 2) equals the
    # ensemble's raw score bit for bit
    raw = bt.predict(Xn, raw_score=True, ignore_gp_model=True)
    np.testing.assert_array_equal(_RunningScore(bt, Xn).advance(bt), raw)
    # num_iteration slices both blocks' trees
    p0 = bt.predict(Xn, num_iteration=1, raw_score=True, ignore_gp_model=True)
    np.testing.assert_allclose(p0, bj.predict(
        Xn, num_iteration=1, raw_score=True, ignore_gp_model=True),
        rtol=1e-8)
    with pytest.raises(ValueError, match="two-predictor"):
        gpt.GPModel(group_data=g, likelihood=lik, device="cpu").fit(
            y=y, X=np.ones((len(y), 1)),
            params={"optimizer_cov": "gradient_descent"})


def _dense_pair(name, n=60, seed=0):
    rng = np.random.RandomState(seed)
    coords = rng.rand(n, 2)
    q = 0.5 if name.startswith("asymmetric_laplace") else None
    je = JDense([JGP(coords, JCF("exponential", dim=2))], n, jlik(name, q))
    te = TDense([TGP(coords, TCF("exponential", dim=2))], n, tlik(name, q),
                device="cpu")
    return rng, je, te


@pytest.mark.parametrize("name,aux", [
    ("zero_inflated_poisson", [0.4]), ("hurdle_gamma", [1.5, 0.5]),
    ("gaussian_heteroscedastic_fixed_and_random", []),
    ("asymmetric_laplace_tkc", [0.8])])
def test_dense_engine_against_jax(name, aux):
    """W+/W- (negative observed Hessian, exact zeros), two RE sets and the
    triangular-kernel curvature in the mode finding and the determinant:
    NLL, g_u and g_F at a fixed point, Newton steps equal."""
    rng, je, te = _dense_pair(name)
    n = je.n
    y = {"zero_inflated_poisson": np.where(rng.rand(n) < 0.4, 0.0,
                                           rng.poisson(2, n)),
         "hurdle_gamma": np.where(rng.rand(n) < 0.3, 0.0,
                                  rng.gamma(2.0, 1.0, n))}.get(
        name, rng.randn(n)).astype(float)
    assert te._w_det_general == (name in ("zero_inflated_poisson",
                                          "hurdle_gamma"))
    assert te._w_neg == bool(je.likelihood.W_may_be_negative)
    u = np.concatenate([np.log(np.tile([1.2, 0.3], te.num_theta // 2)),
                        np.log(np.asarray(aux, float))])
    F = 0.3 * rng.randn(n * te.num_sets_fe)
    vj = je.laplace_vag_F(u, jnp.asarray(y), jnp.asarray(F), je.zero_mode())
    vt = te.laplace_vag_F(u, torch.as_tensor(y), F, te.zero_mode())
    assert je.last_num_mode_it == te.last_num_mode_it
    assert _rel(vt[0], vj[0]) < 1e-10
    np.testing.assert_allclose(vt[1], vj[1], rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(vt[2], vj[2], rtol=1e-8, atol=1e-11)


def _engine_case(kind, n=80, seed=2):
    """(likelihood, GPModel arguments, cov_pars, y, F) of one engine case:
    a zero-inflated count response whose zero probability follows the
    second predictor on a GP, or a heavy-tailed response in groups for the
    asymmetric Laplace quantile model."""
    rng = np.random.RandomState(seed)
    coords = rng.rand(n, 2)
    lat = np.sin(4 * coords[:, 0]) + 0.4 * rng.randn(n)
    zeta = -0.5 + coords[:, 1]
    if kind == "grouped":
        return ("asymmetric_laplace_tkc",
                dict(group_data=rng.randint(0, 12, n),
                     likelihood_additional_param=0.5), [0.5],
                lat + rng.standard_t(3, n), 0.2 * np.cos(np.arange(n)))
    y = np.where(rng.rand(n) < 1 / (1 + np.exp(-zeta)), 0.0,
                 rng.poisson(np.exp(lat))).astype(float)
    approx = dict(gp_approx="fitc", num_ind_points=15) if kind == "fitc" \
        else dict(gp_approx="vecchia", num_neighbors=10,
                  matrix_inversion_method="iterative")
    return ("zero_inflated_regression_poisson",
            dict(gp_coords=coords, cov_function="exponential", **approx),
            [0.5, 0.2], y, np.r_[0.2 * np.cos(np.arange(n)), zeta - 0.2])


@pytest.mark.parametrize("kind", ["vecchia_iterative", "fitc", "grouped"])
def test_engine_against_jax(kind):
    """Two predictor sets on the matrix-free Vecchia-Laplace engine and on
    FITC-Laplace (zero_inflated_regression_poisson: F of 2n, each block
    permuted into the Vecchia order on its own), and the triangular-kernel
    curvature in the mode finding and the log-determinant of the grouped
    engine (asymmetric_laplace_tkc, the rows mode finder; the dense
    engine's is a case of test_dense_engine_against_jax): the NLL and g_u
    at a fixed point to 1e-8 relative, g_F to 1e-8 of its largest entry,
    Newton steps equal. The split of F_pred into the two blocks at
    prediction is LaplaceEngineBase's, held to the JAX package by the
    LaGaBoost round."""
    lik, kw, pars, y, F = _engine_case(kind)
    mj = gpb.GPModel(likelihood=lik, **kw)
    mt = gpt.GPModel(likelihood=lik, device="cpu", **kw)
    je, te = mj._engine, mt._engine
    assert type(te).__name__ == type(je).__name__ \
        or kind == "vecchia_iterative"
    assert te.num_sets_fe == je.likelihood.num_sets_fe
    if kind == "grouped":
        assert te._padded is None       # tkc takes the rows finder
    if kind == "vecchia_iterative":
        # a random ordering, so that each block's permutation matters
        assert not np.array_equal(te._perm_d.numpy(), np.arange(len(y)))
    u = np.log(je.transform_pars(np.asarray(pars, float)))
    if je.num_aux:
        u = np.r_[u, np.log(np.asarray(je.likelihood.init_aux(y)))]
    vj = je.laplace_vag_F(u, jnp.asarray(y), jnp.asarray(F), je.zero_mode())
    vt = te.laplace_vag_F(u, torch.as_tensor(y), F, te.zero_mode())
    assert te.last_num_mode_it == je.last_num_mode_it
    assert _rel(vt[0], vj[0]) < 1e-8
    np.testing.assert_allclose(vt[1], vj[1], rtol=1e-8)
    np.testing.assert_allclose(vt[2], vj[2], rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(vj[2])))


def test_split_cholesky_logdet_and_its_derivatives():
    """0.5 log|I + Sigma W| with W negative, zero and positive: value
    against slogdet, gradient and second derivative against finite
    differences (autograd through the backward)."""
    rng = np.random.RandomState(3)
    n = 8
    A = rng.randn(n, n)
    Sigma = torch.as_tensor(A @ A.T / n + 0.5 * np.eye(n))
    W = torch.as_tensor(np.r_[0.0, 0.0, -0.2, 0.7, 1.3, -0.1, 0.0, 2.0])
    v = _NegwHalfLogdet.apply(Sigma, W)
    ref = 0.5 * torch.linalg.slogdet(torch.eye(n, dtype=Sigma.dtype)
                                     + Sigma * W[None, :])[1]
    assert abs(float(v) - float(ref)) < 1e-12
    # Sigma moves along a symmetric direction, as Sigma(theta) does
    B = rng.randn(n, n)
    S1 = torch.as_tensor(B + B.T)

    def f(s, w):
        return _NegwHalfLogdet.apply(Sigma + s * S1, w)

    s0 = torch.zeros((), dtype=torch.float64, requires_grad=True)
    Wg = W.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(f, (s0, Wg))
    assert torch.autograd.gradgradcheck(f, (s0, Wg))
