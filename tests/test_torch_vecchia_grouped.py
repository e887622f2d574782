"""The combined Vecchia GP + grouped random effects engine of the PyTorch
port (models/vecchia_grouped.py), its dispatch and LaGaBoost over it,
against the JAX package on the CPU in float64.

* Engine at n = 200 on 60 sites (duplicate coordinates), m = 10, two
  crossed groupings and a random slope, bernoulli_probit: NLL, g_u and g_F
  to rtol 1e-8, the mode to 1e-10, Newton steps equal, from a cold and a
  warm start, for the "cholesky" formulation and the "iterative" one (10
  probes, the same SLQ probes; CG totals equal).
* The iterative formulation's preconditioners: the ssor sweep against the
  JAX engine's (1e-12) with two groupings and equal to Jacobi with one;
  the NLL under ssor, diagonal, none and the alias jacobi against the JAX
  vadu engine's (rtol 1e-7: they differ only by the Newton solves' CG
  tolerance); other types raise ValueError.
* Predictions with variances and the covariance matrix, new levels
  included, and predict_response, on the dense formulation against the
  JAX engine (rtol 1e-8); the iterative formulation's against the dense
  one (rtol 1e-6, the CG tolerance); training_re (1e-8).
* One LaGaBoost round (the GP model fitted once by gradient descent, its
  parameters then held) against the JAX host loop: init score, fit, the
  gradient in F, the tree, predictions; the model dicts both ways;
  GPBoost with a Gaussian response, which is LaGaBoost over
  gaussian_latent (one round, the model loaded from a dict).
* Each of the 16 likelihoods, weighted and not: at m = n_u - 1 the
  combined engine equals the dense Laplace engine (rtol 1e-8).
* The dispatch: a Gaussian response as gaussian_latent (parameter names,
  aux_pars the error variance; "auto" takes the iterative formulation
  above n = 8,000; cluster_ids raise), gp_approx="vecchia_latent" and
  "vecchia_euclidean", an exact GP with grouped effects for a gamma
  likelihood on the dense Laplace engine: each against the JAX package
  (rtol 1e-8).
* The goldens of tests/test_combined_gp_re_golden.py that the port covers,
  their own test bodies run on the port (the Vecchia and exact cases of
  TestCombinedGaussian, TestCombinedGamma and TestCombinedT, the linear
  regression term and cluster_ids); posterior sampling, GP random
  coefficients and save_model are not ported yet.
"""

import copy
import os
import pickle
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.stats import norm

import gpboost_tpu as gpb
from gpboost_tpu.likelihoods.base import get_likelihood as jax_lik
from gpboost_tpu.models.components import GPComponent as JaxGP
from gpboost_tpu.models.components import GroupedComponent as JaxGroup
from gpboost_tpu.models.vecchia_grouped import \
    VecchiaGroupedLaplaceEngine as JaxEngine
from gpboost_tpu.ops.cov_fcts import CovarianceFunction as JaxCov

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.convert import (booster_from_jax_dict,
                                       gp_model_from_jax_dict)
from gpboost_tpu_torch.likelihoods.base import get_likelihood as port_lik
from gpboost_tpu_torch.models.components import GPComponent, GroupedComponent
from gpboost_tpu_torch.models.laplace import LaplaceDenseEngine
from gpboost_tpu_torch.models.vecchia_grouped import \
    VecchiaGroupedLaplaceEngine
from gpboost_tpu_torch.models.vecchia_laplace import VecchiaLaplaceEngine
from gpboost_tpu_torch.ops.cov_fcts import CovarianceFunction

sys.path.insert(0, os.path.dirname(__file__))
import test_combined_gp_re_golden as golden  # noqa: E402
from test_combined_gp_re_golden import cb  # noqa: E402,F401

torch.set_num_threads(1)

TOL = 1e-8
N, M, P, SITES = 200, 10, 3, 60
MODEL = dict(cov_function="exponential", gp_approx="vecchia",
             num_neighbors=M, likelihood="bernoulli_probit")
BOOST = {"objective": "binary", "learning_rate": 0.1, "num_leaves": 7,
         "min_data_in_leaf": 5, "verbose": 0,
         "train_gp_model_cov_pars": False}
PARS = np.array([0.5, 0.3, 0.4, 1.0, 0.15])   # Group_1, Group_2, slope, GP


def _sim(n=N, seed=0):
    rng = np.random.RandomState(seed)
    sites = rng.rand(SITES, 2)
    coords = sites[rng.randint(0, SITES, n)]          # duplicate locations
    g1, g2 = rng.randint(0, 8, n), rng.randint(0, 5, n)
    x = rng.rand(n)
    X = rng.rand(n, P)
    b1, b2, b3 = rng.randn(8), rng.randn(5), rng.randn(8)
    lat = (np.sin(3 * X[:, 0]) + X[:, 1] ** 2 - 1.0
           + 0.8 * np.sin(6 * coords[:, 0]) * np.cos(4 * coords[:, 1])
           + 0.6 * b1[g1] + 0.4 * b2[g2] + 0.3 * x * b3[g1])
    y = (rng.rand(n) < norm.cdf(lat)).astype(float)
    return dict(coords=coords, g=np.c_[g1, g2], x=x, X=X, y=y)


def _pred_data(d, seed=1):
    """7 points: 4 at new sites, the rest at training sites, with new
    levels of each grouping and shared new levels."""
    rng = np.random.RandomState(seed)
    cp = np.r_[rng.rand(4, 2), d["coords"][:3]]
    g = np.c_[[0, 1, 8, 8, 2, 9, 3], [0, 5, 1, 2, 5, 6, 4]]
    return dict(gp_coords_pred=cp, group_data_pred=g,
                group_rand_coef_data_pred=np.linspace(0.1, 0.9, 7))


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _components(pkg, d, two=True):
    Group, GP, Cov = (JaxGroup, JaxGP, JaxCov) if pkg == "jax" else \
        (GroupedComponent, GPComponent, CovarianceFunction)
    comps = [Group(d["g"][:, 0], name="Group_1")]
    if two:
        comps += [Group(d["g"][:, 1], name="Group_2"),
                  Group(d["g"][:, 0], z=d["x"], name="Group_rand_coef_1")]
    comps.append(GP(d["coords"], Cov("exponential"), name="GP"))
    return comps


def _engine(pkg, d, mim, two=True, **kw):
    if pkg == "jax":
        return JaxEngine(_components("jax", d, two), N,
                         jax_lik("bernoulli_probit"), num_neighbors=M,
                         matrix_inversion_method=mim, **kw)
    return VecchiaGroupedLaplaceEngine(
        _components("port", d, two), N, port_lik("bernoulli_probit"),
        num_neighbors=M, matrix_inversion_method=mim, device="cpu", **kw)


def _gp_kw(d):
    return dict(gp_coords=d["coords"], group_data=d["g"],
                group_rand_coef_data=d["x"], ind_effect_group_rand_coef=1)


@pytest.fixture(scope="module")
def data():
    return _sim()


@pytest.fixture(scope="module")
def one_round(data):
    """One LaGaBoost round of each package on the combined model: the GP
    model fitted once (3 gradient-descent iterations) before the tree, its
    parameters held after it (train_gp_model_cov_pars False), so the JAX
    side compiles its NLL, gradient and F-gradient once; the engines and
    models serve the tests below."""
    d = data
    opt = {"optimizer_cov": "gradient_descent", "maxit": 3}
    gj = gpb.GPModel(**_gp_kw(d), **MODEL)
    gj.set_optim_params(params=opt)
    bj = gpb.train(BOOST, gpb.Dataset(d["X"], label=d["y"]),
                   num_boost_round=1, gp_model=gj,
                   callbacks=[lambda env: None])
    gp = gpt.GPModel(**_gp_kw(d), device="cpu", **MODEL)
    gp.set_optim_params(params=opt)
    bp = gpt.Booster(BOOST, gpt.Dataset(d["X"], label=d["y"]),
                     gp_model=gp, device="cpu")
    grad, _ = bp._gradients()
    bp.update()
    return dict(bj=bj, gj=gj, bp=bp, gp=gp, grad=grad)


@pytest.fixture(scope="module")
def iterative(data):
    return (_engine("jax", data, "iterative", num_rand_vec_trace=10),
            _engine("port", data, "iterative", num_rand_vec_trace=10))


def _check_vag_F(je, pe, y, u, F, a_j=None, a_p=None):
    nj, guj, gFj, bj = je.laplace_vag_F(
        u, y, F, je.zero_mode() if a_j is None else a_j)
    npt, gup, gFp, bp = pe.laplace_vag_F(
        u, torch.as_tensor(y), torch.as_tensor(F),
        pe.zero_mode() if a_p is None else a_p)
    assert abs(npt / nj - 1.0) < TOL
    assert _rel(gup, guj) < TOL
    assert _rel(gFp, gFj) < TOL
    assert _rel(bp.numpy(), bj) < 1e-10
    assert pe.last_num_mode_it == je.last_num_mode_it
    return bj, bp


def test_dense_engine_matches_jax(data, one_round):
    """The "cholesky" formulation (the LaGaBoost round's engines, two
    crossed groupings and a slope), cold and warm started."""
    je, pe = one_round["gj"]._engine, one_round["gp"]._engine
    assert isinstance(pe, VecchiaGroupedLaplaceEngine)
    assert pe.matrix_inversion_method == "cholesky"
    assert (pe.n_u, pe.q_total, pe.num_theta) == (je.n_u, je.q_total, 5)
    np.testing.assert_array_equal(pe.perm, je.perm)
    np.testing.assert_array_equal(pe._row_pos, je._row_pos)
    u = np.log(pe.transform_pars(PARS))
    F = 0.3 * np.sin(np.arange(N))
    bj, bp = _check_vag_F(je, pe, data["y"], u, F)
    _check_vag_F(je, pe, data["y"], u + 0.05, F, bj, bp)


def test_iterative_engine_matches_jax(data, iterative):
    """The matrix-free formulation with the same SLQ probes: NLL,
    gradients, mode, Newton steps and CG totals."""
    je, pe = iterative
    u = np.log(pe.transform_pars(PARS))
    F = 0.3 * np.sin(np.arange(N))
    bj, bp = _check_vag_F(je, pe, data["y"], u, F)
    assert pe.last_num_cg_it == je.last_num_cg_it > 0
    _check_vag_F(je, pe, data["y"], u + 0.05, F, bj, bp)
    assert pe.last_num_cg_it == je.last_num_cg_it
    assert pe.cg_stats()["solves"] > 0


def _p(pe, u, y):
    """p = (A, D, prior_dg, W) of the port engine at the zero mode."""
    with torch.no_grad():
        theta_log, aux = pe._split_u(torch.as_tensor(u))
        P, _ = pe._prior(theta_log)
        _, W = pe._d1_W_at(aux, torch.zeros(N), pe.zero_mode(),
                           torch.as_tensor(y))
    return P + (W,)


def test_ssor_sweep_matches_jax_and_is_jacobi_with_one_grouping(data):
    """The SSOR preconditioner's application with two crossed groupings
    and a slope against the JAX engine's (run eagerly, 1e-12), and equal
    to the vadu (Jacobi) block with one grouping."""
    import jax.numpy as jnp
    d = data
    je = _engine("jax", d, "iterative", cg_preconditioner_type="ssor")
    pe = _engine("port", d, "iterative", cg_preconditioner_type="ssor")
    u = np.log(pe.transform_pars(PARS))
    p = _p(pe, u, d["y"])
    r = np.random.RandomState(2).randn(pe.dim_mode)
    out_p = pe._precond(p)(torch.as_tensor(r)).numpy()
    out_j = np.asarray(je._precond_op(tuple(jnp.asarray(t.numpy())
                                            for t in p))(jnp.asarray(r)))
    assert _rel(out_p, out_j) < 1e-12
    # columns go through the same sweep
    R = np.random.RandomState(3).randn(pe.dim_mode, 3)
    out_c = pe._precond(p)(torch.as_tensor(R)).numpy()
    assert _rel(out_c[:, 1], pe._precond(p)(torch.as_tensor(
        R[:, 1])).numpy()) < 1e-14
    pe1 = _engine("port", d, "iterative", two=False,
                  cg_preconditioner_type="ssor")
    u1 = np.log(pe1.transform_pars(PARS[[0, 3, 4]]))
    p1 = _p(pe1, u1, d["y"])
    r1 = torch.as_tensor(r[:pe1.dim_mode])
    ssor = pe1._precond(p1)(r1)
    pe1.set_iterative_params(cg_preconditioner_type="vadu")
    assert _rel(ssor.numpy(), pe1._precond(p1)(r1).numpy()) < 1e-14


@pytest.mark.parametrize("pc", ["ssor", "diagonal", "jacobi", "none",
                                "Sigma_inv_plus_BtWB"])
def test_nll_under_each_preconditioner(data, iterative, pc):
    je, _ = iterative
    pe = _engine("port", data, "iterative", num_rand_vec_trace=10,
                 cg_preconditioner_type=pc)
    assert pe.cg_preconditioner_type == \
        {"jacobi": "diagonal", "Sigma_inv_plus_BtWB": "vadu"}.get(pc, pc)
    u = np.log(pe.transform_pars(PARS))
    F = 0.2 * np.cos(np.arange(N))
    # the JAX value from its (compiled) value-and-gradient
    nj = je.laplace_vag_F(u, data["y"], F, je.zero_mode())[0]
    npt, _ = pe.laplace_nll(u, data["y"], F, pe.zero_mode())
    assert abs(npt / nj - 1.0) < 1e-7
    assert pe.last_num_mode_it == je.last_num_mode_it


def test_unsupported_preconditioner_raises(data):
    with pytest.raises(ValueError, match="not supported"):
        _engine("port", data, "iterative",
                cg_preconditioner_type="pivoted_cholesky")
    gp = gpt.GPModel(**_gp_kw(data), device="cpu",
                     matrix_inversion_method="iterative", **MODEL)
    with pytest.raises(ValueError, match="not supported"):
        gp.set_optim_params({"cg_preconditioner_type": "fitc"})
    gp.set_optim_params({"cg_preconditioner_type": "ssor",
                         "num_rand_vec_trace": 7})
    assert (gp._engine.cg_preconditioner_type,
            gp._engine.num_rand_vec_trace) == ("ssor", 7)


@pytest.fixture(scope="module")
def predictions(data, one_round):
    """The JAX package's predictions at PARS on the LaGaBoost round's
    model, and the port's, latent and response."""
    gj, gp = one_round["gj"], one_round["gp"]
    pd_ = _pred_data(data)
    out = {}
    for key, kw in (("var", dict(predict_var=True, predict_response=False)),
                    ("cov", dict(predict_cov_mat=True,
                                 predict_response=False)),
                    ("resp", dict(predict_var=True, predict_response=True))):
        args = dict(y=data["y"], cov_pars=PARS, **pd_, **kw)
        out[key] = (gj.predict(**args), gp.predict(**args), args)
    return out


def test_predictions_match_jax(predictions):
    for key, (pj, pp, _) in predictions.items():
        assert _rel(pp["mu"], pj["mu"]) < TOL, key
        if key != "cov":
            assert _rel(pp["var"], pj["var"]) < TOL, key
    pj, pp, _ = predictions["cov"]
    assert pj["var"] is None and pp["var"] is None
    assert _rel(pp["cov"], pj["cov"]) < TOL
    # the new levels' rows (8 and 9 of the first grouping, 5 and 6 of the
    # second) carry their prior variances
    assert np.all(np.isfinite(pp["cov"]))


def test_iterative_predictions_match_dense(data, predictions):
    """The batched-CG variances against the dense factor's, at the CG
    tolerance."""
    gi = gpt.GPModel(**_gp_kw(data), device="cpu",
                     matrix_inversion_method="iterative", **MODEL)
    for key, (_, pp, args) in predictions.items():
        pi = gi.predict(**args)
        assert _rel(pi["mu"], pp["mu"]) < 1e-6, key
        if key == "cov":
            assert _rel(pi["cov"], pp["cov"]) < 1e-6
        else:
            assert _rel(pi["var"], pp["var"]) < 1e-6, key
    assert gi._engine.cg_stats()["at_maxit"] == 0


def test_training_random_effects_match_jax(one_round):
    gj, gp = one_round["gj"], one_round["gp"]
    tj = gj.predict_training_data_random_effects()
    tp = gp.predict_training_data_random_effects()
    assert list(tp) == list(tj.columns) == [
        "Group_1", "Group_2", "Group_3_rand_coef", "GP_4"]
    for k in tp:
        assert _rel(tp[k], tj[k].values) < TOL, k
    with pytest.raises(ValueError):
        gp.predict_training_data_random_effects(predict_var=True)


def test_lagaboost_round_matches_jax(data, one_round):
    o = one_round
    bj, gj, bp, gp = o["bj"], o["gj"], o["bp"], o["gp"]
    np.testing.assert_allclose(bp.init_score, bj.init_score, rtol=TOL)
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-7)
    assert gp.get_num_optim_iter() == gj.get_num_optim_iter()
    je = gj._engine
    r = gj._fit_result
    u = np.log(je.transform_pars(r.cov_pars))
    _, _, gFj, _ = je.laplace_vag_F(u, data["y"], np.full(N, bj.init_score),
                                    r.mode_state)
    assert _rel(o["grad"].numpy(), gFj) < 1e-7
    tj, tp = bj.trees[0], bp.trees[0]
    nn = tj.num_nodes
    internal = ~tj.is_leaf[:nn]
    assert tp.num_nodes == nn
    np.testing.assert_array_equal(tp.split_feature[:nn][internal],
                                  tj.split_feature[:nn][internal])
    np.testing.assert_allclose(bp.F.numpy(), bj.F, rtol=0, atol=1e-8)
    Xn = np.random.RandomState(5).rand(7, P)
    kw = dict(**_pred_data(data), predict_var=True)
    pj, pp = bj.predict(Xn, **kw), bp.predict(Xn, **kw)
    for k in ("response_mean", "response_var"):
        assert _rel(pp[k], pj[k]) < 1e-7, k


def test_model_dicts_both_ways(data, one_round, predictions):
    """JAX dicts load in the port and predict the JAX package's values; the
    port's dicts load in the JAX package as the same model (engine, trees
    and parameters)."""
    o = one_round
    pj, _, args = predictions["var"]
    gl = gp_model_from_jax_dict(o["gj"].model_to_dict(), device="cpu")
    assert isinstance(gl._engine, VecchiaGroupedLaplaceEngine)
    pl = gl.predict(**args)
    assert _rel(pl["mu"], pj["mu"]) < TOL and _rel(pl["var"], pj["var"]) \
        < TOL
    bl, _ = booster_from_jax_dict(o["bj"].model_to_dict(), device="cpu")
    Xn = np.random.RandomState(6).rand(5, P)
    kw = dict(**{k: v[:5] for k, v in _pred_data(data).items()},
              predict_var=True)
    assert _rel(bl.predict(Xn, **kw)["response_mean"],
                o["bp"].predict(Xn, **kw)["response_mean"]) < TOL
    lj = gpb.Booster(model_dict=o["bp"].model_to_dict())
    assert isinstance(lj.gp_model._engine, JaxEngine)
    np.testing.assert_allclose(lj.gp_model.get_cov_pars(),
                               o["gp"].get_cov_pars(), rtol=1e-12)
    np.testing.assert_allclose(
        lj.predict(Xn, ignore_gp_model=True, raw_score=True),
        o["bp"].predict(Xn, ignore_gp_model=True, raw_score=True),
        rtol=1e-12)


# ---------------------------------------------------------------------
# every likelihood: at m = n_u - 1 the Vecchia factorization is exact, so
# the combined engine equals the dense Laplace engine over the same
# components (which tests/test_torch_laplace.py and
# test_torch_grouped_laplace.py hold to the JAX package), duplicate
# coordinates included
_LIK_Y = {"bernoulli_probit": (None, "bin"), "bernoulli_logit": (None, "bin"),
          "binomial_logit": (None, "frac"), "binomial_probit": (None, "frac"),
          "poisson": (None, "cnt"), "gamma": (None, "pos"),
          "negative_binomial": (None, "cnt"),
          "negative_binomial_1": (None, "cnt"), "beta": (None, "frac"),
          "t": (None, "real"), "t_fix_df": (3.0, "real"),
          "lognormal": (None, "pos"), "tweedie": (None, "tw"),
          "tweedie_fixed_p": (1.3, "tw"), "asymmetric_laplace": (0.3, "real"),
          "gaussian_latent": (None, "real")}


@pytest.fixture(scope="module")
def lik_data():
    rng = np.random.RandomState(0)
    n = 80
    coords = rng.rand(40, 2)[rng.randint(0, 40, n)]
    g = rng.randint(0, 6, n)
    f = np.sin(4 * coords[:, 0]) + 0.5 * rng.randn(6)[g]
    y = {"bin": (rng.rand(n) < 1 / (1 + np.exp(-f))).astype(float),
         "frac": 0.98 * rng.rand(n) + 0.01,
         "cnt": rng.poisson(np.exp(f)).astype(float),
         "pos": rng.gamma(2.0, np.exp(f) / 2),
         "real": f + 0.5 * rng.randn(n),
         "tw": np.where(rng.rand(n) < 0.3, 0.0,
                        rng.gamma(2.0, np.exp(f) / 2))}
    return dict(n=n, coords=coords, g=g, y=y, w=0.5 + rng.rand(n))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(_LIK_Y))
def test_each_likelihood_matches_the_dense_laplace_engine(lik_data, name,
                                                          weighted):
    """NLL, g_u and g_F to rtol 1e-8 (the mode finders' stopping rule
    leaves negative_binomial_1 at ~1e-10). For t, t_fix_df and
    asymmetric_laplace, whose curvature W can be negative or zero, the
    dense engine's g_u parts from the precision form's by 1e-4 to 0.3 in
    the JAX package as well (ROADMAP C caveats): NLL and g_F only."""
    d = lik_data
    par, key = _LIK_Y[name]
    y, n = d["y"][key], d["n"]
    w = d["w"] if weighted else None

    def comps():
        return [GroupedComponent(d["g"], name="Group_1"),
                GPComponent(d["coords"], CovarianceFunction("exponential"),
                            name="GP")]

    ce = VecchiaGroupedLaplaceEngine(comps(), n, port_lik(name, par),
                                     num_neighbors=n, weights=w,
                                     device="cpu")
    de = LaplaceDenseEngine(comps(), n, port_lik(name, par), weights=w,
                            device="cpu")
    u = ce._u_from_pars([0.4, 0.9, 0.2], None, y)
    F = 0.2 * np.cos(np.arange(n))
    nc, guc, gFc, _ = ce.laplace_vag_F(u, y, F, ce.zero_mode())
    nd, gud, gFd, _ = de.laplace_vag_F(u, y, F, de.zero_mode())
    assert abs(nc / nd - 1.0) < TOL
    assert _rel(gFc, gFd) < TOL
    if name not in ("t", "t_fix_df", "asymmetric_laplace"):
        assert _rel(guc, gud) < TOL


# ---------------------------------------------------------------------
# the dispatch
def test_gaussian_runs_as_gaussian_latent(data, cb):  # noqa: F811
    """A Gaussian response with a Vecchia GP and grouped effects: the
    gaussian_latent likelihood, the nugget as its aux parameter (the
    parameter names of the JAX package), which at m = n - 1 gives the
    exact dense Gaussian engine's NLL; "auto" takes the iterative
    formulation above n = 8,000; cluster_ids raise."""
    kw = dict(gp_coords=cb["coords"], cov_function="exponential",
              group_data=cb["group"])
    pm = gpt.GPModel(gp_approx="vecchia", num_neighbors=cb["n"] - 1,
                     device="cpu", **kw)
    jm = gpb.GPModel(gp_approx="vecchia", num_neighbors=cb["n"] - 1, **kw)
    assert pm.likelihood == jm.likelihood == "gaussian_latent"
    assert pm.get_cov_par_names() == jm.get_cov_par_names() == [
        "Group_1", "GP_var", "GP_range"]
    nll = pm.neg_log_likelihood([0.9, 1.6, 0.2], cb["y"], aux_pars=[0.1])
    exact = gpt.GPModel(device="cpu", **kw).neg_log_likelihood(
        [0.1, 0.9, 1.6, 0.2], cb["y"])
    assert abs(nll / exact - 1.0) < 1e-9
    big = np.random.RandomState(0).rand(8001, 2)
    gb = gpt.GPModel(gp_coords=big, group_data=np.arange(8001) % 7,
                     gp_approx="vecchia", device="cpu")
    assert gb._engine.matrix_inversion_method == "iterative"
    with pytest.raises(NotImplementedError, match="cluster_ids"):
        gpt.GPModel(gp_approx="vecchia", cluster_ids=np.zeros(cb["n"]),
                    device="cpu", **kw)


def test_gpboost_is_lagaboost_over_gaussian_latent():
    """GPBoost with a Gaussian response on the combined model is LaGaBoost
    over gaussian_latent, as in the JAX package: the model loaded from a
    dict (its parameters held), one round against the JAX host loop."""
    rng = np.random.RandomState(3)
    n = 150
    c = rng.rand(40, 2)[rng.randint(0, 40, n)]
    g = rng.randint(0, 6, n)
    X = rng.rand(n, P)
    y = (np.sin(3 * X[:, 0]) + np.sin(5 * c[:, 0]) + 0.5 * rng.randn(6)[g]
         + 0.3 * rng.randn(n))
    d = dict(likelihood="gaussian_latent", cov_function="exponential",
             cov_fct_shape=1.5, gp_approx="vecchia", cov_pars=[0.3, 0.8, 0.2],
             aux_pars=[0.1], num_optim_iter=0, neg_log_likelihood=0.0,
             model_has_been_fitted=True, matrix_inversion_method="auto",
             seed=0, num_neighbors=M, vecchia_ordering="random",
             gp_coords=c.tolist(), group_data=g[:, None].tolist(),
             y=y.tolist())
    params = {**BOOST, "objective": "regression"}
    gj = gpb.GPModel(model_dict=dict(d))
    bj = gpb.train(params, gpb.Dataset(X, label=y), num_boost_round=1,
                   gp_model=gj, callbacks=[lambda env: None])
    gp = gpt.GPModel(model_dict=dict(d), device="cpu")
    bp = gpt.train(params, gpt.Dataset(X, label=y), num_boost_round=1,
                   gp_model=gp)
    assert bp.objective_name == gp.likelihood == "gaussian_latent"
    assert isinstance(gp._engine, VecchiaGroupedLaplaceEngine)
    np.testing.assert_allclose(bp.init_score, bj.init_score, rtol=TOL)
    np.testing.assert_allclose(bp.F.numpy(), bj.F, rtol=0, atol=1e-7)


def test_vecchia_latent_and_euclidean_match_jax():
    rng = np.random.RandomState(4)
    coords = rng.rand(150, 2)
    y = np.sin(4 * coords[:, 0]) + 0.3 * rng.randn(150)
    kw = dict(gp_coords=coords, cov_function="exponential", num_neighbors=M)
    jl = gpb.GPModel(gp_approx="vecchia_latent", **kw)
    pl = gpt.GPModel(gp_approx="vecchia_latent", device="cpu", **kw)
    assert isinstance(pl._engine, VecchiaLaplaceEngine)
    assert pl.likelihood == "gaussian_latent"
    assert pl.get_cov_par_names() == jl.get_cov_par_names()
    nj = jl.neg_log_likelihood([1.0, 0.2], y, aux_pars=[0.1])
    npt = pl.neg_log_likelihood([1.0, 0.2], y, aux_pars=[0.1])
    assert abs(npt / nj - 1.0) < TOL
    je = gpb.GPModel(gp_approx="vecchia_euclidean", **kw)
    pe = gpt.GPModel(gp_approx="vecchia_euclidean", device="cpu", **kw)
    nj = je.neg_log_likelihood([0.1, 1.0, 0.2], y)
    npt = pe.neg_log_likelihood([0.1, 1.0, 0.2], y)
    assert abs(npt / nj - 1.0) < TOL
    for approx in ("vecchia_latent", "vecchia_euclidean"):
        assert pe.gp_approx == "vecchia_euclidean"
        with pytest.raises(NotImplementedError, match="weights"):
            gpt.GPModel(gp_approx=approx, weights=np.ones(150),
                        device="cpu", **kw)
    with pytest.raises(ValueError, match="vecchia_latent"):
        gpt.GPModel(gp_approx="vecchia_latent", likelihood="poisson",
                    device="cpu", **kw)


def test_exact_gp_with_grouped_effects_gamma_matches_jax(data):
    """An exact GP with a grouped effect for a gamma likelihood: every
    component in the dense Laplace engine's Sigma."""
    d = data
    y = np.exp(0.5 * d["y"] + np.random.RandomState(7).rand(N))
    kw = dict(gp_coords=d["coords"], group_data=d["g"][:, 0],
              cov_function="exponential", likelihood="gamma")
    jm, pm = gpb.GPModel(**kw), gpt.GPModel(device="cpu", **kw)
    assert isinstance(pm._engine, LaplaceDenseEngine)
    pars = [0.5, 1.0, 0.15]
    nj = jm.neg_log_likelihood(pars, y, aux_pars=[1.2])
    npt = pm.neg_log_likelihood(pars, y, aux_pars=[1.2])
    assert abs(npt / nj - 1.0) < TOL
    pd_ = _pred_data(d)
    args = dict(y=y, cov_pars=pars, gp_coords_pred=pd_["gp_coords_pred"],
                group_data_pred=pd_["group_data_pred"][:, 0],
                predict_var=True, predict_response=False)
    jm.set_optim_params(params={"init_aux_pars": [1.2]})
    pm.set_optim_params(params={"init_aux_pars": [1.2]})
    pj, pp = jm.predict(**args), pm.predict(**args)
    assert _rel(pp["mu"], pj["mu"]) < TOL
    assert _rel(pp["var"], pj["var"]) < TOL


# ---------------------------------------------------------------------
# the goldens of tests/test_combined_gp_re_golden.py, the file's own test
# bodies with the port's GPModel (device="cpu") in place of the JAX one
class _PortGPModel(gpt.GPModel):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(*args, **kwargs)

    def predict_training_data_random_effects(self, *args, **kwargs):
        return pd.DataFrame(super().predict_training_data_random_effects(
            *args, **kwargs))


_FITS = {}


def _port_fit_gp_model(y, X=None, params=None, **kwargs):
    """fitGPModel on the port; a fit repeated with the same arguments (the
    golden file refits one model per test) is a copy of the first."""
    key = pickle.dumps((y, X, params, sorted(kwargs.items())))
    if key not in _FITS:
        m = _PortGPModel(**kwargs)
        m.fit(y=y, X=X, params=params)
        _FITS[key] = m
    return copy.deepcopy(_FITS[key])


GOLDENS = [
    ("TestCombinedGaussian", t) for t in (
        "test_nll", "test_lbfgs_estimation", "test_prediction",
        "test_training_data_random_effects",
        "test_weights_of_one_match_unweighted", "test_vecchia_nll",
        "test_vecchia_estimation", "test_vecchia_prediction",
        "test_vecchia_training_data_random_effects", "test_fisher_scoring",
        "test_duplicate_coords", "test_small_weights_manual",
        "test_small_weights_fit_with_X")] + [
    ("TestCombinedGamma", t) for t in (
        "test_nll", "test_estimation_no_aux", "test_estimation_with_aux",
        "test_prediction", "test_training_data_random_effects",
        "test_vecchia", "test_vecchia_estimation_prediction",
        "test_vecchia_fewer_neighbors")] + [
    ("TestCombinedT", t) for t in (
        "test_nll", "test_estimation_no_aux", "test_estimation_with_aux",
        "test_prediction", "test_vecchia", "test_vecchia_estimation_no_aux")
] + [("TestLinearRegressionTerm", "test_fit_and_predict"),
     ("TestClusterIds", "test_fisher_scoring"),
     ("TestClusterIds", "test_prediction")]


@pytest.mark.parametrize("cls,name", GOLDENS,
                         ids=[f"{c}.{t}" for c, t in GOLDENS])
def test_combined_golden_on_the_port(cls, name, cb, monkeypatch):  # noqa
    monkeypatch.setattr(golden, "GPModel", _PortGPModel)
    monkeypatch.setattr(golden, "fitGPModel", _port_fit_gp_model)
    obj = getattr(golden, cls)()
    fn = getattr(obj, name)
    if cls == "TestCombinedGamma":
        # the class's yg fixture
        from scipy.stats import gamma
        fn(cb, gamma.ppf(golden.sim_rand_unif(cb["n"], init_c=0.234),
                         a=0.5, scale=np.exp(cb["eps"])))
    else:
        fn(cb)
