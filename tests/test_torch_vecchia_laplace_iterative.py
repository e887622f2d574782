"""The matrix-free (iterative) Vecchia-Laplace engine of the PyTorch port,
Vecchia LaGaBoost on it and the iterative Woodbury branch, against the JAX
package (matrix_inversion_method="iterative"), on the CPU in float64.

* Engine at n = 300, m = 10, vadu, 10 probes: NLL, g_u and g_F to rtol
  1e-8, the mode to 1e-10, Newton steps and CG totals equal, from a cold
  and from a warm start; the NLL under each of the five preconditioners
  (rtol 1e-8 against the JAX engine with the same one; "none" and the
  aliases 1e-6 against the vadu engine), diag(Q) against the dense
  product (1e-13); predictions to 1e-8, their simulated
  variances (40 draws, the same RandomState draws, each a CG solve to
  cg_delta_conv = 1e-6 whose iterates the batched operator's summation
  order moves) to 1e-6.
* Two LaGaBoost rounds against the JAX host loop, the covariance
  parameters refitted each round (the default): the init score and the
  first fit (rtol 1e-8, equal iterations), the gradient in F (rtol 1e-8),
  the first tree; then the second round's warm-started GD refit
  (parameters and NLL rtol 1e-8, GD iterations equal, the mode finding's
  CG count at the refitted parameters equal), its gradient (rtol 1e-8)
  and the second tree.
* The port against itself: the iterative NLL, gradient and predictions
  against the dense-precision engine's at TOL_ITERATIVE = 1e-1 (the R
  suite's; with 10 probes the NLL holds to 7e-3 and the gradient to 8e-2
  here: the SLQ estimate's error, which the JAX package shares).
* A gamma likelihood with weights and a Matern kernel: NLL (rtol 1e-8),
  Newton steps equal and CG iterations within 5 % of the JAX engine's.
* The iterative grouped (Woodbury) branch at q = 50 against the JAX
  package: NLL and gradient (rtol 1e-8) and a fit (rtol 1e-6).
* set_optim_params reaches the CG settings, a model dict keeps the
  method; B'w is deterministic and takes no index_add_.

The JAX side builds one iterative engine per preconditioner; the
LaGaBoost round's GP model serves the engine, fit and prediction checks,
so its compiles stay few.
"""

import numpy as np
import pytest
import torch
from scipy.stats import norm

import gpboost_tpu as gpb
from gpboost_tpu.likelihoods.base import get_likelihood as jax_lik
from gpboost_tpu.models.components import GPComponent as JaxGP
from gpboost_tpu.models.vecchia_laplace import VecchiaLaplaceEngine as JaxVL
from gpboost_tpu.ops.cov_fcts import CovarianceFunction as JaxCov

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.likelihoods.base import get_likelihood as port_lik
from gpboost_tpu_torch.models.components import GPComponent
from gpboost_tpu_torch.models.vecchia_laplace import (
    VecchiaLaplaceEngine, VecchiaLaplaceIterativeEngine)
from gpboost_tpu_torch.ops.cov_fcts import CovarianceFunction

torch.set_num_threads(1)

TOL, TOL_ITERATIVE = 1e-8, 1e-1
N, M, P = 300, 10, 3
MODEL = dict(cov_function="exponential", likelihood="bernoulli_probit",
             gp_approx="vecchia", num_neighbors=M,
             matrix_inversion_method="iterative")
OPT = {"init_cov_pars": [1.0, 0.1], "maxit": 3, "num_rand_vec_trace": 10,
       "nsim_var_pred": 40}
BOOST = {"objective": "binary", "learning_rate": 0.1, "num_leaves": 7,
         "min_data_in_leaf": 5, "verbose": 0}


def _sim(n=N, seed=0):
    rng = np.random.RandomState(seed)
    coords = rng.rand(n, 2)
    X = rng.rand(n, P)
    lat = (np.sin(3 * X[:, 0]) + X[:, 1] ** 2 - 1.0
           + 0.8 * np.sin(6 * coords[:, 0]) * np.cos(4 * coords[:, 1]))
    y = (rng.rand(n) < norm.cdf(lat)).astype(float)
    return coords, X, y


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


class _Recorder:
    """Wraps a module's gd_fit_laplace_engine and keeps each refit's
    returns (the boosters drop its iteration count)."""

    def __init__(self, module):
        self.module, self.fn, self.calls = module, \
            module.gd_fit_laplace_engine, []

    def __enter__(self):
        def rec(*a, **k):
            out = self.fn(*a, **k)
            self.calls.append(out)
            return out

        self.module.gd_fit_laplace_engine = rec
        return self

    def __exit__(self, *exc):
        self.module.gd_fit_laplace_engine = self.fn


@pytest.fixture(scope="module")
def one_round():
    """One LaGaBoost round of each package on the same data with the
    default covariance refit: a full fit before the tree, the
    warm-started GD refit after it. Keeps each package's first fit and
    each refit's returns."""
    import gpboost_tpu.models.jit_gd as jax_gd
    import gpboost_tpu_torch.boosting.gbdt as port_gbdt
    coords, X, y = _sim()
    gj = gpb.GPModel(gp_coords=coords, **MODEL)
    gj.set_optim_params(params=OPT)
    fit, fits = gj.fit, []

    def keep_fit(*a, **k):
        out = fit(*a, **k)
        r = gj._fit_result
        fits.append((np.array(r.cov_pars), r.num_it, r.mode_state))
        return out

    gj.fit = keep_fit
    with _Recorder(jax_gd) as rj:
        bj = gpb.train(BOOST, gpb.Dataset(X, label=y), num_boost_round=1,
                       gp_model=gj, callbacks=[lambda env: None])
    gj.fit = fit
    gp = gpt.GPModel(gp_coords=coords, device="cpu", **MODEL)
    gp.set_optim_params(params=OPT)
    bp = gpt.Booster(BOOST, gpt.Dataset(X, label=y), gp_model=gp,
                     device="cpu")
    with _Recorder(port_gbdt) as rp:
        grad, _ = bp._gradients()
        first = (gp.get_cov_pars().copy(), gp.get_num_optim_iter())
        bp.update()
    return dict(bj=bj, gj=gj, bp=bp, gp=gp, grad=grad, first=first,
                first_j=fits[0], refit_j=rj.calls, refit_p=rp.calls,
                coords=coords, X=X, y=y)


def _trees_equal(tj, tp):
    nn = tj.num_nodes
    internal = ~tj.is_leaf[:nn]
    assert tp.num_nodes == nn
    np.testing.assert_array_equal(tp.split_feature[:nn][internal],
                                  tj.split_feature[:nn][internal])
    np.testing.assert_array_equal(tp.threshold_bin[:nn][internal],
                                  tj.threshold_bin[:nn][internal])


def test_one_lagaboost_round_matches_jax(one_round):
    o = one_round
    bj, gj, bp, gp, y = o["bj"], o["gj"], o["bp"], o["gp"], o["y"]
    cov_j, nit_j, mode_j = o["first_j"]
    assert isinstance(gp._engine, VecchiaLaplaceIterativeEngine)
    np.testing.assert_allclose(bp.init_score, bj.init_score, rtol=TOL)
    np.testing.assert_allclose(o["first"][0], cov_j, rtol=TOL)
    assert o["first"][1] == nit_j
    u = np.log(gj._engine.transform_pars(cov_j))
    _, _, gFj, _ = gj._engine.laplace_vag_F(
        u, y, np.full(N, bj.init_score), mode_j)
    assert _rel(o["grad"].numpy(), gFj) < TOL
    _trees_equal(bj.trees[0], bp.trees[0])
    np.testing.assert_allclose(bp.F.numpy(), bj.F, rtol=0, atol=1e-8)


def test_refit_round_matches_jax(one_round):
    """The round's warm-started GD refit of the covariance parameters at
    the tree's F (gd_fit_laplace_engine, maxit_gp 10): GD iterations equal
    and the NLL to rtol 1e-8; the parameters to rtol 1e-6 (3.8e-8 here).
    The last GD iteration's momentum step overshoots on both sides: all
    30 Armijo trials fail and the last, a step of lr 2^-30 times the
    first, is taken, with trial NLLs 1e-11 apart, below the NLL's
    rounding floor, so the returned learning rate (which the next round
    does not use: it restarts at lr_cov) and the parameters' last digits
    part. Then the next round's gradient in F at the refit (rtol 1e-6)
    with the mode finding's CG count equal."""
    o = one_round
    gj, bp, gp, y = o["gj"], o["bp"], o["gp"], o["y"]
    assert len(o["refit_j"]) == len(o["refit_p"]) == 1
    pj, _, nllj, _, itj, aj = o["refit_j"][0]
    pp, _, nllp, _, itp, _ = o["refit_p"][0]
    assert itp == itj > 1
    assert abs(nllp / nllj - 1.0) < TOL
    np.testing.assert_allclose(pp, pj, rtol=1e-6)
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-6)
    je, pe = gj._engine, gp._engine
    grad2, _ = bp._gradients()
    _, _, gFj, _ = je.laplace_vag_F(np.log(je.transform_pars(pj)), y,
                                    np.asarray(o["bj"].F), aj)
    assert _rel(grad2.numpy(), gFj) < 1e-6
    assert pe.last_num_cg_it == je.last_num_cg_it


def test_nll_gradients_newton_and_cg_match_jax(one_round):
    gj, gp, y = (one_round[k] for k in ("gj", "gp", "y"))
    je, pe = gj._engine, gp._engine
    u = np.log([0.9, 1.0 / 0.15])
    F = 0.3 * np.sin(np.arange(N))
    nj, guj, gFj, bj = je.laplace_vag_F(u, y, F, je.zero_mode())
    npt, gup, gFp, bp = pe.laplace_vag_F(u, y, F, pe.zero_mode())
    assert abs(npt / nj - 1.0) < TOL
    assert _rel(gup, guj) < TOL
    assert _rel(gFp, gFj) < TOL
    assert _rel(bp.numpy(), bj) < 1e-10
    assert pe.last_num_mode_it == je.last_num_mode_it
    assert pe.last_num_cg_it == je.last_num_cg_it
    assert gp.get_num_cg_steps() == gj.get_num_cg_steps()
    # from a warm start, y and F as tensors in data order
    nj2, bj2 = je.laplace_nll(u + 0.05, y, F, bj)
    np2, bp2 = pe.laplace_nll(u + 0.05, torch.as_tensor(y),
                              torch.as_tensor(F), bp)
    assert abs(np2 / nj2 - 1.0) < TOL
    assert _rel(bp2.numpy(), bj2) < 1e-10
    assert (pe.last_num_mode_it, pe.last_num_cg_it) == \
        (je.last_num_mode_it, je.last_num_cg_it)


@pytest.mark.parametrize("pc", ["vadu", "Sigma_inv_plus_BtWB",
                                "pivoted_cholesky", "vecchia_response",
                                "jacobi", "none"])
def test_nll_under_each_preconditioner_matches_jax(one_round, pc):
    """The CG preconditioner of the Newton solves (the SLQ log-determinant
    rides the vadu congruence under each): NLL and Newton steps equal the
    JAX engine's with the same preconditioner (rtol 1e-8); the aliases
    and "none" (no code of its own) are held to the JAX vadu engine's NLL
    at the CG tolerance's level (rtol 1e-6), which keeps the JAX compiles
    to three."""
    gj, gp, coords, y = (one_round[k] for k in ("gj", "gp", "coords", "y"))
    target = {"Sigma_inv_plus_BtWB": "vadu", "jacobi": "diagonal"}.get(pc,
                                                                       pc)
    own = pc in ("pivoted_cholesky", "vecchia_response", "jacobi")
    je = gj._engine
    if own:
        je = _JAX_PC.get(target)
        if je is None:
            je = _JAX_PC[target] = JaxVL(
                [JaxGP(coords, JaxCov("exponential"))], N,
                jax_lik("bernoulli_probit"), num_neighbors=M,
                matrix_inversion_method="iterative",
                cg_preconditioner_type=target, num_rand_vec_trace=10)
    pe = VecchiaLaplaceIterativeEngine(
        [GPComponent(coords, CovarianceFunction("exponential"))], N,
        port_lik("bernoulli_probit"), num_neighbors=M, device="cpu",
        cg_preconditioner_type=pc, num_rand_vec_trace=10)
    assert pe.cg_preconditioner_type == target
    u = np.log([0.8, 1.0 / 0.2])
    F = 0.2 * np.cos(np.arange(N))
    nj, _ = je.laplace_nll(u, y, F, je.zero_mode())
    npt, _ = pe.laplace_nll(u, y, F, pe.zero_mode())
    assert abs(npt / nj - 1.0) < (TOL if own or target == "vadu" else 1e-6)
    assert pe.last_num_mode_it == je.last_num_mode_it


def test_diag_of_Q_matches_the_dense_product(one_round):
    """The Jacobi preconditioner's diag(Q), Q = B' D^-1 B, against B built
    densely."""
    gp = one_round["gp"]
    pe = gp._engine
    A, D = pe._vecchia._bd(torch.tensor(np.log([0.9, 6.0])), latent=True)
    B = torch.eye(N, dtype=A.dtype)
    rows = torch.arange(N)[:, None].expand_as(A)
    B = B.index_put((rows, pe._vecchia._nn_idx), -A, accumulate=True)
    Q = B.T @ (B / D[:, None])
    assert _rel(pe._diag_Q(A, D).numpy(), torch.diagonal(Q).numpy()) < 1e-13


_JAX_PC = {}


def test_predictions_match_jax(one_round):
    """Neighbour-based means and simulated variances (40 draws of the
    JAX package's RandomState, each solve on its own convergence)."""
    gj, gp, y = (one_round[k] for k in ("gj", "gp", "y"))
    je, pe = gj._engine, gp._engine
    assert pe.nsim_var_pred == 40
    rng = np.random.RandomState(3)
    pred_data = {"comps": [{"coords_pred": rng.rand(15, 2)}], "n_pred": 15}
    F = 0.2 * np.cos(np.arange(N))
    F_pred = 0.1 * np.arange(15)
    for kw in (dict(), dict(predict_var=True, predict_response=True)):
        pj = je.predict([0.8, 0.2], None, y, F, pred_data, F_pred=F_pred,
                        **kw)
        pp = pe.predict([0.8, 0.2], None, y, F, pred_data, F_pred=F_pred,
                        **kw)
        assert set(pp) == set(pj)
        assert _rel(pp["mu"], pj["mu"]) < TOL
        if "var" in pj:
            assert _rel(pp["var"], pj["var"]) < 1e-6


def test_iterative_against_the_dense_engine(one_round):
    """The port's iterative path against its dense-precision path on the
    same data: NLL, gradient and predictions at TOL_ITERATIVE."""
    gp, coords, y = (one_round[k] for k in ("gp", "coords", "y"))
    pe = gp._engine
    de = VecchiaLaplaceEngine(
        [GPComponent(coords, CovarianceFunction("exponential"))], N,
        port_lik("bernoulli_probit"), num_neighbors=M, device="cpu")
    u = np.log([0.9, 1.0 / 0.15])
    F = np.zeros(N)
    ni, gi, _ = pe.laplace_vag(u, y, F, pe.zero_mode())
    nd, gd, _ = de.laplace_vag(u, y, F, de.zero_mode())
    assert abs(ni / nd - 1.0) < TOL_ITERATIVE
    assert _rel(gi, gd) < TOL_ITERATIVE
    pred_data = {"comps": [{"coords_pred": np.random.RandomState(4).rand(
        10, 2)}], "n_pred": 10}
    # the reference's default of 500 draws (40 leave a Monte Carlo error
    # of ~20 % in a variance)
    pe.set_iterative_params(nsim_var_pred=500)
    try:
        pi = pe.predict([0.9, 0.15], None, y, F, pred_data,
                        predict_var=True)
    finally:
        pe.set_iterative_params(nsim_var_pred=OPT["nsim_var_pred"])
    pd = de.predict([0.9, 0.15], None, y, F, pred_data, predict_var=True)
    assert np.max(np.abs(pi["mu"] - pd["mu"])) < TOL_ITERATIVE
    assert np.max(np.abs(pi["var"] - pd["var"])) < TOL_ITERATIVE


def test_aux_parameter_and_weights_match_jax():
    """A likelihood with an aux parameter (gamma), observation weights and
    a Matern 1.5 kernel on the iterative engine against the JAX engine:
    NLL (rtol 1e-8), Newton steps, CG iterations (within 5 %)."""
    rng = np.random.RandomState(1)
    n = 150
    coords = rng.rand(n, 2)
    y = rng.gamma(1.5, np.exp(np.sin(6 * coords[:, 0])) / 1.5)
    kw = dict(num_neighbors=8, weights=0.5 + rng.rand(n),
              matrix_inversion_method="iterative", num_rand_vec_trace=10)
    je = JaxVL([JaxGP(coords, JaxCov("matern", shape=1.5))], n,
               jax_lik("gamma"), **kw)
    pe = VecchiaLaplaceIterativeEngine(
        [GPComponent(coords, CovarianceFunction("matern", shape=1.5))], n,
        port_lik("gamma"), device="cpu", **kw)
    u = np.log([0.9, 3.0, 1.3])
    F = 0.2 * np.cos(np.arange(n))
    nj, _ = je.laplace_nll(u, y, F, je.zero_mode())
    npt, _ = pe.laplace_nll(u, y, F, pe.zero_mode())
    assert abs(npt / nj - 1.0) < TOL
    assert pe.last_num_mode_it == je.last_num_mode_it
    # the last Newton steps solve for a gradient near zero, where rounding
    # moves a count by a few iterations (the mode agrees to 1e-13)
    assert abs(pe.last_num_cg_it - je.last_num_cg_it) \
        <= 0.05 * je.last_num_cg_it


def test_grouped_iterative_branch_matches_jax():
    """The iterative Woodbury branch (CG solve, SLQ log|A| over 200
    probes) at q = 50 (two crossed groupings, n = 200)."""
    rng = np.random.RandomState(7)
    n = 200
    g = np.column_stack([rng.randint(0, 30, n), rng.randint(0, 20, n)])
    y = 0.6 * rng.randn(30)[g[:, 0]] + 0.4 * rng.randn(20)[g[:, 1]] \
        + rng.randn(n)
    mj = gpb.GPModel(group_data=g, matrix_inversion_method="iterative")
    mp = gpt.GPModel(group_data=g, matrix_inversion_method="iterative",
                     device="cpu")
    assert mp._engine.matrix_inversion_method == "iterative"
    u = np.log([0.9, 0.4, 0.2])
    vj, gj_ = mj._engine.vag_full(u, y)
    vp, gp_ = mp._engine.vag_full(u, mp._engine.prep_y(y))
    assert abs(float(vp) / float(vj) - 1.0) < TOL
    assert _rel(gp_, gj_) < TOL
    mj.fit(y=y)
    mp.fit(y=y)
    np.testing.assert_allclose(mp.get_cov_pars(), mj.get_cov_pars(),
                               rtol=1e-6)
    # the Cholesky branch within the SLQ estimate's error
    mc = gpt.GPModel(group_data=g, device="cpu")
    vc, _ = mc._engine.vag_full(u, mc._engine.prep_y(y))
    assert abs(float(vp) / float(vc) - 1.0) < 1e-2


def test_options_reach_the_engine_and_bw_is_deterministic(one_round):
    gp, coords, y = (one_round[k] for k in ("gp", "coords", "y"))
    m = gpt.GPModel(gp_coords=coords, device="cpu", **MODEL)
    eng = m._engine
    m.set_optim_params(params={
        "cg_delta_conv": 1e-4, "cg_max_num_it": 77,
        "num_rand_vec_trace": 7, "seed_rand_vec_trace": 5,
        "nsim_var_pred": 33, "piv_chol_rank": 9,
        "cg_preconditioner_type": "piv_chol_on_Sigma_nn"})
    assert (eng.cg_delta_conv, eng.cg_max_num_it, eng.num_rand_vec_trace,
            eng.seed_rand_vec_trace, eng.nsim_var_pred, eng.piv_chol_rank,
            eng.cg_preconditioner_type) == (1e-4, 77, 7, 5, 33, 9,
                                            "pivoted_cholesky")
    assert eng._slq().spec.probes.shape == (N, 7)
    with pytest.raises(ValueError, match="cg_preconditioner_type"):
        m.set_optim_params(params={"cg_preconditioner_type": "ssor"})
    with pytest.raises(ValueError, match="no CG solve"):
        m.get_num_cg_steps()
    eng.cg_stats(reset=True)
    m.neg_log_likelihood(cov_pars=[0.9, 0.15], y=y)
    assert m.get_num_cg_steps() == eng.last_num_cg_it > 0
    assert m.get_total_num_cg_steps() == eng.total_num_cg_it
    # every Newton step's solve is one column; no solve reached maxit
    st = eng.cg_stats(reset=True)
    assert st["solves"] == eng.last_num_mode_it
    assert st["iterations"] == eng.last_num_cg_it and st["at_maxit"] == 0
    assert eng.cg_stats() == {"solves": 0, "iterations": 0, "at_maxit": 0}
    # a model dict keeps the method (and the settings' defaults)
    back = gpt.GPModel(model_dict=gp.model_to_dict(), device="cpu")
    assert isinstance(back._engine, VecchiaLaplaceIterativeEngine)
    np.testing.assert_allclose(back.get_cov_pars(), gp.get_cov_pars())
    # the dense engine ignores the CG keys and has no CG count
    md = gpt.GPModel(gp_coords=coords, device="cpu",
                     **{**MODEL, "matrix_inversion_method": "cholesky"})
    md.set_optim_params(params={"cg_delta_conv": 1e-3})
    with pytest.raises(ValueError, match="no CG solve"):
        md.get_num_cg_steps()
    # B'w: no index_add_, the same bits twice, with and without a graph
    pe = gp._engine
    A, D = pe._vecchia._bd(torch.tensor(np.log([0.9, 6.0])), latent=True)
    W = torch.as_tensor(np.random.RandomState(1).rand(N, 4))

    def refuse(*a, **k):
        raise AssertionError("index_add_ in B'w")

    saved = torch.Tensor.index_add_, torch.Tensor.index_add, torch.index_add
    torch.Tensor.index_add_ = torch.Tensor.index_add = refuse
    torch.index_add = refuse
    try:
        for w in (W[:, 0], W):
            with torch.no_grad():
                r1, r2 = pe._Btv(A, w), pe._Btv(A, w)
            assert torch.equal(r1, r2)
            Ag = A.detach().requires_grad_(True)
            r3 = pe._Btv(Ag, w)
            (g1,) = torch.autograd.grad(r3.sum(), Ag)
            assert _rel(r3.detach().numpy(), r1.numpy()) < 1e-14
            assert torch.isfinite(g1).all()
        pe.laplace_vag(np.log([0.9, 1.0 / 0.15]), y, np.zeros(N),
                       pe.zero_mode())
    finally:
        (torch.Tensor.index_add_, torch.Tensor.index_add,
         torch.index_add) = saved
