"""The iterative tapering / full-scale tapering (FSA) and full-scale
Vecchia (FSVA) engines of the PyTorch port against the JAX package.

models/fsa_iterative.py and models/fsva_iterative.py against
gpboost_tpu.models.fsa_iterative / .fsva_iterative at n = 300 with
matrix_inversion_method="iterative", float64. Both packages draw the same
SLQ probes (RandomState(seed_rand_vec_trace)), so the stochastic
log-determinant is the same estimate: the NLL agrees to rtol 1e-8 and its
gradient to rtol 1e-5 (CG iterates at tolerance 1e-6 round apart),
the FSVA predictions with variances and the training random effects
(with inducing points) to 1e-6.
The correlation-based VIF neighbours are those of the dense adapter,
held to the JAX package's in tests/test_torch_taper.py. Against the
port's own dense adapter path (models/gaussian_gp.py with
ops/taper.py), which evaluates the same approximation exactly, the NLL
holds to TOLERANCE_ITERATIVE (the SLQ's probe noise) and the CG-solved predictions to 1e-5, the gradient in direction (cosine
above 0.9: the stochastic trace has 50 probes). The n > 8,000 dispatch
rule and the rebuild of the solvers by the CG parameters are shown
without a fit.
"""

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models.fsa_iterative import FSAIterativeGaussianEngine
from gpboost_tpu_torch.models.fsva_iterative import (
    FSVAIterativeGaussianEngine)
from gpboost_tpu_torch.models.gaussian_gp import DenseGaussianEngine

from conftest import TOLERANCE_ITERATIVE

torch.set_num_threads(1)

N = 300
PARS = [0.1, 1.2, 0.2]
APPROXES = {
    "tapering": dict(cov_fct_taper_range=0.15, cov_fct_taper_shape=1.0),
    "full_scale_tapering": dict(cov_fct_taper_range=0.15,
                                cov_fct_taper_shape=1.0, num_ind_points=50),
    "full_scale_vecchia": dict(num_ind_points=50, num_neighbors=15),
    "full_scale_vecchia_correlation_based": dict(num_ind_points=40,
                                                 num_neighbors=10),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    coords = rng.uniform(size=(N, 2))
    D = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    y = np.linalg.cholesky(1.2 * np.exp(-D / 0.2)
                           + 0.1 * np.eye(N)) @ rng.normal(size=N)
    return coords, y, rng.uniform(size=(7, 2))


def _kw(coords, approx, mim="iterative"):
    return dict(gp_coords=coords, cov_function="exponential",
                gp_approx=approx, matrix_inversion_method=mim,
                **APPROXES[approx])


@pytest.mark.parametrize("approx", ["tapering", "full_scale_tapering",
                                    "full_scale_vecchia"])
def test_iterative_engine_matches_jax(data, approx):
    coords, y, cp = data
    mj = gpb.GPModel(**_kw(coords, approx))
    mt = gpt.GPModel(device="cpu", **_kw(coords, approx))
    engine = FSVAIterativeGaussianEngine if "vecchia" in approx \
        else FSAIterativeGaussianEngine
    assert isinstance(mt._engine, engine)
    assert type(mj._engine).__name__ == engine.__name__
    et = mt._engine
    t = et.transform_pars(PARS)
    (vj, qj), gj = mj._engine.nll_profiled_vag(np.log(t[1:]), y)
    (vt, qt), gt_ = et.nll_profiled_vag(np.log(t[1:]), et.prep_y(y))
    np.testing.assert_allclose(vt, float(vj), rtol=1e-8)
    np.testing.assert_allclose(qt, float(qj), rtol=1e-8)
    np.testing.assert_allclose(gt_, np.asarray(gj), rtol=1e-5)
    stats = et.cg_stats(reset=True)
    assert stats["solves"] > 0 and stats["at_maxit"] == 0
    if approx == "tapering":
        return      # predictions: the FSA engine's path, without the rank
    if approx == "full_scale_vecchia":
        # the FSA engine's predictions are held to the dense adapter's
        # below, and those to the JAX package's in test_torch_taper.py:
        # the JAX package's FSA cross covariances compile op by op (~8 s)
        pj = mj.predict(y=y, gp_coords_pred=cp, cov_pars=PARS,
                        predict_var=True, predict_response=False)
        pt = mt.predict(y=y, gp_coords_pred=cp, cov_pars=PARS,
                        predict_var=True, predict_response=False)
        for k in ("mu", "var"):
            np.testing.assert_allclose(pt[k], np.asarray(pj[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    rj, _ = mj._engine.training_re(PARS, y)
    rt, _ = et.training_re(PARS, y)
    np.testing.assert_allclose(rt, np.asarray(rj), rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="predict_var"):
        et.training_re(PARS, y, predict_var=True)
    with pytest.raises(NotImplementedError, match="cholesky"):
        et.psi_tilde_inv_mat(t, torch.zeros((N, 1), dtype=torch.float64))


@pytest.mark.parametrize("approx", ["full_scale_tapering",
                                    "full_scale_vecchia",
                                    "full_scale_vecchia_correlation_based"])
def test_iterative_against_dense_adapter(data, approx):
    coords, y, cp = data
    mi = gpt.GPModel(device="cpu", **_kw(coords, approx))
    md = gpt.GPModel(device="cpu", **_kw(coords, approx, "cholesky"))
    assert isinstance(md._engine, DenseGaussianEngine)
    t = mi._engine.transform_pars(PARS)
    (vi, _), gi = mi._engine.nll_profiled_vag(np.log(t[1:]),
                                              mi._engine.prep_y(y))
    (vd, _), gd = md._engine.nll_profiled_vag(np.log(t[1:]),
                                              md._engine.prep_y(y))
    np.testing.assert_allclose(vi, vd, rtol=TOLERANCE_ITERATIVE)
    # the gradient's stochastic trace (50 probes) keeps its direction
    assert gi @ gd / (np.linalg.norm(gi) * np.linalg.norm(gd)) > 0.9
    kw = dict(y=y, gp_coords_pred=cp, cov_pars=PARS, predict_response=False)
    for extra in (dict(predict_var=True), dict(predict_cov_mat=True)):
        oi, od = mi.predict(**kw, **extra), md.predict(**kw, **extra)
        for k in ("mu", "var", "cov"):
            if od.get(k) is not None:
                np.testing.assert_allclose(oi[k], od[k], rtol=1e-5,
                                           atol=1e-5, err_msg=k)
    if approx != "full_scale_tapering":
        return
    # linear covariates through the same solves, and a short fit
    X = np.column_stack([np.ones(N), np.linspace(-1, 1, N)])
    mi.fit(y=y + X @ [1.5, -0.7], X=X,
           params={"optimizer_cov": "lbfgs", "maxit": 5,
                   "init_cov_pars": [0.2, 1.0, 0.15]})
    assert np.all(np.isfinite(mi.get_cov_pars()))
    # the GP absorbs part of the intercept; the slope is identified
    np.testing.assert_allclose(mi.get_coef()[1], -0.7, atol=0.25)


def test_dispatch_and_cg_rebuild():
    """auto takes the iterative engines above n = 8,000 (gp_model.py:
    273-335), for an isotropic single GP without weights or clusters; the
    CG parameters rebuild the solvers (gp_model.py:576-600)."""
    rng = np.random.RandomState(3)
    big = rng.rand(8001, 2)
    kw = dict(cov_function="exponential", device="cpu")
    m = gpt.GPModel(gp_coords=big, gp_approx="full_scale_tapering",
                    cov_fct_taper_range=0.02, num_ind_points=20,
                    ind_points_selection="random", **kw)
    assert isinstance(m._engine, FSAIterativeGaussianEngine)
    m = gpt.GPModel(gp_coords=big, gp_approx="full_scale_vecchia",
                    num_ind_points=20, num_neighbors=5,
                    ind_points_selection="random", **kw)
    assert isinstance(m._engine, FSVAIterativeGaussianEngine)
    small = rng.rand(200, 2)
    for approx in ("tapering", "full_scale_vecchia"):
        assert isinstance(gpt.GPModel(gp_coords=small, gp_approx=approx,
                                      num_ind_points=20, **kw)._engine,
                          DenseGaussianEngine)
    # weights are refused off none/vecchia/fitc (gp_model.py:261-266)
    with pytest.raises(NotImplementedError, match="weights"):
        gpt.GPModel(gp_coords=small, gp_approx="tapering",
                    weights=np.ones(200), **kw)
    m = gpt.GPModel(gp_coords=small, gp_approx="full_scale_tapering",
                    num_ind_points=20, cov_fct_taper_range=0.1,
                    matrix_inversion_method="iterative", **kw)
    eng = m._engine
    solve, slq = eng._solve, eng._slq
    # nsim_var_pred and piv_chol_rank are accepted and have no use here
    m.set_optim_params({"cg_max_num_it": 7, "num_rand_vec_trace": 9,
                        "cg_preconditioner_type":
                        "predictive_process_plus_diagonal",
                        "nsim_var_pred": 40, "piv_chol_rank": 9})
    assert (eng.cg_max_num_it, eng.num_rand_vec_trace,
            eng.cg_preconditioner_type) == (7, 9, "fitc")
    assert eng._solve is not solve and eng._slq is not slq
    assert eng._slq.spec.probes.shape == (200, 9)
    with pytest.raises(ValueError, match="cg_preconditioner_type"):
        m.set_optim_params({"cg_preconditioner_type": "vadu"})
    m.set_optim_params({"cg_preconditioner_type": "none"})
    t = eng.transform_pars(PARS)
    nll, _ = eng.nll_parts(np.log(t[1:]), t[0], eng.prep_y(small[:, 0]))
    assert np.isfinite(nll)
    assert eng.cg_stats()["at_maxit"] > 0       # cg_max_num_it = 7 binds
    # GPBoost has no Psi~^-1 on the iterative engines (the JAX package
    # raises at gbdt.py:2435)
    m.set_optim_params({"maxit": 1, "init_cov_pars": PARS})
    with pytest.raises(NotImplementedError, match="GPBoost"):
        gpt.train({"objective": "regression", "verbose": 0},
                  gpt.Dataset(rng.rand(200, 2), label=small[:, 0]),
                  num_boost_round=1, gp_model=m)
