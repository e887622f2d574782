"""Vecchia GP engine of the PyTorch port against the JAX package.

The same coordinates and response (numpy, seeded) go through
gpboost_tpu.models.vecchia.VecchiaGaussianEngine and the port's engine at
n = 300, m = 10, float64. Both run the same host ordering and neighbour
search; they differ only in the batched Cholesky (the reference's unrolled
column sweep against LAPACK), so NLL values and gradients agree to
rtol 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpboost_tpu.boosting.gbdt import _psi_tilde_inv_mat as jax_psi_inv_mat
from gpboost_tpu.models.components import GPComponent as JaxGPComponent
from gpboost_tpu.models.jit_gd import gd_fit_engine as jax_gd_fit_engine
from gpboost_tpu.models.vecchia import VecchiaGaussianEngine as JaxEngine
from gpboost_tpu.ops.cov_fcts import CovarianceFunction as JaxCov
import gpboost_tpu as gpb

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models.components import GPComponent
from gpboost_tpu_torch.models.jit_gd import gd_fit_engine
from gpboost_tpu_torch.models.vecchia import VecchiaGaussianEngine
from gpboost_tpu_torch.ops.batched_chol import cho_solve_batched
from gpboost_tpu_torch.ops.cov_fcts import CovarianceFunction

torch.set_num_threads(1)

N, M = 300, 10
THETA = np.log([2.0, 4.0])            # log([v / sigma2, alpha])
PARS = np.array([0.3, 0.6, 0.25])     # [sigma2, var, range]


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(3)
    coords = rng.rand(N, 2)
    y = np.sin(5 * coords[:, 0]) * np.cos(3 * coords[:, 1]) \
        + 0.4 * rng.randn(N)
    return coords, y


def _engines(coords, cov, shape):
    je = JaxEngine([JaxGPComponent(coords, JaxCov(cov, shape=shape))], N,
                   num_neighbors=M, seed=0)
    pe = VecchiaGaussianEngine(
        [GPComponent(coords, CovarianceFunction(cov, shape=shape))], N,
        num_neighbors=M, seed=0, device="cpu")
    return je, pe


@pytest.fixture(scope="module")
def engines(data):
    return _engines(data[0], "exponential", None)


@pytest.mark.parametrize("cov,shape", [("exponential", None), ("matern", 0.5),
                                       ("matern", 1.5), ("matern", 2.5)])
def test_profiled_nll_and_gradient_match(data, cov, shape):
    coords, y = data
    je, pe = _engines(coords, cov, shape)
    np.testing.assert_array_equal(pe.perm, je.perm)
    np.testing.assert_array_equal(pe._nn_idx.numpy(), np.asarray(je._nn_idx))
    np.testing.assert_array_equal(pe._nn_mask.numpy(),
                                  np.asarray(je._nn_mask))
    (jn, jq), jg = je.nll_profiled_vag(jnp.asarray(THETA),
                                       jnp.asarray(y[je.perm]))
    (pn, pq), pg = pe.nll_profiled_vag(THETA, pe.prep_y(y))
    np.testing.assert_allclose(pn, float(jn), rtol=1e-10)
    np.testing.assert_allclose(pq, float(jq), rtol=1e-10)
    np.testing.assert_allclose(pg, np.asarray(jg), rtol=1e-10)


def test_nll_at_fixed_nugget_matches(data, engines):
    _, y = data
    je, pe = engines
    jv, jg = je.grad_profiled(jnp.asarray(THETA), jnp.asarray(0.3),
                              jnp.asarray(y[je.perm]))
    yp = pe.prep_y(y)
    np.testing.assert_allclose(pe.nll_parts(THETA, 0.3, yp)[0], float(jv),
                               rtol=1e-10)
    np.testing.assert_allclose(pe.nll_grad(THETA, 0.3, yp), np.asarray(jg),
                               rtol=1e-10)
    np.testing.assert_allclose(pe.neg_log_likelihood(PARS, y),
                               je.neg_log_likelihood(PARS, y), rtol=1e-10)


def test_original_scale_gradient_matches(data, engines):
    _, y = data
    je, pe = engines
    lp = np.log(PARS)
    jv, jg = je.nll_orig_vag(jnp.asarray(lp), jnp.asarray(y[je.perm]))
    pv, pg = pe.nll_orig_vag(lp, pe.prep_y(y))
    np.testing.assert_allclose(pv, float(jv), rtol=1e-10)
    np.testing.assert_allclose(pg, np.asarray(jg), rtol=1e-10)


def test_cho_solve_vjp_gradcheck():
    rng = np.random.RandomState(0)
    S = torch.tensor(rng.randn(4, 5, 5), dtype=torch.float64,
                     requires_grad=True)
    b = torch.tensor(rng.randn(4, 5), dtype=torch.float64,
                     requires_grad=True)
    eye = torch.eye(5, dtype=torch.float64)

    def f(S, b):      # SPD, built symmetrically as the engine builds K
        return cho_solve_batched(S @ S.transpose(1, 2) + 5.0 * eye, b)

    assert torch.autograd.gradcheck(f, (S, b))
    K = S.detach() @ S.detach().transpose(1, 2) + 5.0 * eye
    x = cho_solve_batched(K, b.detach())
    torch.testing.assert_close(K @ x[:, :, None], b.detach()[:, :, None])


def test_cho_solve_second_derivative_and_one_factorization(monkeypatch):
    """The batched solve is twice differentiable (Newton's Hessian), and
    its first-order backward factorizes nothing: one Cholesky per forward,
    none in a backward, the double backward's solve reuses it."""
    from gpboost_tpu_torch.ops import batched_chol
    rng = np.random.RandomState(1)
    S = torch.tensor(rng.randn(3, 4, 4), dtype=torch.float64,
                     requires_grad=True)
    b = torch.tensor(rng.randn(3, 4), dtype=torch.float64,
                     requires_grad=True)
    eye = torch.eye(4, dtype=torch.float64)

    def f(S, b):
        return cho_solve_batched(S @ S.transpose(1, 2) + 4.0 * eye, b)

    assert torch.autograd.gradgradcheck(f, (S, b))
    calls = []
    chol = batched_chol._chol
    monkeypatch.setattr(batched_chol, "_chol",
                        lambda K: calls.append(1) or chol(K))
    x = f(S, b)
    assert len(calls) == 1
    (gS,) = torch.autograd.grad((x ** 2).sum(), S, create_graph=True)
    assert len(calls) == 1
    torch.autograd.grad(gS.sum(), (S, b))
    assert len(calls) == 1


@pytest.fixture(scope="module")
def newton_data():
    """The input of ROADMAP C1's probe: n = 300, exponential kernel."""
    rng = np.random.RandomState(1)
    coords = rng.rand(N, 2)
    return coords, np.sin(4 * coords[:, 0]) + 0.3 * rng.randn(N)


@pytest.mark.parametrize("m", [20, 40])
def test_newton_fit_matches_jax(newton_data, m):
    """optimizer_cov="newton" on the Vecchia engine (m = 20 and m > 32):
    the Hessian of the NLL at the start (rtol 1e-8), the iteration count
    and the optimum (rtol 1e-6) of the JAX package's fit."""
    coords, y = newton_data
    kw = dict(gp_coords=coords, cov_function="exponential",
              gp_approx="vecchia", num_neighbors=m)
    jm = gpb.GPModel(**kw)
    pm = gpt.GPModel(device="cpu", **kw)
    jm.fit(y=y, params={"optimizer_cov": "newton"})
    pm.fit(y=y, params={"optimizer_cov": "newton"})
    assert pm.get_num_optim_iter() == jm.get_num_optim_iter()
    np.testing.assert_allclose(pm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    np.testing.assert_allclose(pm.get_current_neg_log_likelihood(),
                               jm.get_current_neg_log_likelihood(),
                               rtol=1e-10)
    je, pe = jm._engine, pm._engine
    u = np.log(je.transform_pars(np.asarray([0.3, 0.6, 0.25])))
    Hj = np.asarray(je.hess_full(jnp.asarray(u), jnp.asarray(y[je.perm])))
    Hp = pe.hess_full(u, pe.prep_y(y))
    np.testing.assert_allclose(Hp, Hj, rtol=1e-8, atol=1e-10)


def test_not_positive_definite_rows_come_out_nan():
    K = torch.eye(3, dtype=torch.float64).repeat(2, 1, 1)
    K[1, 0, 0] = -1.0
    x = cho_solve_batched(K, torch.ones(2, 3, dtype=torch.float64))
    assert torch.isfinite(x[0]).all() and torch.isnan(x[1]).all()


def test_psi_tilde_inverse_matches(data, engines):
    je, pe = engines
    rng = np.random.RandomState(4)
    Mat = rng.randn(N, 3)
    t = je.transform_pars(PARS)
    ref = jax_psi_inv_mat(je, t, Mat)
    out = pe.psi_tilde_inv_mat(t, torch.as_tensor(Mat)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-12)


def test_prediction_matches(data, engines):
    _, y = data
    je, pe = engines
    cp = np.random.RandomState(5).rand(40, 2)
    pd = {"comps": [{"coords_pred": cp}]}
    for resp in (True, False):
        ref = je.predict(PARS, y, pd, predict_var=True, predict_response=resp)
        out = pe.predict(PARS, y, pd, predict_var=True, predict_response=resp)
        np.testing.assert_allclose(out["mu"], ref["mu"], rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(out["var"], ref["var"], rtol=1e-10)


def test_warm_started_gd_refit_matches(data, engines):
    _, y = data
    je, pe = engines
    ref = jax_gd_fit_engine(je, PARS, y, lr0=0.1, max_iter=10)
    out = gd_fit_engine(pe, PARS, y, lr0=0.1, max_iter=10)
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-8)
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-10)
    assert out[3] == ref[3]
    np.testing.assert_allclose(out[2], ref[2], rtol=1e-12)


def test_lbfgs_fit_matches(data):
    coords, y = data
    jm = gpb.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=M)
    jm.fit(y=y)
    pm = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=M, device="cpu")
    pm.fit(y=y)
    np.testing.assert_allclose(pm.get_cov_pars(), jm.get_cov_pars(),
                               rtol=1e-6)
    np.testing.assert_allclose(pm.get_current_neg_log_likelihood(),
                               jm.get_current_neg_log_likelihood(),
                               rtol=1e-10)
    cp = coords[:20] + 0.01
    ref = jm.predict(gp_coords_pred=cp, predict_var=True)
    out = pm.predict(gp_coords_pred=cp, predict_var=True)
    np.testing.assert_allclose(out["mu"], ref["mu"], rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(out["var"], ref["var"], rtol=1e-5)
    assert pm.reset_fit().y is None and not pm.model_has_been_fitted
    with pytest.raises(RuntimeError):
        pm.get_cov_pars()


@pytest.mark.parametrize("kwargs", [
    # the gaussian kernel and general Matern shapes are ported
    # (tests/test_torch_cov_breadth.py): test_ported_kernels_match_jax
    pytest.param(kw, id=f"kwargs{i + 2}") for i, kw in enumerate([
        # FITC is ported (tests/test_torch_fitc.py), and so is a Vecchia
        # GP with grouped random effects
        # (tests/test_torch_vecchia_grouped.py), but not with cluster_ids
        dict(group_data=np.arange(N) % 5, cluster_ids=np.zeros(N)),
        dict(likelihood="bernoulli_probit",
             matrix_inversion_method="iterative", cluster_ids=np.zeros(N)),
        # cluster_ids are ported (tests/test_torch_vecchia_pred.py); GP
        # random coefficients run on the dense engines only, as in the
        # reference, whose Vecchia engine takes one GP component
        dict(gp_rand_coef_data=np.ones(N))])])
def test_unported_options_raise(data, kwargs):
    args = dict(gp_coords=data[0], cov_function="matern", gp_approx="vecchia",
                device="cpu")
    args.update(kwargs)
    with pytest.raises(NotImplementedError):
        gpt.GPModel(**args)


@pytest.mark.parametrize("kwargs", [
    pytest.param(dict(cov_function="gaussian"), id="kwargs0"),
    pytest.param(dict(cov_fct_shape=1.0), id="kwargs1")])
def test_ported_kernels_match_jax(data, kwargs):
    """The two models that raised before the covariance breadth was
    ported now build and give the JAX package's NLL (rtol 1e-10; the
    general shape through Bessel K, 1e-9)."""
    args = dict(gp_coords=data[0], cov_function="matern", gp_approx="vecchia",
                num_neighbors=M)
    args.update(kwargs)
    pm = gpt.GPModel(**args, device="cpu")
    jm = gpb.GPModel(**args)
    nll = pm.neg_log_likelihood(cov_pars=PARS, y=data[1])
    np.testing.assert_allclose(
        nll, jm.neg_log_likelihood(cov_pars=PARS, y=data[1]),
        rtol=1e-10 if "cov_function" in kwargs else 1e-9)
