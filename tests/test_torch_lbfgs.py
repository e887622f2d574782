"""The device L-BFGS of the PyTorch port against the JAX package.

ops/lbfgs.py `lbfgs_run` runs the reference's algorithm
(gpboost_tpu/ops/lbfgs.py) as a host loop over device tensors; on the same
objective in float64 the iterates agree to 1e-10 and the iteration counts
are equal. Through `fit`, use_device_optimizer=True takes it for the dense
and Vecchia engines (n = 100, float64): the same num_it as the JAX package
and covariance parameters to rtol 1e-6. The default dispatch takes it from
n = 20,000, as the reference does (optimize.py:1077-1090); a patched
threshold shows it without a 20,000-row fit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gpboost_tpu as gpb
from gpboost_tpu.ops.lbfgs import lbfgs_run as jax_lbfgs_run

import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.models import optimize as port_optimize
from gpboost_tpu_torch.ops.lbfgs import lbfgs_run

torch.set_num_threads(1)

N = 100
X0 = np.array([-1.2, 1.0, -0.5, 0.8])


def _rosenbrock_np(xp, x):
    return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _jax_vag(x):
    f, g = jax.value_and_grad(lambda z: _rosenbrock_np(jnp, z))(x)
    return f, g, jnp.sum(x)


def _torch_vag(x):
    x = x.detach().requires_grad_(True)
    f = _rosenbrock_np(torch, x)
    (g,) = torch.autograd.grad(f, x)
    return f.detach(), g, x.detach().sum()


@pytest.mark.parametrize("max_iter", [5, 200])
def test_lbfgs_run_matches_jax(max_iter):
    xj, fj, auxj, kj, cj = jax_lbfgs_run(
        _jax_vag, jnp.asarray(X0), max_iter, ftol=1e-12, has_aux=True)
    xp, fp, auxp, kp, cp = lbfgs_run(
        _torch_vag, torch.as_tensor(X0), max_iter, ftol=1e-12, has_aux=True)
    assert kp == int(kj) and cp == bool(cj)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(float(fp), float(fj), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(float(auxp), float(auxj), rtol=1e-10)


def test_lbfgs_run_without_aux_and_a_failed_line_search():
    xp, fp, k, conv = lbfgs_run(
        lambda x: _torch_vag(x)[:2], torch.as_tensor(X0), 200, ftol=1e-12)
    np.testing.assert_allclose(xp.numpy(), np.ones(4), atol=1e-5)

    def nan_vag(x):                    # every trial is non-finite
        f, g, _ = _torch_vag(x)
        return f * float("nan") if x[0] != X0[0] else f, g
    x1, f1, k1, conv1 = lbfgs_run(nan_vag, torch.as_tensor(X0), 50)
    assert k1 == 1 and conv1
    np.testing.assert_array_equal(x1.numpy(), X0)


@pytest.fixture(scope="module")
def data(gp_sim_data):
    """The R suite's exponential GP data (tests/conftest.py), n = 100, with
    the linear term of its regression test."""
    d = gp_sim_data
    return d["coords"], d["X"], d["eps"] + d["X"] @ d["beta"] + d["xi"]


@pytest.mark.parametrize("approx,with_X", [("none", False), ("none", True),
                                           ("vecchia", False),
                                           ("vecchia", True)])
def test_fit_with_the_device_optimizer_matches_jax(data, approx, with_X):
    coords, X, y = data
    kw = dict(gp_coords=coords, cov_function="exponential",
              gp_approx=approx)
    if approx == "vecchia":
        kw["num_neighbors"] = 10
    params = {"optimizer_cov": "lbfgs", "use_device_optimizer": True}
    Xf = X if with_X else None
    gj = gpb.GPModel(**kw)
    gj.fit(y=y, X=Xf, params=params)
    gp = gpt.GPModel(**kw, device="cpu")
    gp.fit(y=y, X=Xf, params=params)
    assert gp._fit_result.optimizer == "device_lbfgs"
    assert gp.get_num_optim_iter() == gj.get_num_optim_iter()
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-6)
    np.testing.assert_allclose(gp.get_current_neg_log_likelihood(),
                               gj.get_current_neg_log_likelihood(),
                               rtol=1e-10)
    if with_X:
        np.testing.assert_allclose(gp.get_coef(), gj.get_coef(), rtol=1e-6)


def test_device_optimizer_with_a_fixed_range(data):
    coords, _, y = data
    params = {"optimizer_cov": "lbfgs", "use_device_optimizer": True,
              "estimate_cov_par_index": [1, 1, 0],
              "init_cov_pars": [0.2, 0.5, 0.3]}
    gj = gpb.GPModel(gp_coords=coords, cov_function="exponential")
    gj.fit(y=y, params=params)
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     device="cpu")
    gp.fit(y=y, params=params)
    assert gp.get_num_optim_iter() == gj.get_num_optim_iter()
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-6)
    assert gp.get_cov_pars()[2] == pytest.approx(0.3)


class _Engine:
    def __init__(self, n, raw=True):
        self.n = n
        if raw:
            self.nll_profiled_raw = self.wls_coef_raw = None


@pytest.mark.parametrize("n,raw,opt,forced,expect", [
    (19_999, True, "lbfgs", None, False),
    (20_000, True, "lbfgs", None, True),
    (20_000, True, "lbfgs_linesearch_nocedal_wright", None, True),
    (20_000, True, "lbfgs_not_profile_out_nugget", None, False),
    (20_000, False, "lbfgs", None, False),         # Woodbury: no raw closure
    (100, True, "lbfgs", True, True),
    (10 ** 6, True, "lbfgs", False, False),
    (10 ** 6, True, "nelder_mead", None, False)])
def test_default_dispatch(n, raw, opt, forced, expect):
    cfg = port_optimize.OptimConfig(optimizer_cov=opt,
                                    use_device_optimizer=forced)
    est = np.ones(3, dtype=bool)
    assert port_optimize._use_device_lbfgs(_Engine(n, raw), cfg, est,
                                           None) == expect
    assert not port_optimize._use_device_lbfgs(
        _Engine(n, raw), cfg, np.array([False, True, True]), None)


def test_default_dispatch_through_fit(data, monkeypatch):
    """At the threshold the default fit takes the device L-BFGS and gives
    what the JAX package's forced device L-BFGS gives; below it, scipy."""
    coords, _, y = data
    gj = gpb.GPModel(gp_coords=coords, cov_function="exponential")
    gj.fit(y=y, params={"optimizer_cov": "lbfgs",
                        "use_device_optimizer": True})
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     device="cpu")
    gp.fit(y=y)
    assert gp._fit_result.optimizer == "scipy"
    monkeypatch.setattr(port_optimize, "DEVICE_OPTIMIZER_MIN_N", N)
    gp.fit(y=y)
    assert gp._fit_result.optimizer == "device_lbfgs"
    assert gp.get_num_optim_iter() == gj.get_num_optim_iter()
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-6)
    gw = gpt.GPModel(group_data=np.arange(N) % 7, device="cpu")
    gw.fit(y=y)
    assert gw._fit_result.optimizer == "scipy"
