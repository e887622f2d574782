"""The 34 likelihood families of likelihoods/families.py and the
triangular-kernel curvature (likelihoods/tkc.py) of the PyTorch port
against the JAX package.

One case per family: responses of the family's support, its internal aux
parameters and the locations f (and, for the two-predictor families, zeta)
on a grid from -40 to 40, made from a seed with numpy. Compared, to rtol
1e-10 (plus 1e-13 absolute for entries that cancel to rounding noise, and
nan == nan, inf == inf): log_lik and its first two derivatives in f (for
two predictors log_lik2 and its first and second derivatives in f and
zeta), fisher_W / fisher_W2 / fisher_W_stacked, cond_mean / cond_var,
response_mean_var(2) / response_mean_var_2re, the aux transforms both ways,
init_aux, init_intercept(2), check_y and the flags. The JAX side runs in
one jit per family. Looser, each for a special function:

  * log_ndtr (quasi_bernoulli_probit, zero_censored_power_transformed_normal,
    zoctn): jax's switches to a three-term asymptotic series below -20 (4e-9
    absolute error there), so where its argument is below -19.5 the first
    derivative is held to rtol 1e-7 and the second to 1e-4;
  * trigamma (the second derivative of gammaln / betaln in f:
    beta_binomial, zero_inflated(_regression)_negative_binomial_1,
    zero_one_censored_transformed_beta): torch's polygamma(1, x) on the CPU
    is off by up to 5e-10 relative against scipy's, so d2 is held to rtol
    1e-8; and where jax's betaln ties its arguments (a = b at f = 0) its
    second derivative is the min/max subgradient, so those points are left
    to the finite-difference check of the port's own log_lik;
  * the GPD / EGPD families' second derivative in f cancels terms of size
    one to zero for large f, so it gets 1e-12 absolute (rounding noise of
    those terms) instead of 1e-13;
  * the EGPD carriers at f >= 36 (z = y exp(-f) below 1e-15): jax's
    log(1 - exp(a)) evaluates its far branch log1p(-exp(a)) = -inf there
    too, and the infinite gradient of the branch that its where leaves out
    makes its derivatives NaN; the port's branches see safe inputs only,
    so where jax's derivative is NaN the port's must be finite and equal a
    central difference of its own lower derivative (5e-6 relative, 1e-7
    absolute);
  * beta_binomial with trials: at |f| near 30 its log_lik is the
    difference of two betaln terms of size ~30 that cancel to ~1e-6, and
    jax's betaln rounds them differently, so 1e-11 absolute.

The tkc curvature is held against gpboost_tpu/likelihoods/tkc.py on an
asymmetric-Laplace log-likelihood, value and gradient in the location.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpboost_tpu.likelihoods import families as jfam
from gpboost_tpu.likelihoods import base as jbase
from gpboost_tpu.likelihoods import tkc as jtkc
from gpboost_tpu_torch.likelihoods import families as tfam
from gpboost_tpu_torch.likelihoods import base as tbase
from gpboost_tpu_torch.likelihoods import tkc as ttkc

torch.set_num_threads(1)

F_GRID = np.concatenate([np.linspace(-40.0, 40.0, 81),
                         [-25.3, -20.5, -19.5, -8.2, -0.3, 0.4, 7.9]])
N = len(F_GRID)
_rng = np.random.RandomState(13)
ZETA = np.clip(_rng.permutation(F_GRID), -30.0, 30.0)
_COUNTS = np.where(_rng.rand(N) < 0.35, 0.0, _rng.poisson(3, N)).astype(float)
_POS0 = np.where(_rng.rand(N) < 0.3, 0.0, _rng.gamma(2.0, 1.0, N))
_POS = _rng.gamma(2.0, 1.0, N) + 0.01
_FRAC = _rng.rand(N)
_FRAC01 = np.where(_rng.rand(N) < 0.2, 0.0,
                   np.where(_rng.rand(N) < 0.2, 1.0, 0.05 + 0.9 * _FRAC))
_REAL = 3.0 * _rng.randn(N)

# internal aux and response kind per family (aux on the internal scale)
CASES = {
    "quasi_bernoulli_logit": ([], _FRAC),
    "quasi_bernoulli_probit": ([], _FRAC),
    "beta_binomial": ([3.5], _FRAC),
    "hurdle_gamma": ([1.7, 0.6], _POS0),
    "hurdle_lognormal": ([0.8, 0.4], _POS0),
    "zero_inflated_poisson": ([0.7], _COUNTS),
    "zero_inflated_negative_binomial": ([2.3, 0.5], _COUNTS),
    "zero_inflated_negative_binomial_1": ([0.7, 0.3], _COUNTS),
    "gpd": ([0.7], _POS),
    "egpd_power": ([0.6, 1.8], _POS),
    "egpd_power_mixture": ([0.55, 1.3, 0.7, 1.5], _POS),
    "egpd_beta": ([0.6, 1.4], _POS),
    "egpd_power_beta": ([0.6, 1.4, 2.2], _POS),
    "hurdle_gpd": ([0.7, 0.8], _POS0),
    "hurdle_egpd_power": ([0.6, 1.8, 0.5], _POS0),
    "hurdle_egpd_power_mixture": ([0.55, 1.3, 0.7, 1.5, 0.6], _POS0),
    "hurdle_egpd_beta": ([0.6, 1.4, 0.7], _POS0),
    "hurdle_egpd_power_beta": ([0.6, 1.4, 2.2, 0.9], _POS0),
    "zero_censored_power_transformed_normal": ([1.3, 0.8], _POS0),
    "zoctn": ([0.8, 1.4, 1.2], _FRAC01),
    "zero_one_censored_transformed_beta": ([3.0, 0.1], _FRAC01),
    "zero_one_censored_shifted_gamma": ([1.6, 0.2], _FRAC01),
    "gaussian_heteroscedastic": ([], _REAL),
    "gaussian_heteroscedastic_fixed_and_random": ([], _REAL),
    "hurdle_regression_gamma": ([1.7], _POS0),
    "hurdle_regression_lognormal": ([0.8], _POS0),
    "hurdle_regression_gpd": ([0.7], _POS0),
    "hurdle_regression_egpd_power": ([0.6, 1.8], _POS0),
    "hurdle_regression_egpd_power_mixture": ([0.55, 1.3, 0.7, 1.5], _POS0),
    "hurdle_regression_egpd_beta": ([0.6, 1.4], _POS0),
    "hurdle_regression_egpd_power_beta": ([0.6, 1.4, 2.2], _POS0),
    "zero_inflated_regression_poisson": ([], _COUNTS),
    "zero_inflated_regression_negative_binomial": ([2.3], _COUNTS),
    "zero_inflated_regression_negative_binomial_1": ([0.7], _COUNTS),
}
NDTR = {"quasi_bernoulli_probit": 1.0,
        "zero_censored_power_transformed_normal": 1.3, "zoctn": 0.8}
TRIGAMMA = ("beta_binomial", "zero_inflated_negative_binomial_1",
            "zero_inflated_regression_negative_binomial_1",
            "zero_one_censored_transformed_beta")
BETALN_TIE = ("beta_binomial", "zero_one_censored_transformed_beta")


def test_every_family_has_a_case():
    assert sorted(CASES) == sorted(c.name for c in jfam.FAMILY_CLASSES) \
        == sorted(c.name for c in tfam.FAMILY_CLASSES) \
        == sorted(tbase.FAMILY_NAMES)


def _close(a, b, rtol, atol=1e-13, what=""):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape, (a.shape, b.shape)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    bad = ~(np.abs(a - b) <= rtol * np.maximum(np.abs(a), np.abs(b)) + atol)
    bad &= ~same
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} entries differ, first at index "
        f"{int(np.flatnonzero(bad)[0])}: {a[bad][:3]} vs {b[bad][:3]}")


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}


def _jax_all(lj, two, y, f, zeta, aux, fmid, mu, var, z7):
    """Every JAX-side value of one family, in one jit: the density and its
    derivatives (value, d/df, d2/df2, d/dzeta, d2/dzeta2), the curvatures
    and the response moments."""
    def fn(y_, f_, z_, a_):
        return lj.log_lik2(y_, f_, z_, a_) if two else lj.log_lik(y_, f_, a_)

    def run(y, f, zeta, aux, fmid, mu, var, z7):
        def s(ff, zz):
            return jnp.sum(fn(y, ff, zz, aux))

        d1f = jax.grad(s, 0)
        derivs = [fn(y, f, zeta, aux), d1f(f, zeta),
                  jax.grad(lambda ff: jnp.sum(d1f(ff, zeta)))(f)]
        if two:
            d1z = jax.grad(s, 1)
            derivs += [d1z(f, zeta),
                       jax.grad(lambda zz: jnp.sum(d1z(f, zz)))(zeta)]
        out = {"derivs": derivs}
        if hasattr(lj, "fisher_W") and not two:
            out["fisher_W"] = lj.fisher_W(y, fmid, aux)
        for meth in ("fisher_W2", "fisher_W_stacked"):
            if hasattr(lj, meth):
                out[meth] = getattr(lj, meth)(y, fmid, zeta, aux)
        if hasattr(lj, "response_mean_var_2re"):
            out["resp"] = lj.response_mean_var_2re(mu, var, z7, var, aux)
        elif two:
            out["resp"] = lj.response_mean_var2(mu, var, z7, aux)
        else:
            out["resp"] = lj.response_mean_var(mu, var, aux)
            out["cond_mean"] = lj.cond_mean(fmid, aux)
            out["cond_var"] = lj.cond_var(fmid, aux)
        return out

    args = tuple(map(jnp.asarray, (y, f, zeta, aux, fmid, mu, var, z7)))
    # the XLA backend's optimisation passes and its fusion emitters take
    # most of the compile time of these small graphs and change no value
    # beyond rounding
    out = jax.jit(run).lower(*args).compile(
        compiler_options=_FAST_COMPILE)(*args)
    return jax.tree_util.tree_map(np.asarray, out)


def _derivs_torch(fn, y, f, zeta, aux):
    y, aux = _t(y), _t(aux)

    def s(ff, zz):
        return torch.sum(fn(y, ff, zz, aux))

    d1f = torch.func.grad(s, 0)
    d1z = torch.func.grad(s, 1)
    f, zeta = _t(f), _t(zeta)
    return [v.detach().numpy() for v in (
        fn(y, f, zeta, aux), d1f(f, zeta),
        torch.func.grad(lambda ff: torch.sum(d1f(ff, zeta)))(f),
        d1z(f, zeta),
        torch.func.grad(lambda zz: torch.sum(d1z(f, zz)))(zeta))]


def _finite_difference(ft, vt, i, y, f, zeta, aux, idx):
    """The port's derivative i (1: d/df, 2: d2/df2) at the entries idx
    against a central difference of its log_lik (of d/df for i = 2)."""
    h = 1e-4
    yy, zz, aa = _t(y[idx]), _t(zeta[idx]), _t(aux)

    def lower(ff):
        if i == 1:
            return ft(yy, ff, zz, aa)
        return torch.func.grad(lambda g: torch.sum(ft(yy, g, zz, aa)))(ff)

    fd = (lower(_t(f[idx] + h)) - lower(_t(f[idx] - h))).numpy() / (2 * h)
    assert np.all(np.isfinite(vt[i][idx]))
    np.testing.assert_allclose(vt[i][idx], fd, rtol=5e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(CASES))
def test_family(name):
    aux, y = CASES[name]
    aux = np.asarray(aux, float)
    lj, lt = jbase.get_likelihood(name), tbase.get_likelihood(name)
    assert type(lt).__name__ == type(lj).__name__
    two = lj.num_sets_fe == 2
    f = F_GRID
    if name in ("beta_binomial", "zero_one_censored_transformed_beta"):
        f = np.clip(f, -30.0, 30.0)      # sigmoid(f) must stay inside (0, 1)
    zeta = ZETA if two else np.zeros(N)

    fmid = np.clip(f, -8.0, 8.0)
    mu = np.linspace(-1.5, 1.5, 7)
    var = np.linspace(0.1, 1.2, 7)
    z7 = np.linspace(-1.0, 0.8, 7)
    J = _jax_all(lj, two, y, f, zeta, aux, fmid, mu, var, z7)

    # ---- the density and its derivatives
    if two:
        ft = lambda y_, f_, z_, a_: lt.log_lik2(y_, f_, z_, a_)  # noqa: E731
    else:
        ft = lambda y_, f_, z_, a_: lt.log_lik(y_, f_, a_)  # noqa: E731
    vj = J["derivs"]
    vt = _derivs_torch(ft, y, f, zeta, aux)
    tail = np.zeros(N, bool)
    if name in NDTR:
        arg = np.minimum(np.minimum(-f, f), -(1.0 - f)) / NDTR[name]
        tail = arg <= -19.5
    tie = np.zeros(N, bool)
    if name in BETALN_TIE:
        tie = f == 0.0
    for i, what in enumerate(("ll", "d1f", "d2f", "d1z", "d2z")):
        if not two and what in ("d1z", "d2z"):
            continue
        rtol = 1e-8 if (what in ("d2f", "d2z") and name in TRIGAMMA) \
            else 1e-10
        keep = ~tail & ~(tie if what == "d2f" else np.zeros(N, bool))
        atol = 1e-12 if (what == "d2f" and "gpd" in name) else 1e-13
        if "egpd" in name and what in ("d1f", "d2f"):
            odd = np.isnan(vj[i]) & keep
            if odd.any():
                assert np.all(f[odd] >= 36.0), (what, f[odd])
                _finite_difference(ft, vt, i, y, f, zeta, aux, odd)
            keep &= ~odd
        _close(vj[i][keep], vt[i][keep], rtol, atol, what=what)
        if tail.any():
            _close(vj[i][tail], vt[i][tail],
                   {"ll": 1e-10, "d1f": 1e-7}.get(what, 1e-4))
    if tie.any():
        # the port's d2 at the betaln tie, against a central difference
        h = 1e-4
        i = np.flatnonzero(tie)
        ll = [ft(_t(y[i]), _t(f[i] + s), _t(zeta[i]), _t(aux)).numpy()
              for s in (-h, 0.0, h)]
        np.testing.assert_allclose(vt[2][i], (ll[0] - 2 * ll[1] + ll[2])
                                   / h ** 2, rtol=1e-5)

    # ---- curvatures
    for meth in ("fisher_W", "fisher_W2", "fisher_W_stacked"):
        assert hasattr(lj, meth) == hasattr(lt, meth), meth
        if not hasattr(lj, meth) or (two and meth == "fisher_W"):
            # a two-predictor count family inherits the one-predictor
            # fisher_W, which no engine calls for it
            continue
        args = (y, fmid, aux) if meth == "fisher_W" else (y, fmid, zeta, aux)
        wt = getattr(lt, meth)(*map(_t, args))
        _close(np.broadcast_to(J[meth], wt.shape), wt.numpy(), 1e-10)

    # ---- flags
    for attr in ("num_aux", "aux_names", "default_aux", "link", "approx_type",
                 "integer_response", "num_sets_fe", "W_may_be_negative",
                 "W_may_be_zero", "uses_weights_as_trials"):
        assert getattr(lj, attr, None) == getattr(lt, attr, None), attr
    assert getattr(lj, "num_sets_re", 1) == getattr(lt, "num_sets_re", 1)

    # ---- response moments
    if hasattr(lj, "response_mean_var_2re"):
        mt = lt.response_mean_var_2re(*map(_t, (mu, var, z7, var, aux)))
    elif two:
        mt = lt.response_mean_var2(*map(_t, (mu, var, z7, aux)))
    else:
        mt = lt.response_mean_var(*map(_t, (mu, var, aux)))
    for a_, b_ in zip(J["resp"], mt):
        _close(a_, b_.numpy(), 1e-10)
    if not two:
        for meth in ("cond_mean", "cond_var"):
            ct = getattr(lt, meth)(_t(fmid), _t(aux))
            _close(J[meth], ct.numpy(), 1e-10)

    # ---- host helpers
    np.testing.assert_array_equal(lj.init_aux(y), lt.init_aux(y))
    assert lj.init_intercept(y, 0.7) == lt.init_intercept(y, 0.7)
    if two:
        assert lj.init_intercept2(y, 0.7) == lt.init_intercept2(y, 0.7)
    if len(aux):
        user = lj.aux_from_internal(aux)
        np.testing.assert_array_equal(user, lt.aux_from_internal(aux))
        np.testing.assert_array_equal(lj.aux_to_internal(user),
                                      lt.aux_to_internal(user))
    np.testing.assert_array_equal(lj.check_y(y), lt.check_y(y))
    for bad in ([-1.0, 0.0, 2.0], [0.5, 1.5, 3.0], [2.5, 3.5, 4.5]):
        outs = []
        for lik in (lj, lt):
            try:
                lik.check_y(np.asarray(bad))
                outs.append("ok")
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1], (bad, outs)


def test_beta_binomial_trials():
    trials = np.where(np.arange(N) % 3 == 0, 1.0, 1.0 + np.arange(N) % 7)
    y = np.round(_FRAC * trials) / trials
    aux = np.asarray([2.5])
    lj, lt = (jbase.get_likelihood("beta_binomial"),
              tbase.get_likelihood("beta_binomial"))
    lj.set_trials(trials)
    lt.set_trials(trials)
    f = np.clip(F_GRID, -30.0, 30.0)
    vj = jax.jit(lj.log_lik)(jnp.asarray(y), jnp.asarray(f), jnp.asarray(aux))
    vt = lt.log_lik(_t(y), _t(f), _t(aux))
    _close(np.asarray(vj), vt.numpy(), 1e-10, 1e-11)
    np.testing.assert_array_equal(lj.init_aux(y), lt.init_aux(y))
    cj = jax.jit(lj.cond_var)(jnp.asarray(f), jnp.asarray(aux))
    _close(np.asarray(cj), lt.cond_var(_t(f), _t(aux)).numpy(), 1e-10)


@pytest.mark.parametrize("q", [0.3, 0.8])
def test_tkc_curvature(q):
    """Value and location gradient of the TKC curvature of an
    asymmetric-Laplace log-likelihood, port against JAX."""
    rng = np.random.RandomState(int(q * 10))
    n = 150
    y = rng.standard_t(3, n) + 0.5
    loc = 0.3 * rng.randn(n)
    w = rng.uniform(0.5, 1.5, n)
    aux = np.asarray([0.9])
    lj = jbase.get_likelihood("asymmetric_laplace", q)
    lt = tbase.get_likelihood("asymmetric_laplace", q)

    def cj(l_):
        return jtkc.tkc_neg_curvature(
            lambda s: jnp.sum(w * lj.log_lik(jnp.asarray(y), l_ + s,
                                             jnp.asarray(aux))), n)

    vj, gj = jax.jit(jax.value_and_grad(cj))(jnp.asarray(loc))
    lt_ = _t(loc).requires_grad_(True)
    yt, wt, at = _t(y), _t(w), _t(aux)
    reads = ttkc.host_reads
    ct = ttkc.tkc_neg_curvature(
        lambda s: torch.sum(wt * lt.log_lik(yt, lt_ + s, at), -1), n, lt_)
    assert ttkc.host_reads - reads <= 100 // ttkc.TERNARY_CHECK
    (gt,) = torch.autograd.grad(ct, lt_)
    _close(float(vj), float(ct.detach()), 1e-10)
    _close(np.asarray(gj), gt.numpy(), 1e-9)
