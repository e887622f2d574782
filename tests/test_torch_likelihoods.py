"""The likelihoods of the PyTorch port against the JAX package.

For each of the 16 families of gpboost_tpu/likelihoods/base.py: log_lik,
d1 and d2 on a grid of locations f from -40 to 40 (the tails the mode
finder reaches), with responses and aux parameters from a seed, to rtol
1e-10 (plus 1e-13 absolute for entries that cancel to rounding noise, e.g.
1 - sigmoid(33.5)). Two points are looser, each for a special function of
the reference:

  * bernoulli_probit / binomial_probit at |f| >= 19.5: jax's log_ndtr
    switches to a three-term asymptotic series below -20 (4e-9 absolute
    error there), so d1 is held to rtol 1e-7 and d2 to rtol 1e-4;
  * beta and negative_binomial_1, d2: it goes through trigamma, and
    torch's (polygamma(1, x), the derivative of digamma, on the CPU) is off
    by up to 5e-10 relative against scipy's, so d2 is held to rtol 1e-8;
    and for beta at exactly f = 0 jax's betaln takes
    min/max of its arguments, whose second derivative at the tie a = b is
    0 there, so the port's value is held to a central finite difference.

Also the option parser and every alias, label checks, the Gauss-Hermite
response moments, test_neg_log_likelihood, and the registration of the
families.py names and the tkc suffix (tests/test_torch_families.py holds
those families to the JAX package).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpboost_tpu.likelihoods import base as jbase
from gpboost_tpu_torch.likelihoods import base as tbase

torch.set_num_threads(1)

F_GRID = np.concatenate([np.linspace(-40.0, 40.0, 161),
                         [-25.3, -20.5, -19.5, -8.2, 7.9]])
N = len(F_GRID)
_rng = np.random.RandomState(0)
_COUNTS = _rng.poisson(3, N).astype(float)
_POS = _rng.gamma(2.0, 1.0, N)
_REAL = 3.0 * _rng.randn(N)
_FRAC = _rng.rand(N)
_BINARY = np.tile([0.0, 1.0], N)[:N]
_TWEEDIE = np.where(_rng.rand(N) < 0.3, 0.0, _rng.gamma(2.0, 1.0, N))

# name: (likelihood_additional_param, y, internal aux, an invalid y)
CASES = {
    "bernoulli_probit": (None, _BINARY, None, [0.0, 0.5]),
    "bernoulli_logit": (None, _BINARY, None, [2.0, 1.0]),
    "binomial_logit": (None, _FRAC, None, [1.5]),
    "binomial_probit": (None, _FRAC, None, [-0.1]),
    "poisson": (None, _COUNTS, None, [1.5]),
    "gamma": (None, _POS, [1.7], [0.0]),
    "negative_binomial": (None, _COUNTS, [2.3], [-1.0]),
    "negative_binomial_1": (None, _COUNTS, [0.7], [0.5]),
    "beta": (None, 0.98 * _FRAC + 0.01, [3.1], [1.0]),
    "t": (None, _REAL, [1.3, 4.5], None),
    "t_fix_df": (3.0, _REAL, [1.3], None),
    "lognormal": (None, _POS, [0.6], [-1.0]),
    "tweedie": (None, _TWEEDIE, [1.2, 0.8], [-0.5]),
    "tweedie_fixed_p": (1.3, _TWEEDIE, [1.2], [-0.5]),
    "asymmetric_laplace": (0.3, _REAL, [0.8], None),
    "gaussian_latent": (None, _REAL, [0.9], None),
}


def _pair(name):
    par = CASES[name][0]
    return jbase.get_likelihood(name, par), tbase.get_likelihood(name, par)


def _close(a, b, rtol, atol=1e-13):
    a, b = np.asarray(a), np.asarray(b)
    bad = ~(np.abs(a - b) <= rtol * np.maximum(np.abs(a), np.abs(b)) + atol)
    bad &= ~(a == b)
    assert not bad.any(), (
        f"{int(bad.sum())} entries differ, first at index "
        f"{int(np.flatnonzero(bad)[0])}: {a[bad][:3]} vs {b[bad][:3]}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_log_lik_and_derivatives(name):
    _, y, aux, _ = CASES[name]
    lj, lt = _pair(name)
    f = F_GRID.copy()
    if name == "beta":
        f = np.clip(f, -30.0, 30.0)        # sigmoid(f) must stay inside (0, 1)
    aj = None if aux is None else jnp.asarray(aux)
    at = None if aux is None else torch.as_tensor(np.asarray(aux, float))
    yt, ft = torch.as_tensor(y), torch.as_tensor(f)
    tail = np.abs(f) >= 19.5 if name.endswith("probit") \
        else np.zeros(len(f), bool)
    for what, rtol_tail in (("log_lik", 1e-10), ("d1", 1e-7), ("d2", 1e-4)):
        vj = np.asarray(jax.jit(getattr(lj, what))(
            jnp.asarray(y), jnp.asarray(f), aj))
        vt = getattr(lt, what)(yt, ft, at).numpy()
        keep = ~tail
        rtol = 1e-10
        if name in ("beta", "negative_binomial_1") and what == "d2":
            keep &= f != 0.0
            rtol = 1e-8
        _close(vj[keep], vt[keep], rtol)
        _close(vj[tail], vt[tail], rtol_tail)
    if name == "beta":
        # jax's d2 is 0 at f = 0 (its betaln's min/max tie); hold the port
        # to a central difference of its own log_lik there
        h = 1e-4
        i = np.flatnonzero(f == 0.0)
        ll = [lt.log_lik(yt[i], ft[i] + s, at).numpy() for s in (-h, 0, h)]
        fd = (ll[0] - 2 * ll[1] + ll[2]) / h ** 2
        np.testing.assert_allclose(lt.d2(yt[i], ft[i], at).numpy(), fd,
                                   rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_response_moments_and_host_helpers(name):
    par, y, aux, bad_y = CASES[name]
    lj, lt = _pair(name)
    mu = np.linspace(-1.5, 1.5, 7)
    var = np.linspace(0.1, 1.2, 7)
    aux_int = np.asarray(aux if aux is not None else [], float)
    mj, vj = jax.jit(lj.response_mean_var)(
        jnp.asarray(mu), jnp.asarray(var), jnp.asarray(aux_int))
    mt, vt = lt.response_mean_var(torch.as_tensor(mu), torch.as_tensor(var),
                                  torch.as_tensor(aux_int))
    _close(np.asarray(mj), mt.numpy(), 1e-10)
    _close(np.asarray(vj), vt.numpy(), 1e-10)
    for attr in ("num_aux", "aux_names", "link", "approx_type",
                 "integer_response"):
        assert getattr(lj, attr) == getattr(lt, attr), attr
    np.testing.assert_array_equal(lj.init_aux(y), lt.init_aux(y))
    assert lj.init_intercept(y, 0.7) == lt.init_intercept(y, 0.7)
    assert lj.cap_constants(y) == lt.cap_constants(y)
    if aux is not None:
        user = lj.aux_from_internal(np.asarray(aux, float))
        np.testing.assert_array_equal(user, lt.aux_from_internal(
            np.asarray(aux, float)))
        np.testing.assert_array_equal(lj.aux_to_internal(user),
                                      lt.aux_to_internal(user))
    if bad_y is not None:
        for lik in (lj, lt):
            with pytest.raises(ValueError):
                lik.check_y(np.asarray(bad_y))


@pytest.mark.parametrize("name", ["t"])
def test_test_neg_log_likelihood(name):
    # the reference's own version runs 60 eager Newton steps (slow under
    # jax) and breaks on Tweedie's 2-D series, so one family with aux
    # parameters stands in
    _, y, aux, _ = CASES[name]
    lj, lt = _pair(name)
    yy, mm, vv = y[:12], np.linspace(-1.0, 1.0, 12), np.full(12, 0.4)
    auxu = None if aux is None else lj.aux_from_internal(
        np.asarray(aux, float))
    np.testing.assert_allclose(
        lt.test_neg_log_likelihood(yy, mm, vv, auxu),
        lj.test_neg_log_likelihood(yy, mm, vv, auxu), rtol=1e-10)


OPTION_NAMES = [
    "bernoulli_probit", "poisson_fisher_laplace", "t_fisher_laplace_combined",
    "t_laplace", "asymmetric_laplace", "asymmetric_laplace_laplace",
    "gamma_var_cor_pred_lr", "t_not_fisher_mode_finding",
    "t_fisher_mode_finding_continue", "asymmetric_laplace_tkc",
    "asymmetric_laplace_kink_clipping", "t_fisher-laplace",
    "bernoulli_logit_var_cor_pred_freq_asym_kink_clipping",
    "t_fisher_laplace_fisher_mode_finding_var_cor_pred_lr",
    "asymmetric_laplace_TKC", "asymmetric_laplace_triangular_kernel_curvature",
]


def test_option_parser_and_aliases():
    for nm in OPTION_NAMES:
        assert tbase._parse_likelihood_options(nm) \
            == jbase._parse_likelihood_options(nm), nm
    assert tbase._ALIASES == jbase._ALIASES
    for alias, target in tbase._ALIASES.items():
        if target == "gaussian":
            continue
        par = 0.4 if target == "asymmetric_laplace" else None
        lt = tbase.get_likelihood(alias, par)
        lj = jbase.get_likelihood(alias, par)
        assert lt.name == lj.name == target


def test_options_set_like_the_reference():
    for nm, par in (("t_fisher_laplace_combined", None),
                    ("t_laplace", None), ("gamma_var_cor_pred_lr", None),
                    ("asymmetric_laplace_var_cor_pred_freq_asym", 0.7),
                    ("t_fix_df_not_fisher_mode_finding", 5.0),
                    ("bernoulli_logit_kink_clipping", None)):
        lj = jbase.get_likelihood(nm, par)
        lt = tbase.get_likelihood(nm, par)
        for attr in ("name", "approx_type", "mode_finding", "var_correction",
                     "kink_clipping"):
            assert getattr(lj, attr) == getattr(lt, attr), (nm, attr)
    for nm in ("poisson_fisher_laplace", "quantile"):
        with pytest.raises(ValueError):
            tbase.get_likelihood(nm)
    for q in (0.0, 1.0, float("nan")):
        with pytest.raises(ValueError):
            tbase.get_likelihood("asymmetric_laplace", q)
    with pytest.raises(ValueError):
        tbase.get_likelihood("no_such_likelihood")


def test_unported_likelihoods_raise():
    """Every family of likelihoods/families.py is registered by its own
    name (tests/test_torch_families.py holds each to the JAX package),
    the tkc suffix takes the triangular-kernel curvature, and the port
    supports the JAX package's likelihoods, no more and no fewer."""
    from gpboost_tpu.likelihoods.families import FAMILY_CLASSES
    assert sorted(c.name for c in FAMILY_CLASSES) \
        == sorted(tbase.FAMILY_NAMES)
    for nm in tbase.FAMILY_NAMES:
        assert tbase.get_likelihood(nm).name == nm
    assert tbase.get_likelihood("asymmetric_laplace_tkc",
                                0.5).approx_type == "tkc"
    with pytest.raises(ValueError, match="triangular_kernel_curvature"):
        tbase.get_likelihood("poisson_tkc")
    assert tbase.SUPPORTED_LIKELIHOODS == jbase.SUPPORTED_LIKELIHOODS


_REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
_PORT_FILES = sorted(
    str(p.relative_to(_REPO))
    for p in (_REPO / "gpboost_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", _PORT_FILES)
def test_port_never_imports_jax(path):
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package: every import statement of the file, at any depth."""
    import ast
    tree = ast.parse((_REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for nm in names:
            top = nm.split(".")[0]
            assert top not in ("jax", "jaxlib", "gpboost_tpu"), \
                f"{path}:{node.lineno} imports {nm}"


def test_import_check_covers_the_slice_modules():
    """The AST check above reaches every module of the port by its glob,
    the Laplace slices' engines, the approximation engines and adapters
    and the combined Vecchia + grouped engine among them."""
    for mod in ("models/laplace", "models/grouped_laplace",
                "models/vecchia_laplace", "models/fitc",
                "models/fitc_laplace", "models/fsa_iterative",
                "models/fsva_iterative", "ops/taper", "ops/neighbor_bags",
                "models/vecchia_grouped", "likelihoods/families",
                "likelihoods/tkc"):
        assert f"gpboost_tpu_torch/{mod}.py" in _PORT_FILES
