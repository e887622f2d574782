"""The further likelihood families of the PyTorch port: zero-inflated and
hurdle counts and amounts, GPD / EGPD (extended generalized Pareto),
censored responses, beta-binomial, quasi-Bernoulli and the two-predictor
families (counterpart of gpboost_tpu/likelihoods/families.py; reference
include/GPBoost/likelihoods.h, parameterizations at :15-146, and
include/GPBoost/egpd_utils.h).

As in likelihoods/base.py, each family defines only its per-sample log
density as a torch function that broadcasts y against f; the derivatives in
the location come from autodiff. Where the reference tells the observed
Hessian ("laplace"), the expected information ("fisher_laplace") and the
"combined" approximation apart (likelihoods.h:327-369), the family sets
`approx_type` and gives the closed-form expected information `fisher_W`
(`fisher_W2` for two predictors), and the engines pick the curvature.

The auxiliary parameters follow TransformAuxPars / BackTransformAuxPars
(likelihoods.h:780-905): the structural-zero probability p0 and the EGPD
mixture weight are kept as odds, the GPD tail shape xi > -0.5 as
shape_shift = xi + 0.5, and zoctn's real shift a as exp(a).

Two-predictor families (num_sets_fe = 2) define `log_lik2(y, f, zeta, aux)`:
the first block f carries the random effects, the second (zeta) only fixed
effects; gaussian_heteroscedastic_fixed_and_random gives random effects to
both (num_sets_re = 2).

The quadrature nodes (Gauss-Hermite, -Legendre and -Laguerre) are numpy
arrays built once at import and copied to a tensor's device once per
device and dtype.
"""

import math

import numpy as np
import torch
from torch.special import gammaln, log_ndtr, ndtr

from .base import Likelihood, betaln

_CONSTS = {}


def _const(arr, like):
    """A numpy constant as a tensor on like's device and dtype, cached."""
    key = (id(arr), like.device, like.dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(arr, dtype=like.dtype,
                                           device=like.device)
    return t


def _hermegauss_normalised(n=100):
    nodes, weights = np.polynomial.hermite_e.hermegauss(n)
    return nodes, weights / np.sum(weights)


_HE_X, _HE_W = _hermegauss_normalised(100)


# ----------------------------------------------------------------------
# numerics helpers
def _log1mexp(a):
    """log(1 - exp(a)) for a <= 0, stable near both ends. Each branch
    sees only the inputs where it is taken: log1p(-exp(a)) at a ~ -1e-17
    is -inf (exp(a) rounds to 1), and its infinite gradient would turn
    the zero cotangent of the branch left out into NaN."""
    a = torch.clamp(a, max=-1e-300)
    near = a > -math.log(2.0)
    a_near = torch.where(near, a, -torch.ones_like(a))
    a_far = torch.where(near, -torch.ones_like(a), a)
    return torch.where(near, torch.log(-torch.expm1(a_near)),
                       torch.log1p(-torch.exp(a_far)))


def _logaddexp(a, b):
    """log(exp(a) + exp(b)), smooth to the second derivative: each branch
    sees only the inputs where it is taken, so no inf / inf reaches the
    double backward (torch.logaddexp's gives NaN once exp(b - a)
    overflows, also through the branch that torch.where leaves out)."""
    d = b - a
    pos = d > 0.0
    d_pos = torch.where(pos, d, torch.zeros_like(d))
    d_neg = torch.where(pos, torch.zeros_like(d), d)
    return a + torch.where(pos, d_pos + torch.log1p(torch.exp(-d_pos)),
                           torch.log1p(torch.exp(d_neg)))


def _log_sigmoid(x):
    return -_logaddexp(torch.zeros_like(x), -x)


def _logaddexp0(f):
    return _logaddexp(torch.zeros_like(f), f)


def _logphi(z):
    return -0.5 * (z * z) - 0.5 * math.log(2.0 * math.pi)


def _where_pos(y):
    """A y > 0-safe stand-in value for masked branches (keeps the gradient
    of the branch that is not taken finite)."""
    return torch.where(y > 0.0, y, torch.ones_like(y))


def _gh_expect(mu_lat, var_lat, fn):
    """(E[m1], E[m2]) of fn(f) = (m1, m2) under f ~ N(mu_lat, var_lat),
    100-point Gauss-Hermite (likelihoods.h:10083)."""
    nodes, weights = _const(_HE_X, mu_lat), _const(_HE_W, mu_lat)
    f = mu_lat[:, None] + torch.sqrt(var_lat)[:, None] * nodes[None, :]
    m1, m2 = fn(f)
    return (torch.sum(weights[None, :] * m1, 1),
            torch.sum(weights[None, :] * m2, 1))


def _odds_to_internal(a, i, what):
    p = a[i]
    if not (0.0 < p < 1.0):
        raise ValueError(f"{what} must be in (0, 1)")
    a[i] = p / (1.0 - p)
    return a


# ----------------------------------------------------------------------
class QuasiBernoulliLogit(Likelihood):
    """quasi_bernoulli_logit: continuous y in [0, 1], Bernoulli
    quasi-likelihood."""

    name = "quasi_bernoulli_logit"
    link = "logit"

    def log_lik(self, y, f, aux):
        return y * f - _logaddexp0(f)

    def check_y(self, y):
        y = np.asarray(y, dtype=np.float64)
        if np.any(y < 0.0) or np.any(y > 1.0):
            raise ValueError("quasi_bernoulli requires responses in [0, 1]")
        return y

    def cond_mean(self, f, aux):
        return torch.sigmoid(f)

    def cond_var(self, f, aux):
        p = torch.sigmoid(f)
        return p * (1.0 - p)


class QuasiBernoulliProbit(QuasiBernoulliLogit):
    name = "quasi_bernoulli_probit"
    link = "probit"

    def log_lik(self, y, f, aux):
        return y * log_ndtr(f) + (1.0 - y) * log_ndtr(-f)

    def cond_mean(self, f, aux):
        return ndtr(f)

    def cond_var(self, f, aux):
        p = ndtr(f)
        return p * (1.0 - p)


class BetaBinomial(Likelihood):
    """beta_binomial (likelihoods.h:70-74): y = successes / trials, the
    trials given as `weights`; mu = sigmoid(f), phi = precision (aux).

    f(y) = C(n, yn) Beta(yn + mu phi, n - yn + (1 - mu) phi)
           / Beta(mu phi, (1 - mu) phi)
    """

    name = "beta_binomial"
    link = "logit"
    num_aux = 1
    aux_names = ("precision",)
    default_aux = (1.0,)
    uses_weights_as_trials = True

    def __init__(self):
        self.trials = None     # set by the model from `weights`

    def set_trials(self, trials):
        self.trials = None if trials is None \
            else np.asarray(trials, dtype=np.float64)
        self._trials_t = {}

    def _n(self, like):
        if self.trials is None:
            return torch.ones_like(like)
        key = (like.device, like.dtype)
        t = self._trials_t.get(key)
        if t is None:
            t = self._trials_t[key] = torch.as_tensor(
                self.trials, dtype=like.dtype, device=like.device)
        return t

    def log_lik(self, y, f, aux):
        phi = aux[0]
        n = self._n(y)
        k = y * n
        mu = torch.sigmoid(f)
        a = mu * phi
        b = (1.0 - mu) * phi
        return (gammaln(n + 1.0) - gammaln(k + 1.0) - gammaln(n - k + 1.0)
                + betaln(k + a, n - k + b) - betaln(a, b))

    def check_y(self, y):
        y = np.asarray(y, dtype=np.float64)
        if np.any(y < 0.0) or np.any(y > 1.0):
            raise ValueError("beta_binomial requires fractions in [0, 1]")
        return y

    def init_aux(self, y):
        # moment-based ICC start (likelihoods.h:2006-2074), pooled mu
        y = np.asarray(y, dtype=np.float64)
        n = np.ones_like(y) if self.trials is None \
            else np.maximum(np.asarray(self.trials, dtype=np.float64), 1.0)
        mu = min(max(float(np.sum(n * y) / np.sum(n)), 1e-12), 1 - 1e-12)
        s = mu * (1.0 - mu)
        V_obs = float(np.mean((y - mu) ** 2))
        A = float(np.mean(s / n))
        B = float(np.mean(s * (1.0 - 1.0 / n)))
        rho = (V_obs - A) / B if (B > 1e-12 and V_obs > A) else 0.0
        rho = min(max(rho, 0.0), 1 - 1e-8)
        phi = 1e6 if rho <= 0.0 else min(max(1.0 / rho - 1.0, 1e-6), 1e12)
        return np.asarray([phi])

    def cond_mean(self, f, aux):
        return torch.sigmoid(f)

    def cond_var(self, f, aux):
        # Var(Y/n | f), Y ~ BetaBin(n, mu, phi): s/n (1 + (n-1)/(phi+1))
        phi = aux[0]
        n = self._n(f)
        mu = torch.sigmoid(f)
        s = mu * (1.0 - mu)
        return s / n * (1.0 + (n - 1.0) / (phi + 1.0))


# ----------------------------------------------------------------------
# hurdle positive-continuous families: a point mass p0 at 0 and a base
# density on y > 0 with mean / scale exp(f); aux = base aux + (p0 as odds)
class _HurdleBase(Likelihood):
    """What the hurdle families share (likelihoods.h:76-81)."""

    link = "log"
    W_may_be_zero = True   # W = 0 exactly at y = 0 (likelihoods.h:524)

    def _split_aux(self, aux):
        odds = aux[-1]
        return aux[:-1], odds / (1.0 + odds)

    def base_log_density(self, y, f, base_aux):
        raise NotImplementedError

    def base_mean_m2(self, f, base_aux):
        """(E[Y_base | f], E[Y_base^2 | f]) of the positive part."""
        raise NotImplementedError

    def log_lik(self, y, f, aux):
        base_aux, p0 = self._split_aux(aux)
        ll_pos = torch.log1p(-p0) \
            + self.base_log_density(_where_pos(y), f, base_aux)
        return torch.where(y > 0.0, ll_pos, torch.log(p0))

    def check_y(self, y):
        y = np.asarray(y, dtype=np.float64)
        if np.any(y < 0.0):
            raise ValueError(f"{self.name} requires nonnegative responses")
        if not np.any(y <= 0.0):
            raise ValueError(f"{self.name} requires some zero responses")
        return y

    # p0 kept as odds (TransformAuxPars, likelihoods.h:812-819)
    def aux_to_internal(self, aux_orig):
        a = np.asarray(aux_orig, dtype=np.float64).copy()
        return _odds_to_internal(a, -1, "p0")

    def aux_from_internal(self, aux_internal):
        a = np.asarray(aux_internal, dtype=np.float64).copy()
        a[-1] = a[-1] / (1.0 + a[-1])
        return a

    def _init_p0(self, y):
        z = float(np.mean(np.asarray(y) <= 0.0))
        z = min(max(z, 1e-3), 1.0 - 1e-3)
        return z / (1.0 - z)

    def cond_mean(self, f, aux):
        base_aux, p0 = self._split_aux(aux)
        m, _ = self.base_mean_m2(f, base_aux)
        return (1.0 - p0) * m

    def cond_var(self, f, aux):
        base_aux, p0 = self._split_aux(aux)
        m, m2 = self.base_mean_m2(f, base_aux)
        e = (1.0 - p0) * m
        return (1.0 - p0) * m2 - e * e


class HurdleGamma(_HurdleBase):
    """hurdle_gamma (likelihoods.h:76-79): gamma base with mean exp(f) and
    shape gamma (aux[0]); aux = (shape, p0)."""

    name = "hurdle_gamma"
    num_aux = 2
    aux_names = ("shape", "p0")
    default_aux = (1.0, 0.5)

    def base_log_density(self, y, f, base_aux):
        g = base_aux[0]
        return (g * (torch.log(g) - f) - gammaln(g)
                + (g - 1.0) * torch.log(y) - g * y * torch.exp(-f))

    def base_mean_m2(self, f, base_aux):
        g = base_aux[0]
        mu = torch.exp(f)
        return mu, mu * mu * (1.0 + 1.0 / g)

    def init_aux(self, y):
        y = np.asarray(y, dtype=np.float64)
        pos = y[y > 0.0]
        s = max(math.log(float(np.mean(pos))) - float(np.mean(np.log(pos))),
                1e-8)
        shape = (3.0 - s + math.sqrt((s - 3.0) ** 2 + 24.0 * s)) / (12.0 * s)
        return np.asarray([shape, self._init_p0(y)])


class HurdleLognormal(_HurdleBase):
    """hurdle_lognormal: lognormal base with mean exp(f) (the plain
    lognormal's parameterization, likelihoods.h:29-33);
    aux = (log_variance, p0)."""

    name = "hurdle_lognormal"
    num_aux = 2
    aux_names = ("log_variance", "p0")
    default_aux = (1.0, 0.5)

    def base_log_density(self, y, f, base_aux):
        s2 = base_aux[0]
        z = torch.log(y) - (f - 0.5 * s2)
        return (-torch.log(y) - 0.5 * torch.log(2.0 * math.pi * s2)
                - z * z / (2.0 * s2))

    def base_mean_m2(self, f, base_aux):
        s2 = base_aux[0]
        mu = torch.exp(f)
        return mu, mu * mu * torch.exp(s2)

    def init_aux(self, y):
        y = np.asarray(y, dtype=np.float64)
        s2 = max(float(np.var(np.log(y[y > 0.0]))), 1e-6)
        return np.asarray([s2, self._init_p0(y)])


# ----------------------------------------------------------------------
# zero-inflated counts (likelihoods.h:82-88): the base can produce zeros
# too, f(0) = p0 + (1 - p0) f_base(0). The default approximation is
# "combined": (quasi-)Fisher curvature for the mode, the observed Hessian
# for the determinant (SetCountApproximationTypeFlags, likelihoods.h:11557)
class _ZICountBase(Likelihood):
    link = "log"
    integer_response = True
    approx_type = "combined"
    kind = 0               # 0 = Poisson, 1 = NB1, 2 = NB2

    @property
    def W_may_be_negative(self):
        # the observed Hessian at zero counts can be negative
        return self.approx_type in ("laplace", "combined")

    def _p0(self, aux):
        odds = aux[-1]
        return odds / (1.0 + odds)

    def _base_aux(self, aux):
        return aux[0] if self.num_aux > 1 else None

    def _b0(self, mu, base_aux):
        """log f_base(0) (FillZeroMassZICountKind, likelihoods.h:11518)."""
        if self.kind == 2:
            return -base_aux * torch.log1p(mu / base_aux)
        if self.kind == 1:
            return -mu * torch.log1p(base_aux) / base_aux
        return -mu

    def _s0(self, mu, base_aux):
        if self.kind == 2:
            return -base_aux * mu / (base_aux + mu)
        if self.kind == 1:
            return -mu * torch.log1p(base_aux) / base_aux
        return -mu

    def _base_ll_pos(self, y, f, base_aux):
        raise NotImplementedError

    def _base_fisher(self, mu, base_aux):
        """Base-count Fisher information in eta (ZICountBaseFisherInfoEta,
        likelihoods.h:11529-11533); quasi-Fisher for NB1."""
        if self.kind == 2:
            return mu * base_aux / (base_aux + mu)
        if self.kind == 1:
            return mu / (1.0 + base_aux)
        return mu

    def _zi_fisher(self, p0, loc, ba):
        mu = torch.exp(loc)
        s0 = self._s0(mu, ba)
        q = 1.0 - p0
        f0 = torch.exp(self._b0(mu, ba))
        D = p0 + q * f0
        v = q * f0 / D
        fisher = D * v * v * s0 * s0 \
            + q * (self._base_fisher(mu, ba) - f0 * s0 * s0)
        return torch.clamp(fisher, min=0.0)

    def log_lik(self, y, f, aux):
        p0 = self._p0(aux)
        ba = self._base_aux(aux)
        b0 = self._b0(torch.exp(f), ba)
        ll0 = _logaddexp(torch.log(p0), torch.log1p(-p0) + b0)
        ll_pos = torch.log1p(-p0) + self._base_ll_pos(_where_pos(y), f, ba)
        return torch.where(y > 0.0, ll_pos, ll0)

    def fisher_W(self, y, loc, aux):
        """Expected information in eta (ZICountFisherInfoEta,
        likelihoods.h:11536-11543); independent of y, >= 0."""
        return self._zi_fisher(self._p0(aux), loc, self._base_aux(aux))

    def check_y(self, y):
        y = np.asarray(y, dtype=np.float64)
        if np.any(y < 0.0) or np.any(y != np.floor(y)):
            raise ValueError(f"{self.name} requires nonnegative integers")
        return y

    def aux_to_internal(self, aux_orig):
        a = np.asarray(aux_orig, dtype=np.float64).copy()
        return _odds_to_internal(a, -1, "p0")

    def aux_from_internal(self, aux_internal):
        a = np.asarray(aux_internal, dtype=np.float64).copy()
        a[-1] = a[-1] / (1.0 + a[-1])
        return a

    def _init_p0_excess(self, y, mean_y):
        zfrac = float(np.mean(np.asarray(y) <= 0.0))
        f0 = math.exp(-mean_y)
        p0 = (zfrac - f0) / max(1.0 - f0, 1e-6)
        p0 = min(max(p0, 1e-3), 1.0 - 1e-3)
        return p0 / (1.0 - p0)

    def _base_m_m2(self, f, base_aux):
        mu = torch.exp(f)
        if self.kind == 2:
            var = mu * (mu + base_aux) / base_aux
        elif self.kind == 1:
            var = mu * (1.0 + base_aux)
        else:
            var = mu
        return mu, var + mu * mu

    def cond_mean(self, f, aux):
        p0 = self._p0(aux)
        m, _ = self._base_m_m2(f, self._base_aux(aux))
        return (1.0 - p0) * m

    def cond_var(self, f, aux):
        p0 = self._p0(aux)
        m, m2 = self._base_m_m2(f, self._base_aux(aux))
        e = (1.0 - p0) * m
        return (1.0 - p0) * m2 - e * e


class ZeroInflatedPoisson(_ZICountBase):
    name = "zero_inflated_poisson"
    num_aux = 1
    aux_names = ("p0",)
    default_aux = (0.5,)
    kind = 0

    def _base_ll_pos(self, y, f, base_aux):
        return y * f - torch.exp(f) - gammaln(y + 1.0)

    def init_aux(self, y):
        mean_y = max(float(np.mean(y)), 1e-8)
        return np.asarray([self._init_p0_excess(y, mean_y)])


def _count_mean_var(y):
    """(mean, variance) of counts, floored as the moment starts need."""
    y = np.asarray(y, dtype=np.float64)
    mean_y = max(float(np.mean(y)), 1e-8)
    var_y = max(float(np.var(y)), mean_y * 1.0001)
    return mean_y, var_y


class ZeroInflatedNegativeBinomial(_ZICountBase):
    """NB2 base: p = r / (mu + r), r = shape (likelihoods.h:40-43)."""

    name = "zero_inflated_negative_binomial"
    num_aux = 2
    aux_names = ("shape", "p0")
    default_aux = (1.0, 0.5)
    kind = 2

    def _base_ll_pos(self, y, f, base_aux):
        r = base_aux
        mu = torch.exp(f)
        return (gammaln(y + r) - gammaln(y + 1.0) - gammaln(r)
                + y * (f - torch.log(mu + r))
                + r * (torch.log(r) - torch.log(mu + r)))

    def init_aux(self, y):
        mean_y, var_y = _count_mean_var(y)
        kappa = min(max(mean_y * mean_y / max(var_y - mean_y, 1e-6), 1e-2),
                    1e6)
        return np.asarray([kappa, self._init_p0_excess(y, mean_y)])


class ZeroInflatedNegativeBinomial1(_ZICountBase):
    """NB1 base: r = mu / phi, p = 1 / (1 + phi) (likelihoods.h:45-48)."""

    name = "zero_inflated_negative_binomial_1"
    num_aux = 2
    aux_names = ("dispersion", "p0")
    default_aux = (1.0, 0.5)
    kind = 1

    def _base_ll_pos(self, y, f, base_aux):
        phi = base_aux
        r = torch.exp(f) / phi
        lp = -torch.log1p(phi)                       # log p
        l1mp = torch.log(phi) - torch.log1p(phi)     # log(1 - p)
        return (gammaln(y + r) - gammaln(y + 1.0) - gammaln(r)
                + y * l1mp + r * lp)

    def init_aux(self, y):
        mean_y, var_y = _count_mean_var(y)
        phi = min(max(var_y / mean_y - 1.0, 1e-3), 1e6)
        return np.asarray([phi, self._init_p0_excess(y, mean_y)])


# ----------------------------------------------------------------------
# GPD / EGPD (likelihoods.h:96-105, egpd_utils.h): GPD base with scale
# sigma = exp(f) and tail shape xi (kept as shape_shift = xi + 0.5 > 0);
# the extended families compose a carrier G on [0, 1] with the GPD CDF H:
# f(y) = G'(H(y)) h(y)
def _gpd_core(y, f, xi):
    """(a, log_u): a = log(1 - H(z)) = -(1/xi) log(1 + xi z), z = y
    exp(-f), u = H(z) = 1 - exp(a) (CalcEGPDLogLikAndDerivatives,
    egpd_utils.h:207-246)."""
    z = y * torch.exp(-f)
    x = xi * z
    small = torch.abs(x) < 1e-8
    x_safe = torch.where(small, torch.ones_like(x), x)
    ratio = torch.where(
        small, 1.0 - 0.5 * x + x * x / 3.0,
        torch.log1p(torch.clamp(x_safe, min=-1.0 + 1e-15)) / x_safe)
    a = -z * ratio
    return a, _log1mexp(a)


def _log_exprel(t):
    """log((exp(t) - 1) / t) for t <= 0 (egpd_utils.h EGPDExprel)."""
    small = torch.abs(t) < 1e-8
    t_safe = torch.where(small, -torch.ones_like(t), t)
    return torch.where(small, 0.5 * t,
                       _log1mexp(t_safe) - torch.log(-t_safe))


_QUAD_N = 2000
_UNIT_V = (np.arange(_QUAD_N) + 0.5) / _QUAD_N


class _EGPDBase(Likelihood):
    """What the GPD / EGPD families share. aux (internal scale):
    [shape_shift, <carrier parameters...>]; a variant adds its carrier log
    density log G'(u) to the GPD log density."""

    link = "log"
    variant = "gpd"
    num_carrier = 0

    def carrier_logdens(self, a, log_u, carrier_aux):
        """log G'(u), u = 1 - exp(a) (EGPDCarrierDensity,
        egpd_utils.h:306)."""
        return torch.zeros_like(log_u)

    def log_lik(self, y, f, aux):
        xi = aux[0] - 0.5
        a, log_u = _gpd_core(_where_pos(y), f, xi)
        ll = -f + (1.0 + xi) * a + self.carrier_logdens(a, log_u, aux[1:])
        # outside a finite endpoint (xi < 0, 1 + xi z <= 0) the density is
        # 0; _gpd_core's clamped log1p already gives -inf-like values
        return torch.where(y > 0.0, ll, torch.full_like(ll, -math.inf))

    def check_y(self, y):
        y = np.asarray(y, dtype=np.float64)
        if np.any(y <= 0.0):
            raise ValueError(
                f"{self.name} requires strictly positive responses")
        return y

    # shape: internal = xi + 0.5 (TransformAuxPars, likelihoods.h:783-795)
    def aux_to_internal(self, aux_orig):
        a = np.asarray(aux_orig, dtype=np.float64).copy()
        if not (a[0] > -0.5):
            raise ValueError("GPD/EGPD shape must be > -0.5")
        a[0] = a[0] + 0.5
        return a

    def aux_from_internal(self, aux_internal):
        a = np.asarray(aux_internal, dtype=np.float64).copy()
        a[0] = a[0] - 0.5
        return a

    def init_aux(self, y):
        # shape 0 (exponential base, likelihoods.h:1909) + carrier defaults
        return np.asarray([0.5] + [1.0] * self.num_carrier)

    # response moments by unit-scale quadrature (CalcEGPDUnitScaleMoments,
    # egpd_utils.h:322: u = sin(pi v / 2)^2, midpoint rule)
    def _carrier_density_u(self, u, carrier_aux):
        return torch.exp(self.carrier_logdens(torch.log1p(-u), torch.log(u),
                                              carrier_aux))

    def _unit_moments(self, aux):
        xi = aux[0] - 0.5
        v = _const(_UNIT_V, aux)
        s = torch.sin(0.5 * math.pi * v)
        u = s * s
        du = math.pi * s * torch.cos(0.5 * math.pi * v) / _QUAD_N
        # quantile Q(u) = ((1 - u)^-xi - 1) / xi
        t = -xi * torch.log1p(-u)
        small = torch.abs(xi) < 1e-8
        xi_safe = torch.where(small, torch.ones_like(xi), xi)
        Q = torch.where(small, -torch.log1p(-u) * (1.0 + 0.5 * t),
                        torch.expm1(t) / xi_safe)
        g = self._carrier_density_u(u, aux[1:])
        m1 = torch.sum(Q * g * du)
        m2 = torch.sum(Q * Q * g * du)
        m1 = torch.where(xi < 1.0, m1, torch.full_like(m1, math.nan))
        m2 = torch.where(xi < 0.5, m2, torch.full_like(m2, math.nan))
        return m1, m2

    def cond_mean(self, f, aux):
        m1, _ = self._unit_moments(aux)
        return torch.exp(f) * m1

    def cond_var(self, f, aux):
        m1, m2 = self._unit_moments(aux)
        return torch.exp(2.0 * f) * (m2 - m1 * m1)


class GPD(_EGPDBase):
    name = "gpd"
    num_aux = 1
    aux_names = ("shape",)
    default_aux = (0.0,)


class EGPDPower(_EGPDBase):
    """G(u) = u^kappa (egpd_utils.h:244-247)."""

    name = "egpd_power"
    variant = "power"
    num_aux = 2
    num_carrier = 1
    aux_names = ("shape", "kappa")
    default_aux = (0.0, 1.0)
    W_may_be_negative = True    # likelihoods.h:277

    def carrier_logdens(self, a, log_u, carrier_aux):
        kappa = carrier_aux[0]
        return torch.log(kappa) + (kappa - 1.0) * log_u


class EGPDPowerMixture(_EGPDBase):
    """G(u) = p u^k1 + (1 - p) u^(k1 + dk), p kept as odds
    (egpd_utils.h:249-258)."""

    name = "egpd_power_mixture"
    variant = "power_mixture"
    num_aux = 4
    num_carrier = 3
    aux_names = ("shape", "kappa1", "delta_kappa", "p")
    default_aux = (0.0, 1.0, 1.0, 0.5)
    W_may_be_negative = True    # likelihoods.h:283

    def carrier_logdens(self, a, log_u, carrier_aux):
        k1, dk, odds = carrier_aux[0], carrier_aux[1], carrier_aux[2]
        k2 = k1 + dk
        log_p = torch.log(odds) - torch.log1p(odds)
        log_q = -torch.log1p(odds)
        A = log_p + torch.log(k1) + (k1 - 1.0) * log_u
        B = log_q + torch.log(k2) + (k2 - 1.0) * log_u
        return _logaddexp(A, B)

    def aux_to_internal(self, aux_orig):
        return _odds_to_internal(super().aux_to_internal(aux_orig), 3,
                                 "EGPD mixture weight p")

    def aux_from_internal(self, aux_internal):
        a = super().aux_from_internal(aux_internal)
        a[3] = a[3] / (1.0 + a[3])
        return a

    def init_aux(self, y):
        return np.asarray([0.5, 1.0, 1.0, 1.0])   # p = 0.5: odds 1


def _beta_carrier_logB_logBp(a, log_u, delta):
    """log B(u) and log B'(u) of the incomplete-Beta-type carrier
    (egpd_utils.h:259-289): B = u + r a exprel(delta a), r = exp(a),
    B' = (1 + delta)(-a) exprel(delta a)."""
    log_Bp = torch.log1p(delta) + torch.log(-torch.clamp(a, max=-1e-300)) \
        + _log_exprel(delta * a)
    u = torch.exp(log_u)
    B_direct = u + torch.exp(a) * a * torch.exp(_log_exprel(delta * a))
    # small-u series: B = (1 + delta) u^2/2 - (1 + delta)(delta - 1) u^3/6
    logB_series = torch.log1p(delta) + 2.0 * log_u - math.log(2.0) \
        + torch.log1p(-(delta - 1.0) * u / 3.0)
    log_B = torch.where(u < 1e-4, logB_series,
                        torch.log(torch.clamp(B_direct, min=1e-300)))
    return log_B, log_Bp


class EGPDBeta(_EGPDBase):
    name = "egpd_beta"
    variant = "beta"
    num_aux = 2
    num_carrier = 1
    aux_names = ("shape", "delta")
    default_aux = (0.0, 1.0)

    def carrier_logdens(self, a, log_u, carrier_aux):
        return _beta_carrier_logB_logBp(a, log_u, carrier_aux[0])[1]


class EGPDPowerBeta(_EGPDBase):
    name = "egpd_power_beta"
    variant = "power_beta"
    num_aux = 3
    num_carrier = 2
    aux_names = ("shape", "delta", "kappa")
    default_aux = (0.0, 1.0, 1.0)
    W_may_be_negative = True    # likelihoods.h:294

    def carrier_logdens(self, a, log_u, carrier_aux):
        delta, kappa = carrier_aux[0], carrier_aux[1]
        log_B, log_Bp = _beta_carrier_logB_logBp(a, log_u, delta)
        return torch.log(0.5 * kappa) + (0.5 * kappa - 1.0) * log_B + log_Bp


def _make_hurdle_egpd(base_cls, hname):
    """A hurdle variant of a GPD / EGPD family: the base's aux and a
    trailing p0 (odds)."""
    class HurdleEGPD(_HurdleBase):
        name = hname
        num_aux = base_cls.num_aux + 1
        aux_names = base_cls.aux_names + ("p0",)
        default_aux = base_cls.default_aux + (0.5,)
        W_may_be_negative = base_cls.W_may_be_negative
        _base = base_cls()

        def base_log_density(self, y, f, base_aux):
            return self._base.log_lik(y, f, base_aux)

        def base_mean_m2(self, f, base_aux):
            m1, m2 = self._base._unit_moments(base_aux)
            s = torch.exp(f)
            return s * m1, s * s * m2

        def aux_to_internal(self, aux_orig):
            a = np.asarray(aux_orig, dtype=np.float64)
            base = self._base.aux_to_internal(a[:-1])
            p0 = a[-1]
            if not (0.0 < p0 < 1.0):
                raise ValueError("p0 must be in (0, 1)")
            return np.concatenate([base, [p0 / (1.0 - p0)]])

        def aux_from_internal(self, aux_internal):
            a = np.asarray(aux_internal, dtype=np.float64)
            base = self._base.aux_from_internal(a[:-1])
            return np.concatenate([base, [a[-1] / (1.0 + a[-1])]])

        def init_aux(self, y):
            y = np.asarray(y, dtype=np.float64)
            return np.concatenate([self._base.init_aux(y[y > 0.0]),
                                   [self._init_p0(y)]])

    HurdleEGPD.__name__ = "Hurdle" + base_cls.__name__
    return HurdleEGPD


HurdleGPD = _make_hurdle_egpd(GPD, "hurdle_gpd")
HurdleEGPDPower = _make_hurdle_egpd(EGPDPower, "hurdle_egpd_power")
HurdleEGPDPowerMixture = _make_hurdle_egpd(EGPDPowerMixture,
                                           "hurdle_egpd_power_mixture")
HurdleEGPDBeta = _make_hurdle_egpd(EGPDBeta, "hurdle_egpd_beta")
HurdleEGPDPowerBeta = _make_hurdle_egpd(EGPDPowerBeta,
                                        "hurdle_egpd_power_beta")


# ----------------------------------------------------------------------
# censored families
class ZeroCensoredPowerTransformedNormal(Likelihood):
    """zero_censored_power_transformed_normal (likelihoods.h:107-111):
    Y = max(0, X)^lambda, X ~ N(f, sigma^2); aux = (sigma, lambda)."""

    name = "zero_censored_power_transformed_normal"
    W_may_be_zero = True
    num_aux = 2
    aux_names = ("sigma", "lambda")
    default_aux = (1.0, 1.0)

    def log_lik(self, y, f, aux):
        sigma, lam = aux[0], aux[1]
        ys = _where_pos(y)
        u = ys ** (1.0 / lam)
        ll_pos = (_logphi((u - f) / sigma) - torch.log(sigma)
                  - torch.log(lam) + (1.0 / lam - 1.0) * torch.log(ys))
        return torch.where(y > 0.0, ll_pos, log_ndtr(-f / sigma))

    def check_y(self, y):
        y = np.asarray(y, dtype=np.float64)
        if np.any(y < 0.0):
            raise ValueError(f"{self.name} requires nonnegative responses")
        return y

    def init_aux(self, y):
        # the positive part's spread and lambda = 1 (a simplified version
        # of the reference's moment matching, likelihoods.h:2266+)
        y = np.asarray(y, dtype=np.float64)
        pos = y[y > 0.0]
        s = float(np.std(pos)) if len(pos) > 1 else 1.0
        return np.asarray([max(s, 1e-3), 1.0])

    def _moments(self, f, aux):
        sigma, lam = aux[0], aux[1]
        x = f[..., None] + sigma * _const(_HE_X, f)
        yv = torch.clamp(x, min=0.0) ** lam
        w = _const(_HE_W, f)
        return torch.sum(w * yv, -1), torch.sum(w * yv * yv, -1)

    def cond_mean(self, f, aux):
        return self._moments(f, aux)[0]

    def cond_var(self, f, aux):
        m, m2 = self._moments(f, aux)
        return m2 - m * m


class Zoctn(Likelihood):
    """zoctn: censored logit-transformed normal (likelihoods.h:119-127).
    T ~ N(f, sigma^2), W = clamp(T, 0, 1), Y = expit(a + b logit(W));
    aux = (sigma, a [real, kept as exp(a)], b)."""

    name = "zoctn"
    W_may_be_zero = True
    num_aux = 3
    aux_names = ("sigma", "a", "b")
    default_aux = (1.0, 0.0, 1.0)

    def log_lik(self, y, f, aux):
        sigma, ea, b = aux[0], aux[1], aux[2]
        a = torch.log(ea)
        at0 = y <= 0.0
        at1 = y >= 1.0
        interior = (~at0) & (~at1)
        y_in = torch.where(interior, y, torch.full_like(y, 0.5))
        logit_y = torch.log(y_in) - torch.log1p(-y_in)
        x = torch.sigmoid((logit_y - a) / b)
        ll_in = (_logphi((x - f) / sigma) - torch.log(sigma)
                 + torch.log(x) + torch.log1p(-x) - torch.log(b)
                 - torch.log(y_in) - torch.log1p(-y_in))
        return torch.where(at0, log_ndtr(-f / sigma),
                           torch.where(at1, log_ndtr(-(1.0 - f) / sigma),
                                       ll_in))

    def check_y(self, y):
        y = np.asarray(y, dtype=np.float64)
        if np.any(y < 0.0) or np.any(y > 1.0):
            raise ValueError("zoctn requires responses in [0, 1]")
        return y

    # a (real) kept as exp(a) (likelihoods.h:826-828, :897-902)
    def aux_to_internal(self, aux_orig):
        a = np.asarray(aux_orig, dtype=np.float64).copy()
        a[1] = math.exp(a[1])
        return a

    def aux_from_internal(self, aux_internal):
        a = np.asarray(aux_internal, dtype=np.float64).copy()
        a[1] = math.log(a[1])
        return a

    def init_aux(self, y):
        return np.asarray([0.5, 1.0, 1.0])     # sigma = 0.5, a = 0, b = 1

    def _y_of_t(self, t, a, b):
        tc = torch.clamp(t, 1e-12, 1.0 - 1e-12)
        return torch.sigmoid(a + b * (torch.log(tc) - torch.log1p(-tc)))

    def _moments(self, f, aux):
        sigma, ea, b = aux[0], aux[1], aux[2]
        a = torch.log(ea)
        t = f[..., None] + sigma * _const(_HE_X, f)
        yv = torch.where(t <= 0.0, torch.zeros_like(t),
                         torch.where(t >= 1.0, torch.ones_like(t),
                                     self._y_of_t(t, a, b)))
        w = _const(_HE_W, f)
        return torch.sum(w * yv, -1), torch.sum(w * yv * yv, -1)

    def cond_mean(self, f, aux):
        return self._moments(f, aux)[0]

    def cond_var(self, f, aux):
        m, m2 = self._moments(f, aux)
        return m2 - m * m


def _gl_nodes(n=64):
    """The n-node Gauss-Legendre rule mapped to [0, 1] (numpy)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


class ZeroOneCensoredTransformedBeta(Likelihood):
    """zero_one_censored_transformed_beta (Kosmidis & Zeileis 2025;
    likelihoods.h:129-134). aux = (phi, u); mu = sigmoid(f), a = mu phi,
    b = (1 - mu) phi, t = (y + u) / (1 + 2u). The censoring masses are
    regularized incomplete Beta integrals by differentiable Gauss-Legendre
    quadrature (no betainc with parameter derivatives is needed)."""

    name = "zero_one_censored_transformed_beta"
    W_may_be_zero = True
    link = "logit"
    num_aux = 2
    aux_names = ("precision", "shift")
    default_aux = (1.0, 0.1)

    _gl_x, _gl_w = _gl_nodes(64)

    def _log_lower(self, a, b, t0):
        """log int_0^t0 t^(a-1) (1-t)^(b-1) dt via t = t0 s^(1/a)."""
        s, w = _const(self._gl_x, a), _const(self._gl_w, a)
        t = t0 * s ** (1.0 / a[..., None])
        integ = torch.sum(w * (1.0 - t) ** (b[..., None] - 1.0), -1)
        return a * torch.log(t0) - torch.log(a) + torch.log(integ)

    def log_lik(self, y, f, aux):
        phi, u = aux[0], aux[1]
        mu = torch.sigmoid(f)
        a = mu * phi
        b = (1.0 - mu) * phi
        t0 = u / (1.0 + 2.0 * u)
        t1 = (1.0 + u) / (1.0 + 2.0 * u)
        lB = betaln(a, b)
        at0 = y <= 0.0
        at1 = y >= 1.0
        y_in = torch.where(at0 | at1, torch.full_like(y, 0.5), y)
        t = (y_in + u) / (1.0 + 2.0 * u)
        ll_in = ((a - 1.0) * torch.log(t) + (b - 1.0) * torch.log1p(-t)
                 - lB - torch.log1p(2.0 * u))
        ll0 = self._log_lower(a, b, t0) - lB
        ll1 = self._log_lower(b, a, 1.0 - t1) - lB     # by symmetry
        return torch.where(at0, ll0, torch.where(at1, ll1, ll_in))

    def check_y(self, y):
        y = np.asarray(y, dtype=np.float64)
        if np.any(y < 0.0) or np.any(y > 1.0):
            raise ValueError(f"{self.name} requires responses in [0, 1]")
        return y

    def init_aux(self, y):
        y = np.asarray(y, dtype=np.float64)
        inner = y[(y > 0) & (y < 1)]
        if len(inner) > 3:
            m, v = float(np.mean(inner)), max(float(np.var(inner)), 1e-6)
            phi = min(max(m * (1 - m) / v - 1.0, 0.1), 100.0)
        else:
            phi = 1.0
        return np.asarray([phi, 0.1])

    def _moments(self, f, aux):
        phi, u = aux[0], aux[1]
        mu = torch.sigmoid(f)
        a = mu * phi
        b = (1.0 - mu) * phi
        t0 = u / (1.0 + 2.0 * u)
        t1 = (1.0 + u) / (1.0 + 2.0 * u)
        lB = betaln(a, b)
        p1 = torch.exp(self._log_lower(b, a, 1.0 - t1) - lB)
        # the interior integral over t in (t0, t1)
        s, w = _const(self._gl_x, f), _const(self._gl_w, f)
        t = t0 + (t1 - t0) * s
        yv = t * (1.0 + 2.0 * u) - u
        dens = torch.exp((a[..., None] - 1.0) * torch.log(t)
                         + (b[..., None] - 1.0) * torch.log1p(-t)
                         - lB[..., None])
        m_in = (t1 - t0) * torch.sum(w * yv * dens, -1)
        m2_in = (t1 - t0) * torch.sum(w * yv * yv * dens, -1)
        return p1 + m_in, p1 + m2_in

    def cond_mean(self, f, aux):
        return self._moments(f, aux)[0]

    def cond_var(self, f, aux):
        m, m2 = self._moments(f, aux)
        return m2 - m * m


_LAG_X, _LAG_W = np.polynomial.laguerre.laggauss(64)


class ZeroOneCensoredShiftedGamma(Likelihood):
    """zero_one_censored_shifted_gamma (Sigrist & Stahel 2011;
    likelihoods.h:136-141). Z ~ Gamma(k, theta), theta = exp(f) / k,
    Y = clamp(Z - xi, 0, 1); aux = (shape k, shift xi). The censoring
    masses are incomplete-gamma integrals by differentiable quadrature."""

    name = "zero_one_censored_shifted_gamma"
    W_may_be_zero = True
    link = "log"
    num_aux = 2
    aux_names = ("shape", "shift")
    default_aux = (1.0, 0.1)

    _gl_x, _gl_w = _gl_nodes(64)
    _lag_x, _lag_w = _LAG_X, _LAG_W

    def _log_lower_gamma(self, k, x0):
        """log int_0^x0 z^(k-1) e^-z dz via z = x0 s^(1/k)."""
        s, w = _const(self._gl_x, x0), _const(self._gl_w, x0)
        z = x0[..., None] * s ** (1.0 / k[..., None])
        integ = torch.sum(w * torch.exp(-z), -1)
        return k * torch.log(x0) - torch.log(k) + torch.log(integ)

    def _log_upper_gamma(self, k, x1):
        """log int_x1^inf z^(k-1) e^-z dz via z = x1 + t
        (Gauss-Laguerre)."""
        t, w = _const(self._lag_x, x1), _const(self._lag_w, x1)
        z = x1[..., None] + t
        integ = torch.sum(w * torch.exp((k[..., None] - 1.0)
                                        * torch.log(z)), -1)
        return torch.log(integ) - x1

    def log_lik(self, y, f, aux):
        k, xi = aux[0], aux[1]
        theta = torch.exp(f) / k
        kv = k * torch.ones_like(f)
        at0 = y <= 0.0
        at1 = y >= 1.0
        y_in = torch.where(at0 | at1, torch.full_like(y, 0.5), y)
        z = y_in + xi
        ll_in = ((k - 1.0) * torch.log(z) - z / theta - gammaln(k)
                 - k * torch.log(theta))
        ll0 = self._log_lower_gamma(kv, xi / theta) - gammaln(k)
        ll1 = self._log_upper_gamma(kv, (1.0 + xi) / theta) - gammaln(k)
        return torch.where(at0, ll0, torch.where(at1, ll1, ll_in))

    def check_y(self, y):
        y = np.asarray(y, dtype=np.float64)
        if np.any(y < 0.0) or np.any(y > 1.0):
            raise ValueError(f"{self.name} requires responses in [0, 1]")
        return y

    def init_aux(self, y):
        return np.asarray([1.0, 0.1])

    def _moments(self, f, aux):
        k, xi = aux[0], aux[1]
        theta = torch.exp(f) / k
        kv = k * torch.ones_like(f)
        p1 = torch.exp(self._log_upper_gamma(kv, (1.0 + xi) / theta)
                       - gammaln(k))
        # the interior: z in (xi, 1 + xi), y = z - xi
        s, w = _const(self._gl_x, f), _const(self._gl_w, f)
        z = xi + s
        dens = torch.exp((k - 1.0) * torch.log(z) - z / theta[..., None]
                         - gammaln(k) - k * torch.log(theta)[..., None])
        m_in = torch.sum(w * s * dens, -1)
        m2_in = torch.sum(w * s * s * dens, -1)
        return p1 + m_in, p1 + m2_in

    def cond_mean(self, f, aux):
        return self._moments(f, aux)[0]

    def cond_var(self, f, aux):
        m, m2 = self._moments(f, aux)
        return m2 - m * m


# ----------------------------------------------------------------------
# two-predictor likelihoods (num_sets_fixed_effects = 2, c_api.cpp:132):
# the first location block (eta) carries random and fixed effects, the
# second (zeta) fixed effects only; engines call log_lik2(y, eta, zeta, aux)
class GaussianHeteroscedastic(Likelihood):
    """gaussian_heteroscedastic (likelihoods.h:143-149): mu = eta,
    log(sigma2) = zeta. Fisher-Laplace is the reference's default and only
    approximation."""

    name = "gaussian_heteroscedastic"
    num_sets_fe = 2
    approx_type = "fisher_laplace"

    def log_lik2(self, y, f1, f2, aux):
        z = y - f1
        return -0.5 * (math.log(2.0 * math.pi) + f2) \
            - 0.5 * z * z * torch.exp(-f2)

    def fisher_W2(self, y, loc, f2, aux):
        return torch.exp(-f2) * torch.ones_like(loc)

    def init_intercept(self, y, tot_var, F=None):
        z = np.asarray(y) if F is None \
            else np.asarray(y) - np.asarray(F)[: len(y)]
        return float(np.mean(z))

    def init_intercept2(self, y, tot_var, F=None):
        """The log error variance's start (FindInitialIntercept
        ind_set_re = 1, likelihoods.h:1557-1590)."""
        z = np.asarray(y) if F is None \
            else np.asarray(y) - np.asarray(F)[: len(y)]
        sample_var = max(float(np.var(z, ddof=1)), 1e-8)
        return math.log(max(sample_var - tot_var, 1e-6))

    def response_mean_var2(self, mu_lat, var_lat, zeta, aux):
        return mu_lat, var_lat + torch.exp(zeta)


class GaussianHeteroscedasticFixedAndRandom(GaussianHeteroscedastic):
    """gaussian_heteroscedastic_fixed_and_random (likelihoods.h:474-485):
    the mean eta and the log error variance zeta both carry random effects
    (num_sets_re = 2), the same structure twice with covariance parameters
    of its own; fisher_laplace always (the log-likelihood is not jointly
    concave in mean and variance)."""

    name = "gaussian_heteroscedastic_fixed_and_random"
    num_sets_re = 2

    def fisher_W_stacked(self, y, loc1, loc2, aux):
        """The block-diagonal Fisher information of -loglik in (f1, f2):
        exp(-f2) and 1/2, no cross term
        (SecondDerivNegLogLikGaussianHeteroscedastic, Fisher branch)."""
        return torch.cat([torch.exp(-loc2), torch.full_like(loc2, 0.5)], -1)

    def response_mean_var_2re(self, mu1, var1, mu2, var2, aux):
        """E[y] = mu1, Var[y] = var1 + exp(mu2 + var2 / 2) when zeta is
        latent Gaussian."""
        return mu1, var1 + torch.exp(mu2 + 0.5 * var2)


class _HurdleRegressionBase(Likelihood):
    """hurdle_regression_<base> (likelihoods.h:90-93): the structural-zero
    probability pi_i = sigmoid(zeta_i) from the second block; aux = the
    base's aux parameters (no constant p0)."""

    link = "log"
    num_sets_fe = 2
    W_may_be_zero = True
    _hurdle = None        # the constant-p0 hurdle family giving the base

    def log_lik2(self, y, f, zeta, aux):
        lp = _log_sigmoid(zeta)
        l1mp = _log_sigmoid(-zeta)
        ll_pos = l1mp + self._hurdle.base_log_density(_where_pos(y), f, aux)
        return torch.where(y > 0.0, ll_pos, lp)

    def check_y(self, y):
        return self._hurdle.check_y(y)

    def init_intercept2(self, y, tot_var, F=None):
        z = min(max(float(np.mean(np.asarray(y) <= 0.0)), 1e-3), 1 - 1e-3)
        return float(np.clip(math.log(z / (1 - z)), -3.0, 3.0))

    def response_mean_var2(self, mu_lat, var_lat, zeta, aux):
        Ey, Ey2 = _gh_expect(mu_lat, var_lat,
                             lambda f: self._hurdle.base_mean_m2(f, aux))
        q = torch.sigmoid(-zeta)         # 1 - pi
        Ey, Ey2 = q * Ey, q * Ey2
        return Ey, Ey2 - Ey * Ey


def _make_hurdle_regression(hurdle_cls, name):
    class HReg(_HurdleRegressionBase):
        _hurdle = hurdle_cls()
        num_aux = hurdle_cls.num_aux - 1            # no trailing p0
        aux_names = hurdle_cls.aux_names[:-1]
        default_aux = hurdle_cls.default_aux[:-1]
        W_may_be_negative = getattr(hurdle_cls, "W_may_be_negative", False)

        def aux_to_internal(self, aux_orig):
            if self.num_aux == 0:
                return np.asarray([], dtype=np.float64)
            a = np.concatenate([np.asarray(aux_orig, dtype=np.float64),
                                [0.5]])                 # a dummy p0
            return self._hurdle.aux_to_internal(a)[:-1]

        def aux_from_internal(self, aux_internal):
            if self.num_aux == 0:
                return np.asarray([], dtype=np.float64)
            a = np.concatenate([np.asarray(aux_internal, dtype=np.float64),
                                [1.0]])                 # dummy odds
            return self._hurdle.aux_from_internal(a)[:-1]

        def init_aux(self, y):
            return self._hurdle.init_aux(np.asarray(y))[:-1]

    HReg.name = name
    HReg.__name__ = "HurdleRegression" + hurdle_cls.__name__
    return HReg


HurdleRegressionGamma = _make_hurdle_regression(
    HurdleGamma, "hurdle_regression_gamma")
HurdleRegressionLognormal = _make_hurdle_regression(
    HurdleLognormal, "hurdle_regression_lognormal")
HurdleRegressionGPD = _make_hurdle_regression(
    HurdleGPD, "hurdle_regression_gpd")
HurdleRegressionEGPDPower = _make_hurdle_regression(
    HurdleEGPDPower, "hurdle_regression_egpd_power")
HurdleRegressionEGPDPowerMixture = _make_hurdle_regression(
    HurdleEGPDPowerMixture, "hurdle_regression_egpd_power_mixture")
HurdleRegressionEGPDBeta = _make_hurdle_regression(
    HurdleEGPDBeta, "hurdle_regression_egpd_beta")
HurdleRegressionEGPDPowerBeta = _make_hurdle_regression(
    HurdleEGPDPowerBeta, "hurdle_regression_egpd_power_beta")


class _ZICountRegressionBase(_ZICountBase):
    """zero_inflated_regression_<count> (likelihoods.h:90-93): the
    structural-zero probability pi_i = sigmoid(zeta_i); aux = the base
    count's aux parameter only."""

    num_sets_fe = 2
    approx_type = "combined"

    def _base_aux(self, aux):
        return aux[0] if self.num_aux >= 1 else None

    def log_lik2(self, y, f, zeta, aux):
        lp = _log_sigmoid(zeta)
        l1mp = _log_sigmoid(-zeta)
        ba = self._base_aux(aux)
        b0 = self._b0(torch.exp(f), ba)
        ll0 = _logaddexp(lp, l1mp + b0)
        ll_pos = l1mp + self._base_ll_pos(_where_pos(y), f, ba)
        return torch.where(y > 0.0, ll_pos, ll0)

    def fisher_W2(self, y, loc, zeta, aux):
        """ZICountFisherInfoEtaExplicit with pi = sigmoid(zeta_i)
        (likelihoods.h:11546-11553)."""
        return self._zi_fisher(torch.sigmoid(zeta), loc, self._base_aux(aux))

    # base aux only: identity transforms
    def aux_to_internal(self, aux_orig):
        return np.asarray(aux_orig, dtype=np.float64)

    def aux_from_internal(self, aux_internal):
        return np.asarray(aux_internal, dtype=np.float64)

    def init_intercept2(self, y, tot_var, F=None):
        z = min(max(float(np.mean(np.asarray(y) <= 0.0)), 1e-3), 1 - 1e-3)
        return float(np.clip(math.log(z / (1 - z)), -3.0, 3.0))

    def response_mean_var2(self, mu_lat, var_lat, zeta, aux):
        ba = self._base_aux(aux)
        Ey, Ey2 = _gh_expect(mu_lat, var_lat,
                             lambda f: self._base_m_m2(f, ba))
        q = torch.sigmoid(-zeta)
        Ey, Ey2 = q * Ey, q * Ey2
        return Ey, Ey2 - Ey * Ey


class ZeroInflatedRegressionPoisson(_ZICountRegressionBase,
                                    ZeroInflatedPoisson):
    name = "zero_inflated_regression_poisson"
    num_aux = 0
    aux_names = ()
    default_aux = ()

    def init_aux(self, y):
        return np.asarray([], dtype=np.float64)


class ZeroInflatedRegressionNegativeBinomial(_ZICountRegressionBase,
                                             ZeroInflatedNegativeBinomial):
    name = "zero_inflated_regression_negative_binomial"
    num_aux = 1
    aux_names = ("shape",)
    default_aux = (1.0,)

    def init_aux(self, y):
        mean_y, var_y = _count_mean_var(y)
        return np.asarray([min(max(mean_y ** 2 / max(var_y - mean_y, 1e-6),
                                   1e-2), 1e6)])


class ZeroInflatedRegressionNegativeBinomial1(_ZICountRegressionBase,
                                              ZeroInflatedNegativeBinomial1):
    name = "zero_inflated_regression_negative_binomial_1"
    num_aux = 1
    aux_names = ("dispersion",)
    default_aux = (1.0,)

    def init_aux(self, y):
        mean_y, var_y = _count_mean_var(y)
        return np.asarray([min(max(var_y / mean_y - 1.0, 1e-3), 1e6)])


FAMILY_CLASSES = (
    QuasiBernoulliLogit, QuasiBernoulliProbit, BetaBinomial,
    HurdleGamma, HurdleLognormal,
    ZeroInflatedPoisson, ZeroInflatedNegativeBinomial,
    ZeroInflatedNegativeBinomial1,
    GPD, EGPDPower, EGPDPowerMixture, EGPDBeta, EGPDPowerBeta,
    HurdleGPD, HurdleEGPDPower, HurdleEGPDPowerMixture, HurdleEGPDBeta,
    HurdleEGPDPowerBeta,
    ZeroCensoredPowerTransformedNormal, Zoctn,
    ZeroOneCensoredTransformedBeta, ZeroOneCensoredShiftedGamma,
    GaussianHeteroscedastic, GaussianHeteroscedasticFixedAndRandom,
    HurdleRegressionGamma, HurdleRegressionLognormal, HurdleRegressionGPD,
    HurdleRegressionEGPDPower, HurdleRegressionEGPDPowerMixture,
    HurdleRegressionEGPDBeta, HurdleRegressionEGPDPowerBeta,
    ZeroInflatedRegressionPoisson, ZeroInflatedRegressionNegativeBinomial,
    ZeroInflatedRegressionNegativeBinomial1,
)
