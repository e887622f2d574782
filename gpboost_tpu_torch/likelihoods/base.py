"""Likelihoods of the PyTorch port: per-sample log densities on tensors
(counterpart of gpboost_tpu/likelihoods/base.py; reference
include/GPBoost/likelihoods.h, parameterizations at :15-146).

Each likelihood defines its per-sample log density log p(y | f, aux) as a
torch function of the location f (random plus fixed effects) and the
positive auxiliary parameters; the first and second derivatives in f come
from autodiff of the summed log density (`torch.func.grad`, nested), as in
the reference. All functions broadcast y against f, so an engine can
evaluate a batch of candidate locations (k, n) against y (n,) in one call.

Auxiliary parameters enter on their internal positive scale (the
optimizers work on their logs); `aux_to_internal` / `aux_from_internal`
map the user's scale (Tweedie's power p) to it. The host helpers (label
checks, initial values, learning-rate cap constants) stay numpy, copied from
the reference.

The 16 families defined here and the 34 of likelihoods/families.py are
registered by name; the '_tkc' suffix selects the triangular-kernel
curvature of likelihoods/tkc.py (asymmetric_laplace only).
"""

import math

import numpy as np
import torch
from torch.special import gammaln, log_ndtr, ndtr


def betaln(a, b):
    """log B(a, b) = lgamma(a) + lgamma(b) - lgamma(a + b)."""
    return gammaln(a) + gammaln(b) - gammaln(a + b)


def _logaddexp0(f):
    """log(1 + exp(f)), exact in both tails."""
    return torch.logaddexp(torch.zeros_like(f), f)


class Likelihood:
    """Base class: subclasses set `name`, `num_aux`, `aux_names` and define
    `log_lik(y, f, aux)` (elementwise) and the response-scale helpers."""

    name = None
    num_aux = 0
    aux_names = ()
    default_aux = ()
    integer_response = False
    num_sets_fe = 1
    #: "laplace" (observed Hessian), "fisher_laplace" (Fisher information
    #: for mode finding and determinant) or "combined" (Fisher for mode
    #: finding only), likelihoods.h:327-369
    approx_type = "laplace"
    W_may_be_negative = False
    W_may_be_zero = False
    mode_finding = None
    var_correction = None
    kink_clipping = False
    #: link family of the data-driven intercept: "log", "logit", "probit",
    #: "identity", "identity_median"
    link = "identity"

    def log_lik(self, y, f, aux):
        raise NotImplementedError

    # per-sample derivatives in f: log_lik is elementwise, so the gradient
    # of the sum is the vector of derivatives
    def d1(self, y, f, aux):
        return torch.func.grad(
            lambda ff: torch.sum(self.log_lik(y, ff, aux)))(f)

    def d2(self, y, f, aux):
        return torch.func.grad(lambda ff: torch.sum(self.d1(y, ff, aux)))(f)

    def check_y(self, y):
        """Validate the response (raises ValueError on bad labels)."""
        return np.asarray(y, dtype=np.float64)

    def init_aux(self, y):
        """Data-driven initial aux parameters (internal positive scale)."""
        return np.asarray(self.default_aux, dtype=np.float64)

    def aux_to_internal(self, aux_orig):
        return np.asarray(aux_orig, dtype=np.float64)

    def aux_from_internal(self, aux_internal):
        return np.asarray(aux_internal, dtype=np.float64)

    # ------------------------------------------------------------------
    def init_intercept(self, y, tot_var, F=None):
        """Data-driven initial intercept (likelihoods.h:1435
        FindInitialIntercept)."""
        y = np.asarray(y, dtype=np.float64)
        if self.link in ("logit", "probit"):
            pavg = float(np.mean(y))
            pavg = min(max(pavg, 1e-12), 1 - 1e-12)
            from scipy.stats import norm as _n
            v = (np.log(pavg / (1 - pavg)) if self.link == "logit"
                 else float(_n.ppf(pavg)))
            return float(np.clip(v, -3.0, 3.0))
        if self.link == "log":
            avg = float(np.mean(y / np.exp(F))) if F is not None \
                else float(np.mean(y))
            return float(np.log(max(avg, 1e-12)) - 0.5 * tot_var)
        if self.link == "identity_median":
            z = y if F is None else y - np.asarray(F)
            return float(np.median(z))
        z = y if F is None else y - np.asarray(F)
        return float(np.mean(z))

    def cap_constants(self, y, F=None):
        """(C_mu, C_sigma2) of the coefficient learning-rate cap
        (likelihoods.h:2593 FindConstantsCapTooLargeLearningRateCoef)."""
        y = np.asarray(y, dtype=np.float64)
        if self.link in ("logit", "probit"):
            return 1.0, 1.0
        if self.link == "log":
            mean = float(np.mean(y))
            var = float(np.mean(y * y) - mean * mean)

            def safe(x):
                return np.log(x) if x > 1e-300 else 0.0
            return abs(safe(mean)), abs(safe(var))
        if self.link == "identity_median":
            z = y if F is None else y - np.asarray(F)
            med = float(np.median(z))
            mad = 1.4826 * float(np.median(np.abs(z - med)))
            s2 = mad * mad
            if s2 <= 1e-300:
                q75, q25 = np.percentile(z, [75, 25])
                s2 = ((q75 - q25) / 1.349) ** 2
            return med, s2
        z = y if F is None else y - np.asarray(F)
        mean = float(np.mean(z))
        return abs(mean), float(np.mean(z * z) - mean * mean)

    # ------------------------------------------------------------------
    def test_neg_log_likelihood(self, y, pred_mean, pred_var, aux_pars=None):
        """Mean negative log predictive density by adaptive 30-point
        Gauss-Hermite quadrature (likelihoods.h:10157
        TestNegLogLikelihoodAdaptiveGHQuadrature): Newton on the integrand,
        nodes centred at its mode with a curvature-matched width. aux_pars
        on the user's scale. Runs in float64 on the CPU."""
        f64 = torch.float64
        y = torch.as_tensor(self.check_y(np.asarray(y)), dtype=f64)
        m = torch.as_tensor(np.asarray(pred_mean, dtype=np.float64))
        v = torch.as_tensor(np.asarray(pred_var, dtype=np.float64))
        aux = None
        if self.num_aux:
            aux = torch.as_tensor(self.aux_to_internal(np.asarray(aux_pars)))
        sigma2_inv = 1.0 / v
        b = torch.zeros_like(m)
        for _ in range(60):
            g = self.d1(y, b, aux) - sigma2_inv * (b - m)
            h = self.d2(y, b, aux) - sigma2_inv
            b = b - g / h
        W = -self.d2(y, b, aux)
        sqrt2_sigma_hat = math.sqrt(2.0) / torch.sqrt(W + sigma2_inv)
        nodes, weights = np.polynomial.hermite.hermgauss(30)
        aw = torch.as_tensor(weights * np.exp(nodes ** 2))
        x = b[:, None] + sqrt2_sigma_hat[:, None] * torch.as_tensor(
            nodes)[None, :]
        ll_nodes = self.log_lik(y[:, None], x, aux)
        dens = torch.exp(ll_nodes) * torch.exp(
            -0.5 * sigma2_inv[:, None] * (x - m[:, None]) ** 2) \
            / math.sqrt(2.0 * math.pi)
        lik = torch.sum(aw[None, :] * dens, dim=1) \
            * sqrt2_sigma_hat * torch.sqrt(sigma2_inv)
        return float(-torch.mean(torch.log(lik)))

    # ------------------------------------------------------------------
    def response_mean_var(self, mu_lat, var_lat, aux):
        """E[y], Var[y] under f ~ N(mu_lat, var_lat) (PredictResponse,
        likelihoods.h:9581): 100-point Gauss-Hermite quadrature over the
        latent Gaussian (likelihoods.h:10083)."""
        nodes, weights = np.polynomial.hermite_e.hermegauss(100)
        nodes = torch.as_tensor(nodes, dtype=mu_lat.dtype,
                                device=mu_lat.device)
        weights = torch.as_tensor(weights, dtype=mu_lat.dtype,
                                  device=mu_lat.device)
        weights = weights / torch.sum(weights)
        f = mu_lat[:, None] + torch.sqrt(var_lat)[:, None] * nodes[None, :]
        m = self.cond_mean(f, aux)
        v = self.cond_var(f, aux)
        Ey = torch.sum(weights[None, :] * m, dim=1)
        Ey2 = torch.sum(weights[None, :] * (v + m * m), dim=1)
        return Ey, Ey2 - Ey * Ey

    def cond_mean(self, f, aux):
        raise NotImplementedError

    def cond_var(self, f, aux):
        raise NotImplementedError


def _check_binary(y, name):
    y = np.asarray(y, dtype=np.float64)
    if not np.all((y == 0) | (y == 1)):
        raise ValueError("Response variable (label) data needs to be 0 or 1 "
                         f"for likelihood {name}")
    return y


def _check_fraction(y, name):
    y = np.asarray(y, dtype=np.float64)
    if np.any(y < 0) or np.any(y > 1):
        raise ValueError("Response variable data needs to be in [0, 1] "
                         "(successes / trials) for likelihood "
                         f"{name}; pass trials via weights")
    return y


def _check_count(y, name):
    y = np.asarray(y, dtype=np.float64)
    if np.any(y < 0) or not np.all(y == np.floor(y)):
        raise ValueError("Response variable data needs to be a non-negative "
                         f"integer for likelihood {name}")
    return y


def _check_positive(y, name):
    y = np.asarray(y, dtype=np.float64)
    if np.any(y <= 0):
        raise ValueError("Response variable data needs to be positive "
                         f"for likelihood {name}")
    return y


# ----------------------------------------------------------------------
class BernoulliProbit(Likelihood):
    name = "bernoulli_probit"
    integer_response = True
    link = "probit"

    def log_lik(self, y, f, aux):
        # log Phi(f) if y == 1 else log Phi(-f)
        return torch.where(y > 0.5, log_ndtr(f), log_ndtr(-f))

    def check_y(self, y):
        return _check_binary(y, self.name)

    def cond_mean(self, f, aux):
        return ndtr(f)

    def cond_var(self, f, aux):
        p = ndtr(f)
        return p * (1.0 - p)

    def response_mean_var(self, mu_lat, var_lat, aux):
        # closed form: E[y] = Phi(mu / sqrt(1 + var))
        p = ndtr(mu_lat / torch.sqrt(1.0 + var_lat))
        return p, p * (1.0 - p)


class BernoulliLogit(Likelihood):
    name = "bernoulli_logit"
    integer_response = True
    link = "logit"

    def log_lik(self, y, f, aux):
        return y * f - _logaddexp0(f)

    def check_y(self, y):
        return _check_binary(y, self.name)

    def cond_mean(self, f, aux):
        return torch.sigmoid(f)

    def cond_var(self, f, aux):
        p = torch.sigmoid(f)
        return p * (1.0 - p)


class BinomialLogit(BernoulliLogit):
    """y = successes / trials in [0, 1], the trials passed as weights."""

    name = "binomial_logit"

    def check_y(self, y):
        return _check_fraction(y, self.name)


class BinomialProbit(BernoulliProbit):
    """y = successes / trials in [0, 1], the trials passed as weights."""

    name = "binomial_probit"

    def log_lik(self, y, f, aux):
        return y * log_ndtr(f) + (1.0 - y) * log_ndtr(-f)

    def check_y(self, y):
        return _check_fraction(y, self.name)


class Poisson(Likelihood):
    name = "poisson"
    integer_response = True
    link = "log"

    def log_lik(self, y, f, aux):
        return y * f - torch.exp(f) - gammaln(y + 1.0)

    def check_y(self, y):
        return _check_count(y, self.name)

    def cond_mean(self, f, aux):
        return torch.exp(f)

    def cond_var(self, f, aux):
        return torch.exp(f)


class Gamma(Likelihood):
    name = "gamma"
    link = "log"
    num_aux = 1
    aux_names = ("shape",)
    default_aux = (1.0,)

    def log_lik(self, y, f, aux):
        # likelihoods.h:20-23: mu = exp(f), lambda = gamma / mu
        gam = aux[0]
        log_lam = torch.log(gam) - f
        return (gam * log_lam - gammaln(gam) + (gam - 1.0) * torch.log(y)
                - torch.exp(log_lam) * y)

    def check_y(self, y):
        return _check_positive(y, self.name)

    def init_aux(self, y):
        return np.asarray([1.0])

    def cond_mean(self, f, aux):
        return torch.exp(f)

    def cond_var(self, f, aux):
        mu = torch.exp(f)
        return mu * mu / aux[0]


class NegativeBinomial(Likelihood):
    name = "negative_binomial"
    link = "log"
    num_aux = 1
    aux_names = ("shape",)
    default_aux = (1.0,)
    integer_response = True

    def log_lik(self, y, f, aux):
        # likelihoods.h:52-55: mu = exp(f), p = r / (mu + r)
        r = aux[0]
        mu = torch.exp(f)
        return (gammaln(y + r) - gammaln(y + 1.0) - gammaln(r)
                + y * (f - torch.log(mu + r))
                + r * (torch.log(r) - torch.log(mu + r)))

    def check_y(self, y):
        return _check_count(y, self.name)

    def cond_mean(self, f, aux):
        return torch.exp(f)

    def cond_var(self, f, aux):
        mu = torch.exp(f)
        return mu * (mu + aux[0]) / aux[0]


class NegativeBinomial1(Likelihood):
    name = "negative_binomial_1"
    link = "log"
    num_aux = 1
    aux_names = ("dispersion",)
    default_aux = (1.0,)
    integer_response = True

    def log_lik(self, y, f, aux):
        # likelihoods.h:57-60: mu = exp(f), r = mu / phi, p = 1 / (1 + phi)
        phi = aux[0]
        r = torch.exp(f) / phi
        log_p = -torch.log1p(phi)
        log_1mp = torch.log(phi) - torch.log1p(phi)
        return (gammaln(y + r) - gammaln(y + 1.0) - gammaln(r)
                + y * log_1mp + r * log_p)

    def check_y(self, y):
        return _check_count(y, "negative_binomial")

    def cond_mean(self, f, aux):
        return torch.exp(f)

    def cond_var(self, f, aux):
        return torch.exp(f) * (1.0 + aux[0])


class Beta(Likelihood):
    name = "beta"
    link = "logit"
    num_aux = 1
    aux_names = ("precision",)
    default_aux = (1.0,)

    def log_lik(self, y, f, aux):
        # Ferrari & Cribari-Neto (likelihoods.h:42-45): mu = sigmoid(f)
        phi = aux[0]
        mu = torch.sigmoid(f)
        a = mu * phi
        b = (1.0 - mu) * phi
        return ((a - 1.0) * torch.log(y) + (b - 1.0) * torch.log1p(-y)
                - betaln(a, b))

    def check_y(self, y):
        y = np.asarray(y, dtype=np.float64)
        if np.any(y <= 0) or np.any(y >= 1):
            raise ValueError("Response variable data needs to be in (0, 1) "
                             "for likelihood beta")
        return y

    def cond_mean(self, f, aux):
        return torch.sigmoid(f)

    def cond_var(self, f, aux):
        mu = torch.sigmoid(f)
        return mu * (1.0 - mu) / (1.0 + aux[0])


def _t_log_lik(y, f, sigma, nu):
    # likelihoods.h:36-39
    z = (y - f) / sigma
    return (gammaln((nu + 1.0) / 2.0) - gammaln(nu / 2.0)
            - 0.5 * torch.log(nu * math.pi) - torch.log(sigma)
            - (nu + 1.0) / 2.0 * torch.log1p(z * z / nu))


def _inf_unless(cond, value):
    return torch.where(cond, value, torch.full_like(value, math.inf))


class StudentT(Likelihood):
    name = "t"
    link = "identity_median"
    num_aux = 2
    aux_names = ("scale", "df")
    default_aux = (1.0, 2.0)
    approx_type = "fisher_laplace"     # the reference's default for t

    def log_lik(self, y, f, aux):
        return _t_log_lik(y, f, aux[0], aux[1])

    @staticmethod
    def _mad_scale(y):
        # 1.4826 * MAD, the IQR when the MAD is zero
        # (likelihoods.h:1948-1985 FindInitialAuxPars for 't')
        y = np.asarray(y, dtype=np.float64)
        mad = 1.4826 * np.median(np.abs(y - np.median(y)))
        if mad <= 1e-12:
            q75, q25 = np.percentile(y, [75, 25])
            mad = (q75 - q25) / 1.349
        return float(mad) if mad > 1e-12 else float(np.std(y)) + 1e-12

    def init_aux(self, y):
        return np.asarray([self._mad_scale(y), 2.0])

    def fisher_W(self, y, loc, aux):
        # Fisher information of the t location, (nu+1) / ((nu+3) sigma^2)
        sigma, nu = aux[0], aux[1]
        return torch.ones_like(loc) * ((nu + 1.0) / ((nu + 3.0) * sigma
                                                     * sigma))

    def cond_mean(self, f, aux):
        return f

    def cond_var(self, f, aux):
        sigma, nu = aux[0], aux[1]
        v = torch.ones_like(f) * (sigma * sigma * nu / (nu - 2.0))
        return _inf_unless(nu > 2.0, v)


class TFixDf(StudentT):
    name = "t_fix_df"
    num_aux = 1
    aux_names = ("scale",)
    default_aux = (1.0,)

    def __init__(self, df=2.0):
        self.df = df

    def log_lik(self, y, f, aux):
        return _t_log_lik(y, f, aux[0], torch.as_tensor(
            float(self.df), dtype=f.dtype, device=f.device))

    def init_aux(self, y):
        return np.asarray([self._mad_scale(y)])

    def fisher_W(self, y, loc, aux):
        nu = self.df
        return torch.ones_like(loc) * ((nu + 1.0)
                                       / ((nu + 3.0) * aux[0] * aux[0]))

    def cond_var(self, f, aux):
        nu = self.df
        if nu > 2.0:
            return torch.ones_like(f) * (aux[0] * aux[0] * nu / (nu - 2.0))
        return torch.full_like(f, math.inf)


class LogNormal(Likelihood):
    name = "lognormal"
    link = "log"
    num_aux = 1
    aux_names = ("variance",)
    default_aux = (1.0,)

    def log_lik(self, y, f, aux):
        # likelihoods.h:30-34: E[log y] = f - sigma2 / 2
        s2 = aux[0]
        z = torch.log(y) - (f - 0.5 * s2)
        return (-torch.log(y) - 0.5 * torch.log(2.0 * math.pi * s2)
                - z * z / (2.0 * s2))

    def check_y(self, y):
        return _check_positive(y, self.name)

    def init_aux(self, y):
        return np.asarray([float(np.var(np.log(y)))])

    def cond_mean(self, f, aux):
        return torch.exp(f)

    def cond_var(self, f, aux):
        mu = torch.exp(f)
        return (torch.exp(aux[0]) - 1.0) * mu * mu


class Tweedie(Likelihood):
    """Compound Poisson-gamma Tweedie, 1 < p < 2 (likelihoods.h:64-67):
    mu = exp(f), Var = phi mu^p. Internal aux = [phi, tau] with
    p = (2 tau + 1) / (tau + 1). Density by the Dunn-Smyth series with a
    fixed 200-term logsumexp; its weights do not depend on mu, so the
    derivatives in f are exact despite the truncation."""

    name = "tweedie"
    link = "log"
    num_aux = 2
    aux_names = ("dispersion", "power")
    default_aux = (1.0, 1.0)          # internal: phi = 1, tau = 1 -> p = 1.5
    _J = 200

    def _p_of(self, aux):
        tau = aux[1]
        return (2.0 * tau + 1.0) / (tau + 1.0)

    def log_lik(self, y, f, aux):
        phi = aux[0]
        p = torch.as_tensor(self._p_of(aux), dtype=f.dtype, device=f.device)
        mu = torch.exp(f)
        kappa = mu ** (2.0 - p) / (2.0 - p)
        theta_y = y * mu ** (1.0 - p) / (1.0 - p)
        exponent = (theta_y - kappa) / phi
        alpha = (2.0 - p) / (p - 1.0)
        j = torch.arange(1, self._J + 1, dtype=f.dtype, device=f.device)
        y_safe = torch.where(y > 0, y, torch.ones_like(y))
        logW = (j * alpha * torch.log(y_safe)[..., None]
                - j * alpha * torch.log(p - 1.0)
                - j * (1.0 + alpha) * torch.log(phi)
                - j * torch.log(2.0 - p)
                - gammaln(j + 1.0)
                - gammaln(j * alpha))
        log_series = torch.logsumexp(logW, dim=-1)
        log_pos = -torch.log(y_safe) + exponent + log_series
        return torch.where(y > 0, log_pos, -kappa / phi)

    def check_y(self, y):
        y = np.asarray(y, dtype=np.float64)
        if np.any(y < 0):
            raise ValueError("Response variable data needs to be >= 0 "
                             "for likelihood tweedie")
        return y

    def init_aux(self, y):
        return np.asarray([1.0, 1.0])

    def aux_to_internal(self, aux_orig):
        phi, p = np.asarray(aux_orig, dtype=np.float64)
        if not (1.0 < p < 2.0):
            raise ValueError("tweedie power p must be in (1, 2)")
        return np.asarray([phi, (p - 1.0) / (2.0 - p)])

    def aux_from_internal(self, aux_internal):
        phi, tau = np.asarray(aux_internal, dtype=np.float64)
        return np.asarray([phi, (2.0 * tau + 1.0) / (tau + 1.0)])

    def cond_mean(self, f, aux):
        return torch.exp(f)

    def cond_var(self, f, aux):
        return aux[0] * torch.exp(f) ** self._p_of(aux)


class TweedieFixedP(Tweedie):
    """tweedie_fixed_p: a fixed variance power, only phi estimated."""

    name = "tweedie_fixed_p"
    num_aux = 1
    aux_names = ("dispersion",)
    default_aux = (1.0,)

    def __init__(self, p=1.5):
        self.p = p

    def _p_of(self, aux):
        return self.p

    def init_aux(self, y):
        return np.asarray([1.0])

    def aux_to_internal(self, aux_orig):
        return np.asarray(aux_orig, dtype=np.float64)

    def aux_from_internal(self, aux_internal):
        return np.asarray(aux_internal, dtype=np.float64)


class AsymmetricLaplace(Likelihood):
    """Quantile regression (likelihoods.h:126-131):
    f(y) = q(1-q)/sigma exp((y - loc)/sigma (1{y < loc} - q)), with the
    Fisher-Laplace curvature q(1-q)/sigma^2 (the density is kinked at the
    mode; the reference's default)."""

    name = "asymmetric_laplace"
    link = "identity_median"
    num_aux = 1
    aux_names = ("scale",)
    default_aux = (1.0,)
    approx_type = "fisher_laplace"

    def __init__(self, quantile=0.5):
        self.q = quantile

    def log_lik(self, y, f, aux):
        sigma = aux[0]
        q = self.q
        z = (y - f) / sigma
        return (math.log(q * (1.0 - q)) - torch.log(sigma)
                - z * (q - (y < f).to(f.dtype)))

    def fisher_W(self, y, loc, aux):
        sigma = aux[0]
        return torch.ones_like(loc) * (self.q * (1.0 - self.q)
                                       / (sigma * sigma))

    def init_intercept(self, y, tot_var, F=None):
        # zero on purpose: the marginal likelihood is flat for a small
        # scale (likelihoods.h:1783)
        return 0.0

    def init_aux(self, y):
        # the scale's MLE at location 0 (likelihoods.h:2553-2573)
        y = np.asarray(y, dtype=np.float64)
        ind = (y <= 0.0).astype(np.float64)
        return np.asarray([-np.sum(y * (ind - self.q)) / len(y)])

    def cond_mean(self, f, aux):
        q = self.q
        return f + aux[0] * (1.0 - 2.0 * q) / (q * (1.0 - q))

    def cond_var(self, f, aux):
        q = self.q
        s = aux[0]
        return torch.ones_like(f) * (s * s * (1.0 - 2.0 * q + 2.0 * q * q)
                                     / (q * q * (1.0 - q) ** 2))


class GaussianLatent(Likelihood):
    """A Gaussian response through the latent (Laplace) code path
    (likelihood='gaussian_latent', re_model_template.h:207-210); the aux
    parameter is the error variance."""

    name = "gaussian_latent"
    num_aux = 1
    aux_names = ("error_variance",)
    default_aux = (1.0,)

    def log_lik(self, y, f, aux):
        s2 = aux[0]
        z = y - f
        return -0.5 * torch.log(2.0 * math.pi * s2) - z * z / (2.0 * s2)

    def init_aux(self, y):
        return np.asarray([float(np.var(y)) / 2.0])

    def cond_mean(self, f, aux):
        return f

    def cond_var(self, f, aux):
        return torch.ones_like(f) * aux[0]

    def response_mean_var(self, mu_lat, var_lat, aux):
        return mu_lat, var_lat + aux[0]


_REGISTRY = {cls.name: cls for cls in (
    BernoulliProbit, BernoulliLogit, BinomialLogit, BinomialProbit, Poisson,
    Gamma, NegativeBinomial, NegativeBinomial1, Beta, StudentT, LogNormal,
    GaussianLatent, Tweedie, AsymmetricLaplace)}

from .families import FAMILY_CLASSES as _FAMILY_CLASSES   # noqa: E402
_REGISTRY.update({cls.name: cls for cls in _FAMILY_CLASSES})

#: the likelihoods registered by likelihoods/families.py
FAMILY_NAMES = tuple(sorted(cls.name for cls in _FAMILY_CLASSES))

SUPPORTED_LIKELIHOODS = tuple(sorted(_REGISTRY)) + (
    "t_fix_df", "tweedie_fixed_p", "gaussian")

# the complete alias map of ParseLikelihoodAlias (likelihoods.h:10210-10317)
_ALIASES = {
    "binary_probit": "bernoulli_probit",
    "binary": "bernoulli_logit",
    "binary_logit": "bernoulli_logit",
    "binomial": "binomial_logit",
    "quasi_binary_probit": "quasi_bernoulli_probit",
    "quasi_binary": "quasi_bernoulli_logit",
    "quasi_binary_logit": "quasi_bernoulli_logit",
    "regression": "gaussian",
    "nbinom2": "negative_binomial",
    "negative_binomial_2": "negative_binomial",
    "negative_binomial2": "negative_binomial",
    "nbinom1": "negative_binomial_1",
    "negative_binomial1": "negative_binomial_1",
    "student_t": "t",
    "student-t": "t",
    "t_distribution": "t",
    "t-distribution": "t",
    "log-normal": "lognormal",
    "log_normal": "lognormal",
    "beta-binomial": "beta_binomial",
    "betabinomial": "beta_binomial",
    "zero-inflated-gamma": "hurdle_gamma",
    "zero_inflated_gamma": "hurdle_gamma",
    "zero_inflated_lognormal": "hurdle_lognormal",
    "zero-inflated-lognormal": "hurdle_lognormal",
    "hurdle_poisson": "zero_inflated_poisson",
    "zero_inflated_nbinom2": "zero_inflated_negative_binomial",
    "zero_inflated_negative_binomial_2": "zero_inflated_negative_binomial",
    "zero_inflated_nbinom": "zero_inflated_negative_binomial",
    "hurdle_negative_binomial": "zero_inflated_negative_binomial",
    "hurdle_nbinom2": "zero_inflated_negative_binomial",
    "hurdle_negative_binomial_2": "zero_inflated_negative_binomial",
    "zero_inflated_nbinom1": "zero_inflated_negative_binomial_1",
    "hurdle_negative_binomial_1": "zero_inflated_negative_binomial_1",
    "hurdle_nbinom1": "zero_inflated_negative_binomial_1",
    "zero_inflated_gpd": "hurdle_gpd",
    "zero_inflated_egpd_power": "hurdle_egpd_power",
    "zero_inflated_egpd_power_mixture": "hurdle_egpd_power_mixture",
    "zero_inflated_egpd_beta": "hurdle_egpd_beta",
    "zero_inflated_egpd_power_beta": "hurdle_egpd_power_beta",
    "zero-inflated-regression-gamma": "hurdle_regression_gamma",
    "zero_inflated_regression_gamma": "hurdle_regression_gamma",
    "zero_inflated_regression_lognormal": "hurdle_regression_lognormal",
    "zero-inflated-regression-lognormal": "hurdle_regression_lognormal",
    "hurdle_regression_poisson": "zero_inflated_regression_poisson",
    "zero_inflated_regression_nbinom2":
        "zero_inflated_regression_negative_binomial",
    "zero_inflated_regression_negative_binomial_2":
        "zero_inflated_regression_negative_binomial",
    "zero_inflated_regression_nbinom":
        "zero_inflated_regression_negative_binomial",
    "hurdle_regression_negative_binomial":
        "zero_inflated_regression_negative_binomial",
    "hurdle_regression_nbinom2":
        "zero_inflated_regression_negative_binomial",
    "hurdle_regression_negative_binomial_2":
        "zero_inflated_regression_negative_binomial",
    "zero_inflated_regression_nbinom1":
        "zero_inflated_regression_negative_binomial_1",
    "hurdle_regression_negative_binomial_1":
        "zero_inflated_regression_negative_binomial_1",
    "hurdle_regression_nbinom1":
        "zero_inflated_regression_negative_binomial_1",
    "zero-censored-power-normal": "zero_censored_power_transformed_normal",
    "quantile": "asymmetric_laplace",
    "quantile_regression": "asymmetric_laplace",
}


def _parse_likelihood_options(name):
    """Strip trailing option tokens in the reference's parse order
    (likelihoods.h:244-252: kink clipping, variance correction, mode
    finding, approximation type). Returns (base_name, options dict)."""
    opts = {}
    if name.endswith("_kink_clipping"):                 # :10337
        opts["kink_clipping"] = True
        name = name[: -len("_kink_clipping")]
    for suffix, version in (("_var_cor_pred_freq_asym", "freq_asymptotic"),
                            ("_var_cor_pred_lr", "learning_rate")):  # :10319
        if name.endswith(suffix):
            opts["var_correction"] = version
            name = name[: -len(suffix)]
            break
    for suffix, mode in (("_fisher_mode_finding_continue", "fisher"),
                         ("_not_fisher_mode_finding", "not_fisher"),
                         ("_fisher_mode_finding", "fisher")):        # :10347
        if name.endswith(suffix):
            opts["mode_finding"] = mode
            name = name[: -len(suffix)]
            break
    for suffix, approx in (("_fisher_laplace_combined", "combined"),
                           ("_fisher-laplace", "fisher_laplace"),
                           ("_fisher_laplace", "fisher_laplace"),
                           ("_triangular_kernel_curvature", "tkc"),
                           ("_tkc", "tkc"),
                           ("_TKC", "tkc"),
                           ("_laplace", "laplace")):                 # :10374
        if name.endswith(suffix):
            # 'asymmetric_laplace' is itself a likelihood name, not the
            # '_laplace' approximation suffix (likelihoods.h:10411)
            if suffix == "_laplace" and name == "asymmetric_laplace":
                break
            opts["approx"] = approx
            name = name[: -len(suffix)]
            break
    return name, opts


def _validate_al_quantile(q):
    """ValidateAsymmetricLaplaceQuantile, likelihoods.h:730-741."""
    if q is None:
        raise ValueError(
            "No value was provided for 'likelihood_additional_param'. For "
            "likelihood='asymmetric_laplace' (aliases 'quantile' and "
            "'quantile_regression'), provide a quantile q with 0 < q < 1")
    q = float(q)
    if not math.isfinite(q):
        raise ValueError(
            "For likelihood='asymmetric_laplace', "
            "'likelihood_additional_param' must be a finite quantile q with "
            f"0 < q < 1. Found q = {q}")
    if q <= 0.0 or q >= 1.0:
        raise ValueError(
            "For likelihood='asymmetric_laplace', "
            "'likelihood_additional_param' must be a quantile q with "
            f"0 < q < 1. Found q = {q}")
    return q


def get_likelihood(name, additional_param=None):
    """The likelihood object for a name with its option suffixes (the
    reference's get_likelihood, likelihoods/base.py:847)."""
    name, opts = _parse_likelihood_options(name)
    name = _ALIASES.get(name, name)
    approx = opts.get("approx")
    if name == "t_fix_df":
        lik = TFixDf(df=additional_param if additional_param is not None
                     else 2.0)
    elif name == "tweedie_fixed_p":
        lik = TweedieFixedP(p=additional_param if additional_param is not None
                            else 1.5)
    elif name == "asymmetric_laplace":
        lik = AsymmetricLaplace(quantile=_validate_al_quantile(
            additional_param))
    elif name in _REGISTRY:
        lik = _REGISTRY[name]()
    else:
        raise ValueError(
            f"likelihood '{name}' is not (yet) supported. "
            f"Currently supported: {SUPPORTED_LIKELIHOODS}")
    if approx is not None:
        if approx in ("fisher_laplace", "combined") \
                and not hasattr(lik, "fisher_W"):
            raise ValueError(
                f"likelihood '{name}' has no (quasi-)Fisher information; "
                f"'_{approx}' is not supported for it")
        if approx == "tkc" and name != "asymmetric_laplace":
            raise ValueError(
                "'approximation_type' = 'triangular_kernel_curvature' is "
                f"only supported for likelihood = 'asymmetric_laplace', "
                f"not '{name}'")
        lik.approx_type = approx
    if "mode_finding" in opts:
        lik.mode_finding = opts["mode_finding"]
    if "var_correction" in opts:
        lik.var_correction = opts["var_correction"]
    if opts.get("kink_clipping"):
        lik.kink_clipping = True
    return lik
