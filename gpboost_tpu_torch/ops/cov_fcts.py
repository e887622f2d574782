"""Covariance functions on GPBoost's transformed parameterization
(counterpart of gpboost_tpu/ops/cov_fcts.py; the reference's
include/GPBoost/cov_fcts.h).

Each GP component has [variance, range(s)] on the original scale; the
optimizer works on a transformed scale (cov_fcts.h:500-560):

    matern               alpha = sqrt(2 shape) / rho  (1, sqrt(3), sqrt(5)
                         for shape 0.5, 1.5, 2.5)
    gaussian             alpha = 1 / rho^2
    powered_exponential  alpha = 1 / rho^shape
    matern_space_time, matern_ard  alpha_i = sqrt(2 shape) / rho_i
    gaussian_ard         alpha_i = 1 / rho_i^2
    hurst(_ard)          -log(H), the ranges unchanged
    wendland, linear, matern_estimate_shape, matern_ard_estimate_shape,
    space_time_gneiting  unchanged (the original scale)

Correlations with rd = alpha * dist (cov_fcts.h:2103-2163): matern's closed
forms for shape 0.5 / 1.5 / 2.5 (exponential is matern 0.5), the Bessel-K
form of ops/special_fns.py for any other or an estimated shape,
exp(-alpha d^2) and exp(-alpha d^shape). The isotropic kernels take
distances; the anisotropic ones (ARD, space-time: the first coordinate is
time) fold the ranges into the coordinates, subtracting before scaling so
that identical points give exactly zero; space_time_gneiting, hurst(_ard)
and linear are evaluated from coordinate pairs, and hurst and linear have
no constant diagonal. "wendland" is also the compact-support taper of the
tapering approximations (taper_range, taper_shape 0, 1 or 2, smoothness
taper_mu). AR1MultifidelityCovariance is the two-level multifidelity
kernel of the "ar1_mf_<base>" types. Gradients come from torch.autograd.
"""

import math

import numpy as np
import torch

from .distances import pairwise_dist, pairwise_dist_sq
from .special_fns import matern_correlation_general

SUPPORTED_COV_FUNCTIONS = (
    "exponential",
    "matern",
    "gaussian",
    "powered_exponential",
    "matern_ard",
    "gaussian_ard",
    "matern_space_time",
    "wendland",
    "matern_estimate_shape",
    "matern_ard_estimate_shape",
    "space_time_gneiting",
    "hurst",
    "hurst_ard",
    "linear",
)
_ISOTROPIC = ("exponential", "matern", "gaussian", "powered_exponential",
              "wendland", "matern_estimate_shape")
_COORD_PAIRS = ("space_time_gneiting", "hurst", "hurst_ard", "linear")
_ORIGINAL_SCALE = ("wendland", "linear", "matern_estimate_shape",
                   "matern_ard_estimate_shape", "space_time_gneiting")


def _closed_shape(shape):
    """The closed-form Matern shape (0.5, 1.5, 2.5) shape is, else None."""
    for s in (0.5, 1.5, 2.5):
        if abs(shape - s) < 1e-10:
            return s
    return None


def _matern_base(scaled_dist, shape):
    """Matern correlation at a scaled distance: the closed forms for shape
    0.5 / 1.5 / 2.5 (cov_fcts.h:2100-2118), Bessel K otherwise
    (cov_fcts.h:2120-2134)."""
    rd = scaled_dist
    s = None if torch.is_tensor(shape) else _closed_shape(shape)
    if s == 0.5:
        return torch.exp(-rd)
    if s == 1.5:
        return (1.0 + rd) * torch.exp(-rd)
    if s == 2.5:
        return (1.0 + rd + rd * rd / 3.0) * torch.exp(-rd)
    return matern_correlation_general(rd, shape)


def _safe_sqrt(s):
    """sqrt with zero gradient (instead of NaN) at exactly-zero entries."""
    zero = s == 0.0
    return torch.where(zero, torch.zeros_like(s),
                       torch.sqrt(torch.where(zero, torch.ones_like(s), s)))


def pointwise_corr(cov_fn, xa, xb, alphas):
    """A kernel's correlation between broadcast coordinate arrays [..., d]:
    from the distance for an isotropic kernel, directly for a
    coordinate-pair one, at the range-scaled distance (subtracting before
    scaling) for an anisotropic one."""
    if cov_fn.is_isotropic:
        return cov_fn.corr_from_dist(_safe_sqrt(((xa - xb) ** 2).sum(-1)),
                                     alphas)
    if cov_fn.needs_coords:
        return cov_fn.corr_pointwise(xa, xb, alphas)
    scale = cov_fn.aniso_scale(alphas, xa.shape[-1])
    return cov_fn.base_corr_scaled_dist(
        _safe_sqrt((((xa - xb) * scale) ** 2).sum(-1)), alphas)


class CovarianceFunction:
    """One GP correlation function (the variance excluded)."""

    def __init__(self, cov_fct_type, shape=None, dim=None, taper_range=1.0,
                 taper_shape=1.0, taper_mu=2.0):
        if cov_fct_type not in SUPPORTED_COV_FUNCTIONS:
            raise ValueError(
                f"cov_function '{cov_fct_type}' is not supported. "
                f"Supported: {SUPPORTED_COV_FUNCTIONS}")
        if shape is None:
            # the reference's defaults (matern 1.5, powered_exponential 1)
            shape = {"matern": 1.5, "matern_ard": 1.5,
                     "matern_space_time": 1.5, "powered_exponential": 1.0,
                     "wendland": 1.0, "space_time_gneiting": 0.0}.get(
                         cov_fct_type)
        if cov_fct_type == "matern" and shape <= 0:
            raise ValueError("matern shape must be > 0")
        if cov_fct_type == "powered_exponential" and not 0 < shape <= 2:
            raise ValueError("powered_exponential shape must be in (0, 2]")
        self.cov_fct_type = cov_fct_type
        self.shape = None if shape is None else float(shape)
        self.dim = dim
        self.taper_range = taper_range
        self.taper_shape = taper_shape
        self.taper_mu = taper_mu

    @property
    def is_isotropic(self):
        return self.cov_fct_type in _ISOTROPIC

    @property
    def needs_coords(self):
        """Kernels not of the form base(scaled distance), evaluated from
        coordinate pairs (cov_fcts.h cov_calculated_based_on_coords_)."""
        return self.cov_fct_type in _COORD_PAIRS

    @property
    def num_range_par(self):
        t = self.cov_fct_type
        if t in ("wendland", "linear"):
            return 0
        if t in ("exponential", "matern", "gaussian", "powered_exponential",
                 "hurst"):
            return 1            # hurst: the Hurst exponent (cov_fcts.h:165)
        if t in ("matern_estimate_shape", "matern_space_time"):
            # range and smoothness (cov_fcts.h:150); time and space ranges
            return 2
        if t == "space_time_gneiting":
            return 6            # a, c, alpha, nu, beta, delta (cov_fcts.h:162)
        if self.dim is None:
            raise ValueError("ARD covariance functions need dim")
        if t == "matern_ard_estimate_shape":
            return self.dim + 1
        return self.dim         # hurst_ard: H and dim - 1 ranges

    @property
    def num_cov_par(self):
        """variance + ranges (cov_fcts.h num_cov_par_)."""
        return 1 + self.num_range_par

    def _matern_mult_const(self):
        s = _closed_shape(self.shape)
        if s == 0.5:
            return 1.0
        if s == 1.5:
            return math.sqrt(3.0)
        if s == 2.5:
            return math.sqrt(5.0)
        return math.sqrt(2.0 * self.shape)

    # ------------------------------------------------------------------
    # parameter transforms (original range rho <-> transformed alpha)
    def range_to_transformed(self, ranges, var=None):
        r = np.asarray(ranges, dtype=np.float64)
        t = self.cov_fct_type
        if t == "exponential":
            return 1.0 / r
        if t in ("matern", "matern_ard", "matern_space_time"):
            return self._matern_mult_const() / r
        if t in ("gaussian", "gaussian_ard"):
            return 1.0 / (r * r)
        if t == "powered_exponential":
            return 1.0 / np.power(r, self.shape)
        if t in _ORIGINAL_SCALE:
            return r
        out = r.copy()              # hurst(_ard): H -> -log(H)
        out[..., 0] = -np.log(r[..., 0])
        return out

    def range_from_transformed(self, alphas, var=None):
        a = np.asarray(alphas, dtype=np.float64)
        t = self.cov_fct_type
        if t == "exponential":
            return 1.0 / a
        if t in ("matern", "matern_ard", "matern_space_time"):
            return self._matern_mult_const() / a
        if t in ("gaussian", "gaussian_ard"):
            return 1.0 / np.sqrt(a)
        if t == "powered_exponential":
            return np.power(a, -1.0 / self.shape)
        if t in _ORIGINAL_SCALE:
            return a
        out = a.copy()
        out[..., 0] = np.exp(-a[..., 0])
        return out

    def range_to_transformed_torch(self, rho, var=None):
        """Differentiable rho -> alpha transform."""
        t = self.cov_fct_type
        if t == "exponential":
            return 1.0 / rho
        if t in ("matern", "matern_ard", "matern_space_time"):
            return self._matern_mult_const() / rho
        if t in ("gaussian", "gaussian_ard"):
            return 1.0 / (rho * rho)
        if t == "powered_exponential":
            return torch.pow(rho, -self.shape)
        if t in _ORIGINAL_SCALE:
            return rho
        return torch.cat([-torch.log(rho[..., :1]), rho[..., 1:]], dim=-1)

    # ------------------------------------------------------------------
    # correlations
    def corr_from_dist(self, D, alpha):
        """Correlation from distances D (isotropic kernels) at the
        transformed parameters alpha (for matern_estimate_shape the
        original-scale [range, shape])."""
        t = self.cov_fct_type
        if t == "wendland":
            return self._wendland_taper(D)
        if t == "matern_estimate_shape":
            # rd = d sqrt(2 s) / range (cov_fcts.h:2136-2152)
            rng, shp = alpha[0], alpha[1]
            return matern_correlation_general(
                D * torch.sqrt(2.0 * shp) / rng, shp)
        if alpha.ndim > 0:
            alpha = alpha[0]
        if t == "exponential":
            return torch.exp(-alpha * D)
        if t == "matern":
            return _matern_base(alpha * D, self.shape)
        if t == "gaussian":
            return torch.exp(-alpha * D * D)
        if t == "powered_exponential":
            return torch.exp(-alpha * torch.pow(D, self.shape))
        raise AssertionError(t)

    def _wendland_taper(self, D):
        """Compact-support Wendland correlation (cov_fcts.h:1957-1986)."""
        x = D / self.taper_range
        one_minus = torch.clamp_min(1.0 - x, 0.0)
        mu = self.taper_mu
        if abs(self.taper_shape - 0.0) < 1e-10:
            val = torch.pow(one_minus, mu)
        elif abs(self.taper_shape - 1.0) < 1e-10:
            val = torch.pow(one_minus, mu + 1.0) * (1.0 + x * (mu + 1.0))
        elif abs(self.taper_shape - 2.0) < 1e-10:
            val = torch.pow(one_minus, mu + 2.0) * (
                1.0 + x * (mu + 2.0) + x * x * (mu * mu + 4.0 * mu + 3.0)
                / 3.0)
        else:
            raise NotImplementedError(
                f"wendland taper_shape {self.taper_shape}")
        return torch.where(x < 1.0, val, torch.zeros_like(val))

    def aniso_scale(self, alphas, dim):
        """Per-coordinate scale s with corr = base_corr_scaled_dist(
        ||s (x1 - x2)||) (re_comp.h:1128-1158)."""
        t = self.cov_fct_type
        if t == "matern_space_time":
            return torch.cat([alphas[:1], alphas[1:2].expand(dim - 1)])
        if t == "matern_ard":
            return alphas
        if t == "gaussian_ard":
            return torch.sqrt(alphas)
        if t == "matern_ard_estimate_shape":
            return 1.0 / alphas[:dim]       # cov_fcts.h:298-301
        raise AssertionError(t)

    def base_corr_scaled_dist(self, d, alphas=None):
        """Correlation at a coordinate-scaled distance (anisotropic kernels:
        the ranges are folded into the coordinates)."""
        t = self.cov_fct_type
        if t in ("matern_ard", "matern_space_time"):
            return _matern_base(d, self.shape)
        if t == "gaussian_ard":
            return torch.exp(-d * d)
        if t == "matern_ard_estimate_shape":
            shp = alphas[-1]
            return matern_correlation_general(torch.sqrt(2.0 * shp) * d, shp)
        raise AssertionError(t)

    def corr_pointwise(self, xa, xb, alphas):
        """The coordinate-pair kernels (divided by the variance) between
        broadcastable coordinate arrays [..., d]."""
        t = self.cov_fct_type
        if t == "space_time_gneiting":
            # [a, c, alpha, nu, beta, delta], Gneiting (2002) Eq. (16)
            # (cov_fcts.h:2849-2879); alpha and beta capped at 1
            # (cov_fcts.h:468-479)
            a, c, al, nu, beta, delta = (alphas[i] for i in range(6))
            al = torch.clamp_max(al, 1.0)
            beta = torch.clamp_max(beta, 1.0)
            dim_space = xa.shape[-1] - 1
            dist_time = torch.abs(xa[..., 0] - xb[..., 0])
            dist_space = _safe_sqrt(
                ((xa[..., 1:] - xb[..., 1:]) ** 2).sum(-1))
            pos = dist_time > 0.0
            d_aux_time = a * torch.pow(
                torch.where(pos, dist_time, torch.ones_like(dist_time)),
                2.0 * al)
            d_aux_time = torch.where(pos, d_aux_time,
                                     torch.zeros_like(d_aux_time)) + 1.0
            d_aux = c * dist_space / torch.pow(d_aux_time, beta / 2.0)
            d_aux2 = 1.0 / torch.pow(d_aux_time,
                                     delta + beta * dim_space / 2.0)
            return d_aux2 * matern_correlation_general(d_aux, nu)
        if t in ("hurst", "hurst_ard"):
            # fractional Brownian field (cov_fcts.h:3047-3055),
            # H = exp(-alphas[0]); hurst_ard scales the coordinates after
            # the first by 1 / range (cov_fcts.h:304-309)
            H = torch.exp(-alphas[0])
            if t == "hurst_ard":
                scale = torch.cat([torch.ones_like(alphas[:1]),
                                   1.0 / alphas[1:]])
                xa = xa * scale
                xb = xb * scale

            def pow_h(s):
                pos = s > 0.0
                return torch.where(pos, torch.pow(
                    torch.where(pos, s, torch.ones_like(s)), H),
                    torch.zeros_like(s))
            return 0.5 * (pow_h((xa ** 2).sum(-1)) + pow_h((xb ** 2).sum(-1))
                          - pow_h(((xa - xb) ** 2).sum(-1)))
        if t == "linear":
            return (xa * xb).sum(-1)
        raise AssertionError(t)

    def corr_from_coords(self, x1, x2, alphas):
        """Correlation matrix (n1, n2) from coordinates (for
        matern_space_time the first column is time)."""
        t = self.cov_fct_type
        if self.needs_coords:
            return self.corr_pointwise(x1[:, None, :], x2[None, :, :], alphas)
        if t in ("matern_ard", "matern_space_time",
                 "matern_ard_estimate_shape"):
            scale = self.aniso_scale(alphas, x1.shape[1])
            diff = (x1[:, None, :] - x2[None, :, :]) * scale
            return self.base_corr_scaled_dist(
                _safe_sqrt(torch.sum(diff * diff, dim=-1)), alphas)
        if t == "gaussian_ard":
            sq = torch.sqrt(alphas)
            return torch.exp(-pairwise_dist_sq(x1 * sq, x2 * sq,
                                               method="direct"))
        return self.corr_from_dist(pairwise_dist(x1, x2), alphas)


class AR1MultifidelityCovariance:
    """Two-level AR1 multifidelity covariance (cov_fcts.h:1690
    InitializeAR1Multifidelity, :1798 CalculateCovMatAR1Multifidelity):

        K(x, x') = L(f) L(f') K_low(s, s') + f f' K_disc(s, s'),
        L(f) = 1 + f (rho - 1),

    s the spatial coordinates, f in {0, 1} the fidelity in the last
    coordinate column, rho the AR1 coefficient. User parameters after the
    error variance: [var_low, ranges_low..., var_disc, ranges_disc..., rho];
    the engine's variance slot carries var_low, and internally var_disc is
    the ratio var_disc / var_low and rho is exp(rho)."""

    is_isotropic = False
    needs_coords = True

    def __init__(self, base_type, shape=None, dim=None):
        if dim is None or dim < 2:
            raise ValueError(
                "AR1 multifidelity covariance functions require at least one "
                "input coordinate and a fidelity indicator in the last column")
        if base_type == "wendland" or base_type.startswith("ar1_mf_"):
            raise ValueError(f"invalid base covariance '{base_type}' for AR1 "
                             "multifidelity models")
        self.cov_fct_type = "ar1_mf_" + base_type
        self.base_type = base_type
        self.dim = dim
        self.spatial_dim = dim - 1
        self.base_low = CovarianceFunction(base_type, shape=shape,
                                           dim=self.spatial_dim)
        self.base_disc = CovarianceFunction(base_type, shape=shape,
                                            dim=self.spatial_dim)
        self.shape = self.base_low.shape
        self.ncb = self.base_low.num_cov_par      # var + base ranges

    @property
    def num_range_par(self):
        # [ranges_low..., var_disc, ranges_disc..., rho]
        return 2 * self.ncb

    @property
    def num_cov_par(self):
        return 1 + self.num_range_par

    def _split(self, rest):
        nb = self.ncb - 1
        return (rest[..., :nb], rest[..., nb], rest[..., nb + 1: 2 * nb + 1],
                rest[..., -1])

    def range_to_transformed(self, rest, var=None):
        rl, vd, rd, rho = self._split(np.asarray(rest, dtype=np.float64))
        out = []
        if self.ncb > 1:
            out.append(np.atleast_1d(self.base_low.range_to_transformed(rl)))
        out.append(np.atleast_1d(vd / (var if var is not None else 1.0)))
        if self.ncb > 1:
            out.append(np.atleast_1d(self.base_disc.range_to_transformed(rd)))
        out.append(np.atleast_1d(np.exp(rho)))
        return np.concatenate(out)

    def range_from_transformed(self, a, var=None):
        rl, ratio, rd, erho = self._split(np.asarray(a, dtype=np.float64))
        out = []
        if self.ncb > 1:
            out.append(np.atleast_1d(self.base_low.range_from_transformed(
                rl)))
        out.append(np.atleast_1d(ratio * (var if var is not None else 1.0)))
        if self.ncb > 1:
            out.append(np.atleast_1d(self.base_disc.range_from_transformed(
                rd)))
        out.append(np.atleast_1d(np.log(erho)))
        return np.concatenate(out)

    def range_to_transformed_torch(self, rest, var=None):
        rl, vd, rd, rho = self._split(rest)
        parts = []
        if self.ncb > 1:
            parts.append(torch.atleast_1d(
                self.base_low.range_to_transformed_torch(rl)))
        parts.append(torch.atleast_1d(vd / (var if var is not None else 1.0)))
        if self.ncb > 1:
            parts.append(torch.atleast_1d(
                self.base_disc.range_to_transformed_torch(rd)))
        parts.append(torch.atleast_1d(torch.exp(rho)))
        return torch.cat(parts)

    def corr_pointwise(self, xa, xb, alphas):
        a_low, ratio, a_disc, erho = self._split(alphas)
        rho = torch.log(erho)
        sa, fa = xa[..., :-1], xa[..., -1]
        sb, fb = xb[..., :-1], xb[..., -1]
        La = 1.0 + fa * (rho - 1.0)
        Lb = 1.0 + fb * (rho - 1.0)
        return (La * Lb * pointwise_corr(self.base_low, sa, sb, a_low)
                + ratio * fa * fb * pointwise_corr(self.base_disc, sa, sb,
                                                   a_disc))

    def corr_from_coords(self, x1, x2, alphas):
        return self.corr_pointwise(x1[:, None, :], x2[None, :, :], alphas)
