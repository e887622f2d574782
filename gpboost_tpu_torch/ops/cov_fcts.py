"""Covariance functions on GPBoost's transformed parameterization
(counterpart of gpboost_tpu/ops/cov_fcts.py).

Only the closed forms are ported: exponential, and matern with shape 0.5,
1.5 or 2.5. With rd = alpha * dist:

    matern 0.5 / exponential : exp(-rd)
    matern 1.5               : (1 + rd) exp(-rd)
    matern 2.5               : (1 + rd + rd^2/3) exp(-rd)

alpha = c / rho with c = 1, sqrt(3), sqrt(5) for the three shapes. Any other
kernel (or a general matern shape, which needs the Bessel-K path) raises
NotImplementedError. Gradients come from torch.autograd.

"wendland" is only the compact-support taper of the tapering
approximations (`_wendland_taper`, cov_fcts.h:1957-1986), with
taper_range, taper_shape 0, 1 or 2 and the smoothness
taper_mu = (1 + dim)/2 + taper_shape + 0.5 (re_comp.h:1812 GetTaperMu).
"""

import math

import numpy as np
import torch

SUPPORTED_COV_FUNCTIONS = ("exponential", "matern")
_TAPER = "wendland"


def _safe_sqrt(s):
    """sqrt with zero gradient (instead of NaN) at exactly-zero entries."""
    zero = s == 0.0
    return torch.where(zero, torch.zeros_like(s),
                       torch.sqrt(torch.where(zero, torch.ones_like(s), s)))


class CovarianceFunction:
    """One isotropic GP correlation function (variance excluded)."""

    def __init__(self, cov_fct_type, shape=None, dim=None, taper_range=1.0,
                 taper_shape=1.0, taper_mu=2.0):
        if cov_fct_type not in SUPPORTED_COV_FUNCTIONS + (_TAPER,):
            raise NotImplementedError(
                f"cov_function '{cov_fct_type}' is not ported yet "
                f"(supported: {SUPPORTED_COV_FUNCTIONS})")
        if cov_fct_type == "matern":
            shape = 1.5 if shape is None else float(shape)
            if not any(abs(shape - s) < 1e-10 for s in (0.5, 1.5, 2.5)):
                raise NotImplementedError(
                    "matern shapes other than 0.5, 1.5 and 2.5 need the "
                    "Bessel-K path, which is not ported yet")
        self.cov_fct_type = cov_fct_type
        self.shape = shape
        self.dim = dim
        self.taper_range = taper_range
        self.taper_shape = taper_shape
        self.taper_mu = taper_mu

    is_isotropic = True
    num_range_par = 1

    @property
    def num_cov_par(self):
        """variance + range."""
        return 1 + self.num_range_par

    def _mult_const(self):
        if self.cov_fct_type == "exponential" or abs(self.shape - 0.5) < 1e-10:
            return 1.0
        if abs(self.shape - 1.5) < 1e-10:
            return math.sqrt(3.0)
        return math.sqrt(5.0)

    # parameter transforms (original range rho <-> transformed alpha)
    def range_to_transformed(self, ranges, var=None):
        return self._mult_const() / np.asarray(ranges, dtype=np.float64)

    def range_from_transformed(self, alphas, var=None):
        return self._mult_const() / np.asarray(alphas, dtype=np.float64)

    def range_to_transformed_torch(self, rho, var=None):
        """Differentiable rho -> alpha transform."""
        return self._mult_const() / rho

    def corr_from_dist(self, D, alpha):
        """Correlation from distances D at transformed range alpha."""
        if alpha.ndim > 0:
            alpha = alpha[0]
        rd = alpha * D
        if self.cov_fct_type == "exponential" or abs(self.shape - 0.5) < 1e-10:
            return torch.exp(-rd)
        if abs(self.shape - 1.5) < 1e-10:
            return (1.0 + rd) * torch.exp(-rd)
        return (1.0 + rd + rd * rd / 3.0) * torch.exp(-rd)

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
