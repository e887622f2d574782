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
"""

import math

import numpy as np
import torch

SUPPORTED_COV_FUNCTIONS = ("exponential", "matern")


def _safe_sqrt(s):
    """sqrt with zero gradient (instead of NaN) at exactly-zero entries."""
    zero = s == 0.0
    return torch.where(zero, torch.zeros_like(s),
                       torch.sqrt(torch.where(zero, torch.ones_like(s), s)))


class CovarianceFunction:
    """One isotropic GP correlation function (variance excluded)."""

    def __init__(self, cov_fct_type, shape=None, dim=None):
        if cov_fct_type not in SUPPORTED_COV_FUNCTIONS:
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
