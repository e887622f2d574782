"""Random-effect components (counterpart of gpboost_tpu/models/components.py).

Only the Gaussian-process component is ported; grouped random effects and
random coefficients come with later engines.
"""

import numpy as np

from ..ops.cov_fcts import CovarianceFunction


class GPComponent:
    """A Gaussian-process component (re_comp.h:789 RECompGP).

    coords: (n, d) locations, kept on the host as float64 numpy; the engines
    move what they need to the device.
    """

    kind = "gp"

    def __init__(self, coords, cov_fn: CovarianceFunction, z=None, name="GP"):
        if z is not None:
            raise NotImplementedError(
                "GP random coefficients are not ported yet")
        self.coords = np.asarray(coords, dtype=np.float64)
        if self.coords.ndim == 1:
            self.coords = self.coords[:, None]
        self.cov_fn = cov_fn
        self.z = None
        self.name = name

    @property
    def num_cov_par(self):
        return self.cov_fn.num_cov_par

    @property
    def num_range_par(self):
        return self.cov_fn.num_range_par
