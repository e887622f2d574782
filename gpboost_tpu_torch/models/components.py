"""Random-effect components (counterpart of gpboost_tpu/models/components.py).

A model's random part is a sum of components (re_comp.h:34 RECompBase):
grouped random effects (intercepts, or slopes with a covariate z) over a
categorical variable, and Gaussian processes (with a covariate z, a GP
random coefficient). Both keep their data on the
host as numpy; the engines move what they need to their device.
"""

import numpy as np

from ..ops.cov_fcts import CovarianceFunction
from ..ops.taper import _like


class GPComponent:
    """A Gaussian-process component (re_comp.h:789 RECompGP).

    coords: (n, d) locations, kept on the host as float64 numpy; the engines
    move what they need to the device. z: optional (n,) covariate of a GP
    random coefficient (a spatially varying coefficient): the component's
    covariance is then v * z_i z_l K(s_i, s_l).
    """

    kind = "gp"

    def __init__(self, coords, cov_fn: CovarianceFunction, z=None, name="GP"):
        self.coords = np.asarray(coords, dtype=np.float64)
        if self.coords.ndim == 1:
            self.coords = self.coords[:, None]
        self.cov_fn = cov_fn
        self.z = None if z is None else np.asarray(z, dtype=np.float64)
        self.name = name

    @property
    def num_cov_par(self):
        return self.cov_fn.num_cov_par

    @property
    def num_range_par(self):
        return self.cov_fn.num_range_par

    def corr(self, D_or_none, alphas):
        """Correlation matrix of the training data at transformed ranges
        alphas: from the distances D of an isotropic kernel, else from the
        coordinates, or an approximation adapter's own training block
        (`corr_train`, the full-scale Vecchia one)."""
        if hasattr(self.cov_fn, "corr_train"):
            return self.cov_fn.corr_train(alphas)
        if self.cov_fn.is_isotropic:
            return self.cov_fn.corr_from_dist(D_or_none, alphas)
        c = _like(self.coords, alphas)
        return self.cov_fn.corr_from_coords(c, c, alphas)

    def cross_corr(self, coords_pred, alphas):
        """(n, n_pred) correlations between training and new points of a
        non-isotropic kernel or an approximation adapter, from coordinates
        (components.py:56-84; an isotropic kernel's come from distances,
        models/gaussian_gp.py assemble_pred_covs)."""
        c = _like(self.coords, alphas)
        return self.cov_fn.corr_from_coords(
            c, _like(coords_pred, alphas), alphas)

    def pred_corr(self, coords_pred, alphas):
        """(n_pred, n_pred) correlations among the new points, as
        cross_corr."""
        cp = _like(coords_pred, alphas)
        return self.cov_fn.corr_from_coords(cp, cp, alphas)


class GroupedComponent:
    """Grouped random effect (re_comp.h:227 RECompGroup).

    group: (n,) categorical labels. z: optional (n,) random-slope covariate.
    Sigma_j[i, l] = v_j * 1{group_i == group_l} (* z_i z_l).
    """

    kind = "grouped"

    def __init__(self, group, z=None, name="Group_1"):
        codes, self.group_levels = _factorize(group)
        self.group_codes = codes.astype(np.int32)
        self.z = None if z is None else np.asarray(z, dtype=np.float64)
        self.name = name

    @property
    def num_cov_par(self):
        return 1

    @property
    def num_range_par(self):
        return 0

    @property
    def num_groups(self):
        return len(self.group_levels)

    def same_group_mask(self, codes_other=None):
        a = self.group_codes
        b = a if codes_other is None else codes_other
        return (a[:, None] == b[None, :]).astype(np.float64)

    def refine_by_cluster(self, cluster_ids):
        """Split levels by cluster id: the same group label in two clusters
        becomes two independent effects (re_model_template.h:6775
        SetUpClusterIds)."""
        ccodes, self._cluster_levels = _factorize(cluster_ids)
        self._base_levels = self.group_levels
        mult = len(self.group_levels)
        combo = ccodes.astype(np.int64) * mult + self.group_codes
        new_codes, combo_levels = _factorize(combo)
        self.group_codes = new_codes.astype(np.int32)
        self.group_levels = combo_levels
        self._refined_mult = mult

    def codes_for_prediction(self, group_values_pred, cluster_ids_pred=None):
        """Map prediction labels to training level codes: values below
        num_groups are training levels, values from num_groups up are fresh
        codes shared among equal new labels (new groups are correlated with
        each other, independent of the training data; re_comp.h:494
        AddPredCovMatrices)."""
        vals = np.asarray(group_values_pred)
        if hasattr(self, "_refined_mult"):
            if cluster_ids_pred is None:
                raise ValueError("cluster_ids_pred not provided")
            gcodes, gseen = _match_levels(self._base_levels, vals)
            ccodes, cseen = _match_levels(self._cluster_levels,
                                          np.asarray(cluster_ids_pred))
            combo = ccodes.astype(np.int64) * self._refined_mult + gcodes
            codes, seen = _match_levels(self.group_levels, combo)
            seen = seen & gseen & cseen
            key = combo + (~cseen) * 10**9  # unseen clusters: distinct keys
        else:
            codes, seen = _match_levels(self.group_levels, vals)
            key = vals
        un = ~seen
        out = codes.astype(np.int64)
        if np.any(un):
            _, fresh = np.unique(np.asarray(key)[un], return_inverse=True)
            out[un] = self.num_groups + fresh
        return out


def _factorize(values):
    """(codes, sorted unique levels)."""
    values = np.asarray(values)
    uniques, codes = np.unique(values, return_inverse=True)
    return codes, uniques


def _match_levels(levels, values):
    """Map values onto the sorted unique `levels`: (codes, seen). Unseen
    values get an arbitrary in-range code and seen=False."""
    values = np.asarray(values)
    sorter = np.argsort(levels)
    pos = np.searchsorted(levels, values, sorter=sorter)
    pos = np.clip(pos, 0, len(levels) - 1)
    codes = sorter[pos]
    seen = levels[codes] == values
    return codes.astype(np.int64), seen
