"""GPModel — the Gaussian-process façade of the PyTorch port
(counterpart of gpboost_tpu/gp_model.py).

Ported: the Gaussian likelihood with gp_approx='vecchia' and one isotropic
GP (exponential, or matern with shape 0.5 / 1.5 / 2.5), estimation by
L-BFGS-B on the nugget-profiled NLL, prediction with the default
'order_obs_first_cond_obs_only' ordering, and the model dict of the
reference (`model_to_dict`), so a model moves between the two packages.
Every other engine, likelihood and option raises NotImplementedError.

device: where the engine's tensors live (default: the first CUDA card; it
raises without one, and the CPU runs only when device="cpu" is passed). dtype: the engine's float type, "float64"
(default, as the reference) or "float32".
"""

import numpy as np
import torch

from .models.components import GPComponent
from .models.optimize import OptimConfig, OptimResult, optimize_gaussian
from .models.vecchia import VecchiaGaussianEngine
from .ops.cov_fcts import CovarianceFunction
from .ops.distances import pairwise_dist
from .utils.device import resolve_device, resolve_dtype

_OPTIM_PARAM_KEYS = set(OptimConfig.__dataclass_fields__)


class GPModel:
    """Gaussian process model y = F + b + xi with a Vecchia-approximated GP
    b (basic.py:4172 GPModel, Gaussian Vecchia branch)."""

    def __init__(self,
                 likelihood="gaussian",
                 group_data=None,
                 gp_coords=None,
                 gp_rand_coef_data=None,
                 cov_function="matern",
                 cov_fct_shape=1.5,
                 gp_approx="none",
                 num_neighbors=None,
                 vecchia_ordering="random",
                 matrix_inversion_method="auto",
                 seed=0,
                 cluster_ids=None,
                 weights=None,
                 num_parallel_devices=None,
                 model_file=None,
                 model_dict=None,
                 dtype="float64",
                 device=None):
        self.device = resolve_device(device)
        if model_file is not None or model_dict is not None:
            self._init_from_dict(model_file, model_dict)
            return
        if likelihood not in ("gaussian", "regression"):
            raise NotImplementedError(
                f"likelihood '{likelihood}' is not ported yet (gaussian only)")
        if gp_approx != "vecchia":
            raise NotImplementedError(
                f"gp_approx '{gp_approx}' is not ported yet (vecchia only)")
        unsupported = [nm for nm, v in (
            ("group_data", group_data), ("gp_rand_coef_data", gp_rand_coef_data),
            ("cluster_ids", cluster_ids), ("weights", weights),
            ("num_parallel_devices", num_parallel_devices)) if v is not None]
        if unsupported:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(unsupported))
        if gp_coords is None:
            raise ValueError("gp_coords is required")
        self._dtype = resolve_dtype(dtype)
        self.likelihood = "gaussian"
        self.gp_approx = gp_approx
        self.cov_function_name = cov_function
        self.cov_fct_shape = cov_fct_shape
        self.matrix_inversion_method = matrix_inversion_method
        self.seed = seed
        self.num_neighbors = num_neighbors
        self.vecchia_ordering = vecchia_ordering
        self.vecchia_pred_type = "order_obs_first_cond_obs_only"
        self.num_neighbors_pred = None
        gp_coords = np.asarray(gp_coords, dtype=np.float64)
        if gp_coords.ndim == 1:
            gp_coords = gp_coords[:, None]
        self.gp_coords = gp_coords
        cov_fn = CovarianceFunction(cov_function, shape=cov_fct_shape,
                                    dim=gp_coords.shape[1])
        self.components = [GPComponent(gp_coords, cov_fn, name="GP")]
        self._par_names = ["Error_term", "GP_var", "GP_range"]
        self.num_data = len(gp_coords)
        self._engine = VecchiaGaussianEngine(
            self.components, self.num_data,
            num_neighbors=num_neighbors if num_neighbors else 20,
            vecchia_ordering=vecchia_ordering, seed=seed, dtype=self._dtype,
            device=self.device)
        self.num_cov_par = self._engine.num_cov_par
        self.params = OptimConfig()
        self._cov_pars_override = None
        self._fit_result = None
        self.y = None
        self.model_has_been_fitted = False

    # ------------------------------------------------------------------
    def set_optim_params(self, params):
        for k, v in (params or {}).items():
            if k not in _OPTIM_PARAM_KEYS:
                raise ValueError(f"Unknown or unported parameter '{k}'")
            if k == "init_cov_pars":
                v = None if v is None else np.asarray(v, dtype=np.float64)
                self._cov_pars_override = v
            setattr(self.params, k, v)
        return self

    def _default_init_cov_pars(self, y):
        """Data-driven initial values (re_model_template.h:4814
        FindInitCovPar): half the response variance each to the nugget and
        the GP, and the median-distance range rule."""
        var = float(np.var(np.asarray(y, dtype=np.float64), ddof=1))
        return np.asarray([var / 2.0, var / 2.0]
                          + _init_ranges(self.components[0]))

    def reset_fit(self):
        """Discard the fitted state so the next `fit` starts fresh."""
        self._fit_result = None
        self.y = None
        self.model_has_been_fitted = False
        return self

    def fit(self, y, X=None, params=None):
        """Estimate the covariance parameters for response y (numpy array or
        tensor, data order)."""
        if X is not None:
            raise NotImplementedError("linear covariates are not ported yet")
        self.set_optim_params(params)
        y_t = torch.as_tensor(y, device=self.device).to(torch.float64)
        self.y = y_t.cpu().numpy()
        cfg = self.params
        if cfg.init_cov_pars is None:
            cfg = OptimConfig(**{**cfg.__dict__, "init_cov_pars":
                                 self._default_init_cov_pars(self.y)})
        self._fit_result = optimize_gaussian(self._engine,
                                             self._engine.prep_y(y_t), cfg)
        self._cov_pars_override = None
        self.model_has_been_fitted = True
        return self

    def neg_log_likelihood(self, cov_pars, y):
        return self._engine.neg_log_likelihood(self._check_cov_pars(cov_pars),
                                               y)

    def _check_cov_pars(self, cov_pars):
        cov_pars = np.asarray(cov_pars, dtype=np.float64)
        if cov_pars.shape[-1] != self.num_cov_par:
            raise ValueError(
                f"cov_pars has {cov_pars.shape[-1]} entries but the model has "
                f"{self.num_cov_par} covariance parameters "
                f"({', '.join(self._par_names)})")
        return cov_pars

    def _require_fit(self):
        if self._fit_result is None:
            raise RuntimeError("Model has not been fitted")
        return self._fit_result

    def get_cov_pars(self):
        return self._require_fit().cov_pars.copy()

    def get_current_neg_log_likelihood(self):
        return self._require_fit().neg_log_likelihood

    # ------------------------------------------------------------------
    def predict(self, y=None, gp_coords_pred=None, predict_var=False,
                predict_cov_mat=False, cov_pars=None, predict_response=True):
        """Posterior predictions at gp_coords_pred (basic.py:6187
        GPModel.predict): {'mu', 'var', 'cov'} as float64 numpy."""
        if cov_pars is None:
            cov_pars = self._cov_pars_override \
                if self._cov_pars_override is not None \
                else self._require_fit().cov_pars
        cov_pars = self._check_cov_pars(cov_pars)
        if y is None:
            if self.y is None:
                raise ValueError("y not provided and model not fitted with y")
            y = self.y
        if gp_coords_pred is None:
            raise ValueError("gp_coords_pred not provided")
        pred_data = {"comps": [{"coords_pred": gp_coords_pred}]}
        out = self._engine.predict(
            cov_pars, y, pred_data, predict_var=predict_var,
            predict_cov_mat=predict_cov_mat,
            predict_response=predict_response,
            vecchia_pred_type=self.vecchia_pred_type,
            num_neighbors_pred=self.num_neighbors_pred)
        for k in ("cov", "var"):
            out.setdefault(k, None)
        return out

    # ------------------------------------------------------------------
    def model_to_dict(self, include_response_data=True):
        """The reference's state dict (gp_model.py:1166 model_to_dict) for
        the Gaussian Vecchia model."""
        r = self._require_fit()
        d = {
            "likelihood": self.likelihood,
            "cov_function": self.cov_function_name,
            "cov_fct_shape": self.cov_fct_shape,
            "gp_approx": self.gp_approx,
            "cov_pars": np.asarray(r.cov_pars).tolist(),
            "num_optim_iter": r.num_it,
            "neg_log_likelihood": r.neg_log_likelihood,
            "model_has_been_fitted": self.model_has_been_fitted,
            "matrix_inversion_method": self.matrix_inversion_method,
            "seed": self.seed,
            "vecchia_ordering": self.vecchia_ordering,
            "vecchia_pred_type": self.vecchia_pred_type,
            "gp_coords": self.gp_coords.tolist(),
        }
        if self.num_neighbors is not None:
            d["num_neighbors"] = self.num_neighbors
        if self.num_neighbors_pred is not None:
            d["num_neighbors_pred"] = self.num_neighbors_pred
        if include_response_data and self.y is not None:
            d["y"] = np.asarray(self.y).tolist()
        return d

    def _init_from_dict(self, model_file, model_dict):
        import json
        if model_dict is None:
            with open(model_file) as f:
                model_dict = json.load(f)
        d = model_dict
        unsupported = [k for k in ("group_data", "gp_rand_coef_data",
                                   "cluster_ids", "weights", "X", "coefs",
                                   "aux_pars") if d.get(k) is not None]
        if unsupported:
            raise NotImplementedError(
                "model dict holds parts that are not ported yet: "
                + ", ".join(unsupported))
        kw = dict(likelihood=d["likelihood"],
                  gp_coords=np.asarray(d["gp_coords"]),
                  cov_function=d["cov_function"],
                  cov_fct_shape=d["cov_fct_shape"],
                  gp_approx=d.get("gp_approx", "none"),
                  matrix_inversion_method=d.get("matrix_inversion_method",
                                                "auto"),
                  seed=d.get("seed", 0), device=self.device)
        for attr in ("num_neighbors", "vecchia_ordering"):
            if d.get(attr) is not None:
                kw[attr] = d[attr]
        self.__init__(**kw)
        if d.get("vecchia_pred_type"):
            self.vecchia_pred_type = d["vecchia_pred_type"]
        if d.get("num_neighbors_pred") is not None:
            self.num_neighbors_pred = d["num_neighbors_pred"]
        self._fit_result = OptimResult(
            cov_pars=np.asarray(d["cov_pars"], dtype=np.float64),
            num_it=d.get("num_optim_iter", 0),
            neg_log_likelihood=d.get("neg_log_likelihood", np.nan),
            converged=True)
        self.model_has_been_fitted = d.get("model_has_been_fitted", True)
        if d.get("y") is not None:
            self.y = np.asarray(d["y"], dtype=np.float64)


def _init_ranges(comp):
    """Initial range via the median-distance rule (cov_fcts.h:1599-1668
    FindInitCovPar), on at most 1000 sampled points."""
    coords = comp.coords
    n = len(coords)
    if n > 1000:
        rng = np.random.RandomState(0)
        coords = coords[rng.choice(n, 1000, replace=False)]
    iu = np.triu_indices(len(coords), k=1)
    d = pairwise_dist(torch.as_tensor(coords), method="direct").numpy()[iu]
    md = np.median(d)
    if md <= 0:
        md = np.mean(d)
    cf = comp.cov_fn
    if cf.cov_fct_type == "exponential" or cf.shape <= 1.0:
        alpha = 2.0 * 3.0 / md
    elif cf.shape <= 2.0:
        alpha = 2.0 * 4.7 / md
    else:
        alpha = 2.0 * 5.9 / md
    return list(np.atleast_1d(cf.range_from_transformed(alpha)))
