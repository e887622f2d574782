"""GPModel — the mixed-effects and Gaussian-process façade of the PyTorch
port (counterpart of gpboost_tpu/gp_model.py).

Ported, for the Gaussian likelihood, with the engine the reference picks
(gp_model.py:497-519):

  * grouped random effects only: the Woodbury engine (models/grouped_re.py)
    with intercepts, crossed and nested groupings, random slopes
    (group_rand_coef_data, ind_effect_group_rand_coef) and cluster_ids
    (each level refined by its cluster);
  * a GP, alone or with grouped random effects, gp_approx="none": the dense
    engine (models/gaussian_gp.py), with cluster_ids (a same-cluster mask);
  * gp_approx="vecchia" with one isotropic GP: the Vecchia engine
    (models/vecchia.py), in the orderings "random", "none", "time" and
    "time_random_space", with cluster_ids (per-cluster neighbour sets) and
    every prediction ordering of `set_prediction_data`.

All three take observation weights (the nugget of row i is sigma2 / w_i).

For the non-Gaussian likelihoods (the 16 of likelihoods/base.py:
bernoulli_probit / _logit, binomial, poisson, gamma, negative_binomial(_1),
beta, t, t_fix_df, lognormal, tweedie(_fixed_p), asymmetric_laplace (also
with the '_tkc' curvature), gaussian_latent; and the 34 of
likelihoods/families.py: zero-inflated and hurdle counts and amounts,
GPD / EGPD, the censored families, beta_binomial, whose weights are its
trials, quasi-Bernoulli and the heteroscedastic Gaussians;
gp_model.py:468-495), by the Laplace approximation:

  * grouped random effects only: models/grouped_laplace.py, with slopes,
    crossed groupings, cluster_ids and observation weights;
  * a GP, gp_approx="none", alone or with grouped random effects: the
    dense engine of models/laplace.py, with observation weights;
  * one GP, gp_approx="vecchia": the Vecchia-Laplace engines
    (models/vecchia_laplace.py), with observation weights: the
    dense-precision one (matrix_inversion_method="cholesky") or the
    matrix-free one ("iterative": CG solves and SLQ log-determinants of
    ops/iterative.py); as in the reference, "auto" takes the matrix-free
    one above n = 8,000.

A Vecchia GP with grouped random effects (gp_model.py:370-400) runs the
joint latent vector through models/vecchia_grouped.py, for a Gaussian
response as gaussian_latent (the error variance is then an aux
parameter), with observation weights and duplicate coordinates, its dense
joint Hessian or, "iterative" ("auto" above n = 8,000), the matrix-free
one with the vadu, ssor, diagonal or none preconditioner; cluster_ids
raise NotImplementedError there. gp_approx="vecchia_euclidean" is
"vecchia"; gp_approx="vecchia_latent" takes a Gaussian response through
the Vecchia-Laplace engines as gaussian_latent.

The approximations other than Vecchia (gp_model.py:190-233, :273-335,
:407-466), with one GP, num_ind_points (500) inducing points chosen by
ind_points_selection ("kmeans++", the JAX package's centres, or
"random") and a Wendland taper of cov_fct_taper_range and
cov_fct_taper_shape (0, 1 or 2):

  * gp_approx="fitc": models/fitc.py for the Gaussian likelihood (with
    weights), models/fitc_laplace.py for the others;
  * "tapering", "full_scale_tapering" (and its "_pred_var_exact" and
    "_pred_var_exact_stable" variants), "full_scale_vecchia" and
    "full_scale_vecchia_correlation_based": the kernel adapters of
    ops/taper.py on the dense Gaussian or dense Laplace engine; for the
    Gaussian likelihood with one isotropic GP, no weights and no
    cluster_ids, matrix_inversion_method="iterative" (or "auto" above
    n = 8,000) takes the matrix-free engines models/fsa_iterative.py and
    models/fsva_iterative.py (CG and SLQ, whose settings
    set_optim_params takes).

GP random coefficients (spatially varying coefficients,
gp_rand_coef_data: one more GP per column, its kernel scaled by the
covariate) run on the dense Gaussian and dense Laplace engines, also
beside a tapering or full-scale adapter on the main GP
(gp_model.py:237-253); the Vecchia and FITC engines take one GP and
raise NotImplementedError.

A GP takes any of the 14 covariance functions of ops/cov_fcts.py
(exponential, matern of any shape, gaussian, powered_exponential, the ARD
and space-time kernels, wendland, matern_estimate_shape and its ARD form,
space_time_gneiting, hurst(_ard), linear) or "ar1_mf_<base>", the AR1
multifidelity kernel on a base kernel, whose last coordinate column is the
fidelity (0 or 1; gp_approx="vecchia_euclidean" searches neighbours on
the other columns, as "vecchia" does here), on every engine the JAX
package runs them: dense, Vecchia, FITC, the tapering / FSA / VIF
adapters and the Laplace engines; the iterative FSA / FSVA engines keep
to isotropic bases, and the Vecchia-Laplace and combined engines'
predictions to isotropic kernels, where the JAX package's fail. A
Gaussian Vecchia fit of an anisotropic kernel (ARD, space-time) runs in
chunks of max(10, maxit // 10) iterations with the neighbour sets
re-determined in the range-scaled space after each
(`neighbor_redeterminations` lists each one's (changed, host seconds)).
Estimation runs
every optimizer of models/optimize.py (gradient descent, Fisher scoring,
Newton, L-BFGS on the host or on the device, Nelder-Mead, adam; for the
Laplace engines gradient descent, L-BFGS, Nelder-Mead and adam), with
linear covariates `fit(y, X)`, fixed parameters, standard errors
(Gaussian) and aux parameters. Prediction takes group_data_pred,
group_rand_coef_data_pred, gp_coords_pred, gp_rand_coef_data_pred,
X_pred and cluster_ids_pred, with the response's mean and variance
(predict_response) for the non-Gaussian likelihoods, and draws posterior
or prior samples (sample_posterior, sample_prior); `model_to_dict` writes
the reference's state dict and a dict of either package loads here.
A two-predictor likelihood (num_sets_fe = 2: the regression zero models,
gaussian_heteroscedastic) takes fixed effects, offsets and coefficients in
two stacked blocks, the random effects on the first; with two
random-effect sets (gaussian_heteroscedastic_fixed_and_random) every
gp_approx runs on the dense Laplace engine, the second set's parameters
named with "_set2"; the combined Vecchia + grouped engine refuses both,
as the reference does. The
iterative engines (the Woodbury engine's iterative branch, which "auto"
takes above q = 20,000, the matrix-free Vecchia-Laplace and combined
engines and the iterative FSA / FSVA engines) read the reference's CG
keys of `set_optim_params`; `get_num_cg_steps` and
`get_total_num_cg_steps` read the Vecchia-Laplace and combined engines'
counts.
cover_tree_radius, free_raw_data and likelihood_learning_rate are
accepted without effect, as in the reference.

device: where the engine's tensors live (default: the first CUDA card; it
raises without one, and the CPU runs only when device="cpu" is passed).
dtype: the engine's float type, "float64" (default, as the reference) or
"float32".
"""

import math
import time

import numpy as np
import torch

from .likelihoods.base import _ALIASES as _LIK_ALIASES, get_likelihood
from .models.components import GPComponent, GroupedComponent
from .models.gaussian_gp import DenseGaussianEngine, prior_pred_cov
from .models.grouped_laplace import GroupedRELaplaceEngine
from .models.grouped_re import WoodburyGaussianEngine
from .models.laplace import LaplaceDenseEngine
from .models.optimize import (OptimConfig, OptimResult, _fixed_effects,
                              optimize_gaussian, optimize_laplace)
from .models.fitc import FITCGaussianEngine, select_inducing_points
from .models.fitc_laplace import FITCLaplaceEngine
from .models.fsa_iterative import FSAIterativeGaussianEngine
from .models.fsva_iterative import FSVAIterativeGaussianEngine
from .models.vecchia import VecchiaGaussianEngine
from .models.vecchia_grouped import VecchiaGroupedLaplaceEngine
from .models.vecchia_laplace import (VecchiaLaplaceEngine,
                                     VecchiaLaplaceIterativeEngine)
from .ops.cov_fcts import (SUPPORTED_COV_FUNCTIONS,
                            AR1MultifidelityCovariance, CovarianceFunction)
from .ops.taper import (FSACovarianceFunction, TaperedCovarianceFunction,
                        VIFCovarianceFunction)
from .ops.distances import pairwise_dist
from .utils.device import resolve_device, resolve_dtype

# the iterative engines' CG / SLQ settings (gp_model.py:556-600 in the
# reference); without effect on the other engines
_CG_KEYS = ("num_rand_vec_trace", "cg_max_num_it", "cg_delta_conv",
            "seed_rand_vec_trace", "nsim_var_pred", "piv_chol_rank",
            "cg_preconditioner_type")
_OPTIM_PARAM_KEYS = set(OptimConfig.__dataclass_fields__) | set(_CG_KEYS) \
    | {"init_coef",
       # accepted, without effect, as in the reference
       "trace", "cg_max_num_it_tridiag", "reuse_rand_vec_trace",
       "init_coef_aux_pars_from_iid_model"}
_WOODBURY_MAX_Q = 20000
_TAPER_APPROXES = ("tapering", "full_scale_tapering",
                   "full_scale_tapering_pred_var_exact",
                   "full_scale_tapering_pred_var_exact_stable")
_FSVA_APPROXES = ("full_scale_vecchia",
                  "full_scale_vecchia_correlation_based")
_GP_APPROXES = ("none", "vecchia", "vecchia_latent", "vecchia_euclidean",
                "fitc") + _TAPER_APPROXES + _FSVA_APPROXES


class GPModel:
    """Mixed-effects / Gaussian-process model, y = F + Zb + xi for the
    Gaussian likelihood, y ~ p(y | F + Zb) otherwise (basic.py:4172
    GPModel)."""

    def __init__(self,
                 likelihood="gaussian",
                 group_data=None,
                 group_rand_coef_data=None,
                 ind_effect_group_rand_coef=None,
                 drop_intercept_group_rand_effect=None,
                 gp_coords=None,
                 gp_rand_coef_data=None,
                 cov_function="matern",
                 cov_fct_shape=1.5,
                 gp_approx="none",
                 cov_fct_taper_range=1.0,
                 cov_fct_taper_shape=1.0,
                 num_neighbors=None,
                 vecchia_ordering="random",
                 ind_points_selection="kmeans++",
                 num_ind_points=500,
                 cover_tree_radius=1.0,
                 matrix_inversion_method="auto",
                 seed=0,
                 cluster_ids=None,
                 likelihood_additional_param=None,
                 free_raw_data=False,
                 model_file=None,
                 model_dict=None,
                 likelihood_learning_rate=1.0,
                 dtype="float64",
                 weights=None,
                 num_parallel_devices=None,
                 device=None):
        self.device = resolve_device(device)
        if model_file is not None or model_dict is not None:
            self._init_from_dict(model_file, model_dict)
            return
        # pure-name aliases first, so that e.g. "regression" selects the
        # Gaussian engines (ParseLikelihoodAlias, likelihoods.h:10210)
        likelihood = _LIK_ALIASES.get(likelihood, likelihood)
        self._likelihood_obj = None
        if likelihood != "gaussian":
            self._likelihood_obj = get_likelihood(
                likelihood, likelihood_additional_param)
            if getattr(self._likelihood_obj, "num_sets_re", 1) == 2 \
                    and gp_approx in _GP_APPROXES:
                # two random-effect sets
                # (gaussian_heteroscedastic_fixed_and_random,
                # likelihoods.h:474-485) run on the dense Laplace engine
                # whatever the approximation (gp_model.py:359-367): the
                # reference's Vecchia at num_neighbors = n - 1
                gp_approx = "none"
        if gp_approx not in _GP_APPROXES:
            raise NotImplementedError(
                f"gp_approx '{gp_approx}' is not ported yet (ported: "
                f"{', '.join(_GP_APPROXES)})")
        ar1 = cov_function.startswith("ar1_mf_")
        if cov_function not in SUPPORTED_COV_FUNCTIONS and not ar1:
            raise ValueError(
                f"cov_function '{cov_function}' is not supported. "
                f"Supported: {SUPPORTED_COV_FUNCTIONS} and 'ar1_mf_<base>'")
        if ar1 and gp_coords is not None and not np.all(np.isin(
                np.asarray(gp_coords, dtype=np.float64).reshape(
                    len(gp_coords), -1)[:, -1], (0.0, 1.0))):
            raise ValueError(
                "The last column of gp_coords must contain only 0 "
                "(low fidelity) and 1 (high fidelity) for AR1 "
                "multifidelity covariance functions")
        unsupported = ["num_parallel_devices"] \
            if num_parallel_devices is not None else []
        if drop_intercept_group_rand_effect is not None \
                and np.any(drop_intercept_group_rand_effect):
            unsupported.append("drop_intercept_group_rand_effect")
        if unsupported:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(unsupported))
        if group_data is None and gp_coords is None:
            raise ValueError("Both group_data and gp_coords are None. "
                             "Provide at least one random effect.")
        if weights is not None and gp_approx not in ("none", "vecchia",
                                                     "fitc"):
            raise NotImplementedError(
                "weights are currently supported for gp_approx in "
                "('none', 'vecchia', 'fitc')")
        self._dtype = resolve_dtype(dtype)
        self.likelihood = likelihood
        self.likelihood_additional_param = likelihood_additional_param
        self.likelihood_learning_rate = likelihood_learning_rate
        self.weights = None if weights is None \
            else np.asarray(weights, dtype=np.float64)
        # the weights of beta_binomial are its trials, part of the pmf
        # rather than a factor of the log density (gp_model.py:472-476)
        eng_weights = self.weights
        if getattr(self._likelihood_obj, "uses_weights_as_trials", False):
            self._likelihood_obj.set_trials(self.weights)
            eng_weights = None
        self._aux_override = None
        self.gp_approx = gp_approx
        self.cov_function_name = cov_function
        self.cov_fct_shape = cov_fct_shape
        self.cov_fct_taper_range = cov_fct_taper_range
        self.cov_fct_taper_shape = cov_fct_taper_shape
        self.num_ind_points = num_ind_points
        self.ind_points_selection = ind_points_selection
        self.matrix_inversion_method = matrix_inversion_method
        self.seed = seed
        self.num_neighbors = num_neighbors
        self.vecchia_ordering = vecchia_ordering
        self.vecchia_pred_type = "order_obs_first_cond_obs_only"
        self.num_neighbors_pred = None
        self.neighbor_redeterminations = []
        self.components = []
        self._par_names = ["Error_term"] if likelihood == "gaussian" else []

        # grouped random effects first (re_model_template.h:7500)
        self.group_data = None
        if group_data is not None:
            group_data = np.asarray(group_data)
            if group_data.ndim == 1:
                group_data = group_data[:, None]
            self.group_data = group_data
            for ic in range(group_data.shape[1]):
                name = f"Group_{ic + 1}" if group_data.shape[1] > 1 \
                    else "Group_1"
                self.components.append(
                    GroupedComponent(group_data[:, ic], name=name))
                self._par_names.append(name)
        self.group_rand_coef_data = None
        self.ind_effect_group_rand_coef = None
        if group_rand_coef_data is not None:
            if self.group_data is None:
                raise ValueError("group_rand_coef_data needs group_data")
            rc = np.asarray(group_rand_coef_data, dtype=np.float64)
            if rc.ndim == 1:
                rc = rc[:, None]
            self.group_rand_coef_data = rc
            ind = np.atleast_1d(np.asarray(ind_effect_group_rand_coef)) - 1
            self.ind_effect_group_rand_coef = ind
            for ic in range(rc.shape[1]):
                self.components.append(GroupedComponent(
                    self.group_data[:, int(ind[ic])], z=rc[:, ic],
                    name=f"Group_rand_coef_{ic + 1}"))
                self._par_names.append(f"Group_rand_coef_{ic + 1}")

        self.gp_coords = None
        if gp_coords is not None:
            gp_coords = np.asarray(gp_coords, dtype=np.float64)
            if gp_coords.ndim == 1:
                gp_coords = gp_coords[:, None]
            self.gp_coords = gp_coords
            cov_fn = self._gp_cov_fn(gp_coords, cov_function, cov_fct_shape)
            self.components.append(GPComponent(gp_coords, cov_fn, name="GP"))
            self._par_names.extend(_gp_cov_par_names(cov_function,
                                                     gp_coords.shape[1]))
        # GP random coefficients (gp_model.py:237-253): one GP per column of
        # gp_rand_coef_data with its own plain kernel, also under a taper
        self.gp_rand_coef_data = None
        if gp_rand_coef_data is not None:
            if self.gp_coords is None:
                raise ValueError("gp_rand_coef_data needs gp_coords")
            rc = np.asarray(gp_rand_coef_data, dtype=np.float64)
            if rc.ndim == 1:
                rc = rc[:, None]
            self.gp_rand_coef_data = rc
            base = _gp_cov_par_names(cov_function, self.gp_coords.shape[1])
            for ic in range(rc.shape[1]):
                pre = f"GP_rand_coef_nb_{ic + 1}"
                self.components.append(GPComponent(
                    self.gp_coords, CovarianceFunction(
                        cov_function, shape=cov_fct_shape,
                        dim=self.gp_coords.shape[1],
                        taper_range=cov_fct_taper_range,
                        taper_shape=cov_fct_taper_shape),
                    z=rc[:, ic], name=pre))
                self._par_names.extend(
                    [pre + "_var"] + [pre + "_" + nm.replace("GP_", "")
                                      for nm in base[1:]])

        self.num_data = len(self.group_data) if self.group_data is not None \
            else len(self.gp_coords)
        self.cluster_ids = None if cluster_ids is None \
            else np.asarray(cluster_ids)
        # the Vecchia aliases (gp_model.py:336-353): distance-based
        # neighbours are the Vecchia engine's own; vecchia_latent runs a
        # Gaussian response through the Laplace engines with the error
        # variance as the likelihood's aux parameter
        if gp_approx == "vecchia_latent":
            if likelihood != "gaussian":
                raise ValueError("gp_approx='vecchia_latent' requires "
                                 "likelihood='gaussian'")
            self._to_latent_gaussian()
        self._vecchia = gp_approx in ("vecchia", "vecchia_latent",
                                      "vecchia_euclidean")
        if self.gp_rand_coef_data is not None \
                and (self._vecchia or gp_approx == "fitc"):
            # the reference's Vecchia and FITC engines take exactly one GP
            # component (vecchia.py:151, fitc.py:56)
            raise NotImplementedError(
                f"gp_rand_coef_data with gp_approx='{gp_approx}': the "
                "Vecchia and FITC engines take exactly one GP component; "
                "GP random coefficients run on the dense engines "
                "(gp_approx 'none' and the tapering and full-scale "
                "adapters)")
        self._use_woodbury = all(c.kind == "grouped" for c in self.components)
        combined = self._vecchia and {c.kind for c in self.components} \
            == {"gp", "grouped"}
        mim = matrix_inversion_method
        iterative = mim == "iterative" or (mim == "auto"
                                           and self.num_data > 8000)
        single_gp = (len(self.components) == 1
                     and self.components[0].kind == "gp"
                     and self.components[0].z is None
                     and self.cluster_ids is None and self.weights is None)
        if gp_approx in _TAPER_APPROXES + _FSVA_APPROXES \
                and self._likelihood_obj is None and single_gp \
                and self.components[0].cov_fn.base.is_isotropic \
                and iterative:
            # the n-scaling paths (gp_model.py:273-335): the sparse tapered
            # residual with CG and SLQ, or the FSVA congruence
            engine = FSAIterativeGaussianEngine \
                if gp_approx in _TAPER_APPROXES \
                else FSVAIterativeGaussianEngine
            self._engine = engine(self.components, self.num_data,
                                  dtype=self._dtype, device=self.device)
        elif gp_approx == "fitc":
            # gp_model.py:407-466: FITC for the Gaussian likelihood, the
            # FITC-Laplace engine otherwise
            fitc_kw = dict(num_ind_points=num_ind_points,
                           ind_points_selection=ind_points_selection,
                           seed=seed, dtype=self._dtype,
                           weights=eng_weights, device=self.device)
            if self._likelihood_obj is not None:
                self._engine = FITCLaplaceEngine(
                    self.components, self.num_data, self._likelihood_obj,
                    **fitc_kw)
            else:
                self._engine = FITCGaussianEngine(
                    self.components, self.num_data, **fitc_kw)
            self._use_woodbury = False
        elif combined:
            # a Vecchia GP with grouped random effects: the joint latent
            # vector through the Laplace engine (gp_model.py:370-400), a
            # Gaussian response as gaussian_latent
            if self.cluster_ids is not None:
                raise NotImplementedError(
                    "cluster_ids are not supported with gp_approx='vecchia' "
                    "plus grouped random effects")
            if self._likelihood_obj is None:
                self._to_latent_gaussian()
            if mim == "auto":
                mim = "iterative" if self.num_data > 8000 else "cholesky"
            self._engine = VecchiaGroupedLaplaceEngine(
                self.components, self.num_data, self._likelihood_obj,
                num_neighbors=num_neighbors if num_neighbors else 20,
                vecchia_ordering=vecchia_ordering, seed=seed,
                dtype=self._dtype, weights=eng_weights,
                matrix_inversion_method=mim, device=self.device)
        elif self._likelihood_obj is not None and self._vecchia:
            # the reference's rule (gp_model.py:426-434): the matrix-free
            # path above n = 8,000, the dense-precision Cholesky below
            if mim == "auto":
                mim = "iterative" if self.num_data > 8000 else "cholesky"
            engine = VecchiaLaplaceIterativeEngine if mim == "iterative" \
                else VecchiaLaplaceEngine
            self._engine = engine(
                self.components, self.num_data, self._likelihood_obj,
                num_neighbors=num_neighbors if num_neighbors else 20,
                vecchia_ordering=vecchia_ordering, seed=seed,
                dtype=self._dtype, matrix_inversion_method=mim,
                weights=eng_weights, cluster_ids=self.cluster_ids,
                device=self.device)
        elif self._likelihood_obj is not None:
            if self._use_woodbury \
                    and getattr(self._likelihood_obj, "num_sets_re", 1) == 1:
                # the q-dimensional Laplace engine (likelihoods.h:2959 /
                # :3223)
                self._engine = GroupedRELaplaceEngine(
                    self.components, self.num_data, self._likelihood_obj,
                    cluster_ids=self.cluster_ids, dtype=self._dtype,
                    weights=eng_weights, device=self.device)
            else:
                # an exact GP, alone or with grouped random effects (all
                # components in one Sigma, gp_model.py:486-491), or a
                # tapering / FSA / VIF adapter as the GP's kernel
                # (gp_model.py:329-335)
                self._engine = LaplaceDenseEngine(
                    self.components, self.num_data, self._likelihood_obj,
                    cluster_ids=self.cluster_ids, dtype=self._dtype,
                    weights=eng_weights, device=self.device)
        elif self._vecchia:
            self._engine = VecchiaGaussianEngine(
                self.components, self.num_data,
                num_neighbors=num_neighbors if num_neighbors else 20,
                vecchia_ordering=vecchia_ordering, seed=seed,
                dtype=self._dtype, device=self.device,
                weights=eng_weights, cluster_ids=self.cluster_ids)
            self._use_woodbury = False
        elif self._use_woodbury:
            if self.cluster_ids is not None:
                # independence across clusters == each grouping refined by
                # the cluster id
                for comp in self.components:
                    comp.refine_by_cluster(self.cluster_ids)
            if mim == "auto":
                q_tot = sum(c.num_groups for c in self.components)
                mim = "iterative" if q_tot > _WOODBURY_MAX_Q else "cholesky"
            self._engine = WoodburyGaussianEngine(
                self.components, self.num_data, dtype=self._dtype,
                matrix_inversion_method=mim, device=self.device,
                weights=eng_weights)
        else:
            # an exact GP, or a tapering / FSA / VIF adapter riding the
            # dense engine
            self._engine = DenseGaussianEngine(
                self.components, self.num_data, dtype=self._dtype,
                device=self.device, cluster_ids=self.cluster_ids,
                weights=eng_weights)
        if getattr(self._engine, "num_sets_re", 1) == 2:
            # the second set's covariance parameters, the same structure
            # (re_model_template.h:4915-4932)
            self._par_names = self._par_names + [
                nm + "_set2" for nm in self._par_names]
        self.num_cov_par = self._engine.num_cov_par
        self.params = OptimConfig()
        self._coef_override = None
        self._cov_pars_override = None
        self._fit_result = None
        self.y = None
        self.X = None
        self.model_has_been_fitted = False

    def _to_latent_gaussian(self):
        """A Gaussian response on the Laplace path: the gaussian_latent
        likelihood, whose aux parameter is the error variance, so the
        nugget leaves the covariance parameters."""
        self.likelihood = "gaussian_latent"
        self._likelihood_obj = get_likelihood("gaussian_latent")
        self._par_names = [nm for nm in self._par_names
                           if nm != "Error_term"]

    def _gp_cov_fn(self, coords, cov_function, cov_fct_shape):
        """The GP's covariance function, wrapped in the approximation's
        kernel adapter for the tapering, FSA and VIF approximations
        (gp_model.py:163-225)."""
        dim = coords.shape[1]
        # taper smoothness mu = (1 + dim)/2 + taper_shape + 0.5
        # (re_comp.h:1812-1815 GetTaperMu)
        taper_kw = dict(taper_range=self.cov_fct_taper_range,
                        taper_shape=self.cov_fct_taper_shape,
                        taper_mu=(1.0 + dim) / 2.0
                        + self.cov_fct_taper_shape + 0.5)
        if cov_function.startswith("ar1_mf_"):
            cov_fn = AR1MultifidelityCovariance(
                cov_function[len("ar1_mf_"):], shape=cov_fct_shape, dim=dim)
        else:
            # a "wendland" GP is the taper itself (gp_model.py:184-187)
            cov_fn = CovarianceFunction(cov_function, shape=cov_fct_shape,
                                        dim=dim, **taper_kw)
        approx = self.gp_approx
        if approx not in _TAPER_APPROXES + _FSVA_APPROXES:
            return cov_fn
        if approx == "tapering":
            return TaperedCovarianceFunction(cov_fn, CovarianceFunction(
                "wendland", **taper_kw))
        ip = select_inducing_points(coords, self.num_ind_points,
                                    self.ind_points_selection, self.seed)
        if approx in _TAPER_APPROXES:
            return FSACovarianceFunction(cov_fn, CovarianceFunction(
                "wendland", **taper_kw), ip)
        corr_based = approx.endswith("correlation_based")
        init_al = None
        if corr_based:
            init_al = cov_fn.range_to_transformed(np.asarray(
                _init_ranges(GPComponent(coords, cov_fn))))
        return VIFCovarianceFunction(
            cov_fn, ip, coords,
            self.num_neighbors if self.num_neighbors else 30,
            correlation_based=corr_based, init_alphas=init_al,
            device=self.device)

    # ------------------------------------------------------------------
    def set_optim_params(self, params):
        for k, v in (params or {}).items():
            if k not in _OPTIM_PARAM_KEYS:
                raise ValueError(f"Unknown or unported parameter '{k}'")
            if k == "init_cov_pars":
                v = None if v is None else np.asarray(v, dtype=np.float64)
                # the model's current parameters until the next fit
                # (re_model.cpp:302-316 SetOptimConfig)
                self._cov_pars_override = v
            if k == "init_coef" and v is not None:
                self._coef_override = np.asarray(v, dtype=np.float64)
            if k == "init_aux_pars" and v is not None:
                v = np.asarray(v, dtype=np.float64)
                self._aux_override = v
            if hasattr(self.params, k):
                setattr(self.params, k, v)
        cg = {k: params[k] for k in _CG_KEYS if k in (params or {})}
        if cg and getattr(self._engine, "matrix_inversion_method",
                          None) == "iterative":
            self._engine.set_iterative_params(**cg)
        return self

    def set_prediction_data(self, vecchia_pred_type=None,
                            num_neighbors_pred=None, cg_delta_conv_pred=None,
                            nsim_var_pred=None,
                            rank_pred_approx_matrix_lanczos=None):
        """Prediction settings (basic.py GPModel.set_prediction_data): the
        Vecchia prediction type and neighbour count; the iterative
        methods' settings are accepted without effect, as in the
        reference."""
        if vecchia_pred_type is not None:
            self.vecchia_pred_type = vecchia_pred_type
        if num_neighbors_pred is not None:
            self.num_neighbors_pred = num_neighbors_pred
        return self

    def _default_init_cov_pars(self, y, optimizer_cov="lbfgs"):
        """Data-driven initial values (re_model_template.h:4814
        FindInitCovPar): half the response variance to the nugget, the
        other half shared by the components (a non-Gaussian likelihood: a
        total variance of 1, 0.1 for Nelder-Mead); median-distance
        ranges."""
        if self.likelihood == "gaussian":
            var = float(np.var(np.asarray(y, dtype=np.float64), ddof=1))
            pars = [var / 2.0]
            marg_var = var / 2.0 / len(self.components)
        else:
            pars = []
            marg_var = (0.1 if optimizer_cov == "nelder_mead" else 1.0) \
                / len(self.components)
        for comp in self.components:
            pars.append(marg_var)
            if comp.kind == "gp":
                pars.extend(_init_ranges(comp))
        if getattr(self._engine, "num_sets_re", 1) == 2:
            # the second (log-variance) set: the variance from the
            # mean-zero log-normal moment equation (e^s2 - 1) e^s2 =
            # marg_var / 2, the ranges reused (re_model_template.h:
            # 4915-4932)
            pars2, off = [], 0
            for comp in self.components:
                pars2.append(np.log((1.0 + np.sqrt(1.0 + 2.0 * pars[off]))
                                    / 2.0) / 2.0)
                pars2.extend(pars[off + 1: off + comp.num_cov_par])
                off += comp.num_cov_par
            pars = list(pars) + pars2
        return np.asarray(pars)

    def reset_fit(self):
        """Discard the fitted state so the next `fit` starts fresh."""
        self._fit_result = None
        self.y = None
        self.X = None
        self.model_has_been_fitted = False
        return self

    def fit(self, y, X=None, params=None, offset=None):
        """Estimate the covariance parameters (and the coefficients of the
        linear covariates X, if given) for the response y (numpy array or
        tensor, data order); offset: fixed effects F added to the linear
        predictor (a non-Gaussian likelihood) or subtracted from y."""
        self.set_optim_params(params)
        if self._likelihood_obj is not None:
            return self._fit_laplace(y, X, offset)
        if offset is not None:
            y = np.asarray(y, dtype=np.float64) \
                - np.asarray(offset, dtype=np.float64)
        y_t = torch.as_tensor(y, device=self.device).to(torch.float64)
        self.y = y_t.cpu().numpy()
        self.X = None if X is None else np.asarray(X, dtype=np.float64)
        if self.X is not None and self.X.ndim == 1:
            self.X = self.X[:, None]
        cfg = self.params
        if cfg.init_cov_pars is None:
            cfg = OptimConfig(**{**cfg.__dict__, "init_cov_pars":
                                 self._default_init_cov_pars(self.y)})
        X_fit = self.X
        if self._vecchia and X_fit is not None:
            X_fit = X_fit[self._engine.perm]
        y_fit = self._engine.prep_y(y_t)
        cf = self._engine.comp.cov_fn if self._vecchia else None
        if cf is not None and not (cf.is_isotropic or cf.needs_coords):
            self._fit_result = self._fit_aniso_vecchia(y_fit, cfg, X_fit)
        else:
            self._fit_result = optimize_gaussian(self._engine, y_fit, cfg,
                                                 X=X_fit)
        self._coef_override = None
        self._cov_pars_override = None
        self.model_has_been_fitted = True
        return self

    def _fit_aniso_vecchia(self, y_fit, cfg, X_fit):
        """An anisotropic (ARD, space-time) Vecchia fit in chunks of
        max(10, maxit // 10) iterations, each warm-started at the last
        one's parameters, with the neighbour sets re-determined in the
        range-scaled space after each (UpdateNearestNeighbors,
        Vecchia_utils.h:354; re_model_template.h:5105; gp_model.py:
        685-720). As there, a chunk's max_iter gives way to maxit when
        that is set, and the loop ends when the sets stay the same and
        the chunk stopped early."""
        budget = cfg.maxit if cfg.maxit else cfg.max_iter
        chunk = max(10, budget // 10)
        total_it = 0
        r = None
        self.neighbor_redeterminations = []
        while budget > 0:
            step = OptimConfig(**{**cfg.__dict__,
                                  "max_iter": min(chunk, budget)})
            if r is not None:
                step.init_cov_pars = r.cov_pars
            r = optimize_gaussian(self._engine, y_fit, step, X=X_fit)
            total_it += r.num_it
            budget -= min(chunk, budget)
            t_fit = self._engine.transform_pars(r.cov_pars)
            t0 = time.perf_counter()
            changed = self._engine.redetermine_neighbors(t_fit[2:])
            self.neighbor_redeterminations.append(
                (changed, time.perf_counter() - t0))
            if not changed and r.num_it < min(chunk, budget + chunk):
                break
        r.num_it = total_it
        return r

    def _fit_laplace(self, y, X, offset):
        """The non-Gaussian branch of fit (gp_model.py:664-670)."""
        if torch.is_tensor(y):
            y = y.detach().cpu().numpy()
        self.y = self._likelihood_obj.check_y(y)
        self.X = None if X is None else np.asarray(X, dtype=np.float64)
        if self.X is not None and self.X.ndim == 1:
            self.X = self.X[:, None]
        if torch.is_tensor(offset):
            offset = offset.detach().cpu().numpy()
        cfg = self.params
        if cfg.init_cov_pars is None:
            cfg = OptimConfig(**{**cfg.__dict__, "init_cov_pars":
                                 self._default_init_cov_pars(
                                     self.y, cfg.optimizer_cov)})
        self._fit_result = optimize_laplace(self._engine, self.y, cfg,
                                            X=self.X, offset=offset)
        self._coef_override = None
        self._cov_pars_override = None
        self._aux_override = None
        self.model_has_been_fitted = True
        return self

    def neg_log_likelihood(self, cov_pars, y, fixed_effects=None,
                           aux_pars=None):
        if self._likelihood_obj is not None:
            y = self._likelihood_obj.check_y(y)
            if aux_pars is None:
                aux_pars = self._aux_override
            if aux_pars is None and self._fit_result is not None:
                aux_pars = self._fit_result.aux_pars
            return self._engine.neg_log_likelihood(
                self._check_cov_pars(cov_pars), y, aux_pars=aux_pars,
                fixed_effects=fixed_effects)
        y = np.asarray(y, dtype=np.float64)
        if fixed_effects is not None:
            y = y - np.asarray(fixed_effects, dtype=np.float64)
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

    def get_cov_pars(self, std_err=None):
        r = self._require_fit()
        if (std_err if std_err is not None else self.params.std_dev) \
                and r.std_dev_cov_pars is not None:
            return np.vstack([r.cov_pars, r.std_dev_cov_pars])
        return r.cov_pars.copy()

    def get_coef(self, std_err=None):
        r = self._require_fit()
        if std_err and r.std_dev_coef is not None:
            return np.vstack([r.coef, r.std_dev_coef])
        return r.coef

    def get_num_optim_iter(self):
        return self._require_fit().num_it

    def get_aux_pars(self):
        r = self._require_fit()
        return None if r.aux_pars is None else np.array(r.aux_pars)


    def get_num_cg_steps(self):
        """CG iterations of the last mode finding's solves (re_model.h:145
        GetNumCGSteps; matrix_inversion_method='iterative')."""
        n = getattr(self._engine, "last_num_cg_it", None)
        if n is None:
            raise ValueError("no CG solve has run "
                             "(matrix_inversion_method != 'iterative')")
        return int(n)

    def get_total_num_cg_steps(self):
        """CG iterations of every mode finding over the model's
        lifetime."""
        return int(getattr(self._engine, "total_num_cg_it", 0))

    def get_current_neg_log_likelihood(self):
        return self._require_fit().neg_log_likelihood

    def get_cov_par_names(self):
        return list(self._par_names)

    def summary(self):
        """Print and return the estimates (gp_model.py:1139)."""
        r = self._require_fit()
        out = ["Covariance parameters (random effects):"]
        if r.std_dev_cov_pars is not None:
            for n_, p, s in zip(self._par_names, r.cov_pars,
                                r.std_dev_cov_pars):
                out.append(f"  {n_}: {p:.6g} (std dev {s:.4g})")
        else:
            for n_, p in zip(self._par_names, r.cov_pars):
                out.append(f"  {n_}: {p:.6g}")
        if r.aux_pars is not None and self._likelihood_obj is not None \
                and self._likelihood_obj.num_aux:
            out.append("Additional parameters (likelihood):")
            for n_, p in zip(self._likelihood_obj.aux_names, r.aux_pars):
                out.append(f"  {n_}: {p:.6g}")
        if r.coef is not None:
            out.append("Linear regression coefficients:")
            for i, b in enumerate(r.coef):
                out.append(f"  Covariate_{i + 1}: {b:.6g}")
        out.append(f"Negative log-likelihood: {r.neg_log_likelihood:.6f}")
        out.append(f"Number of optimization iterations: {r.num_it}")
        print("\n".join(out))
        return self

    # ------------------------------------------------------------------
    def _residual(self, y=None, fixed_effects=None):
        """y (the fitted response by default) less the fixed effects and
        the linear term, float64 numpy in data order."""
        if y is None:
            if self.y is None:
                raise ValueError("y not provided and model not fitted with y")
            y = self.y
        resid = np.array(y, dtype=np.float64)
        if fixed_effects is not None:
            resid = resid - np.asarray(fixed_effects, dtype=np.float64)
        coef = self._coef_override
        if coef is None and self._fit_result is not None:
            coef = self._fit_result.coef
        if coef is not None and self.X is not None:
            resid = resid - self.X @ coef
        return resid, coef

    def predict(self, y=None, group_data_pred=None,
                group_rand_coef_data_pred=None, gp_coords_pred=None,
                gp_rand_coef_data_pred=None, cluster_ids_pred=None,
                X_pred=None, predict_cov_mat=False, predict_var=False,
                cov_pars=None, predict_response=True, fixed_effects=None,
                fixed_effects_pred=None, offset=None, offset_pred=None,
                sample_posterior=False, sample_prior=False,
                num_post_samples=100, num_prior_samples=None, seed=None):
        """Posterior predictions (basic.py:6187 GPModel.predict): {'mu',
        'var', 'cov'} as float64 numpy. For a non-Gaussian likelihood the
        latent predictions include the fixed effects (offset,
        fixed_effects and X for the training data; offset_pred,
        fixed_effects_pred and X_pred for the new points), and
        predict_response gives the response's mean and variance.

        sample_posterior adds 'posterior_samples' (n_pred,
        num_post_samples): mu + L z with L the Cholesky factor of the
        predictive covariance (+ 1e-10 I), for a non-Gaussian likelihood
        the latent one (predict_response=False); sample_prior returns
        'prior_samples' (n_pred, num_prior_samples) of the random effects'
        prior at the new points (plus the error variance for a Gaussian
        response with predict_response) with mu 0 and that covariance
        (gp_model.py:887-925). The normals come from
        np.random.RandomState(seed), as in the reference; the
        factorization and the product run on the model's device."""
        if sample_prior:
            return self._sample_prior(
                group_data_pred, group_rand_coef_data_pred, gp_coords_pred,
                gp_rand_coef_data_pred, cluster_ids_pred, cov_pars,
                predict_response, num_prior_samples or num_post_samples,
                seed)
        if sample_posterior:
            if self._likelihood_obj is not None and predict_response:
                raise ValueError(
                    "sample_posterior draws the latent process of a "
                    "non-Gaussian likelihood: pass predict_response=False")
            out = self.predict(
                y=y, group_data_pred=group_data_pred,
                group_rand_coef_data_pred=group_rand_coef_data_pred,
                gp_coords_pred=gp_coords_pred,
                gp_rand_coef_data_pred=gp_rand_coef_data_pred,
                cluster_ids_pred=cluster_ids_pred, X_pred=X_pred,
                predict_cov_mat=True, cov_pars=cov_pars,
                predict_response=predict_response,
                fixed_effects=fixed_effects,
                fixed_effects_pred=fixed_effects_pred, offset=offset,
                offset_pred=offset_pred)
            out["posterior_samples"] = out["mu"][:, None] + self._draw(
                out["cov"], num_post_samples, seed)
            if predict_var and out["var"] is None:
                out["var"] = np.diagonal(out["cov"]).copy()
            if not predict_cov_mat:
                out["cov"] = None
            return out
        if cov_pars is None:
            cov_pars = self._cov_pars_override \
                if self._cov_pars_override is not None \
                else self._require_fit().cov_pars
        cov_pars = self._check_cov_pars(cov_pars)
        if self._likelihood_obj is not None:
            return self._predict_laplace(
                y, group_data_pred, group_rand_coef_data_pred,
                gp_coords_pred, gp_rand_coef_data_pred, cluster_ids_pred,
                X_pred, predict_cov_mat, predict_var, cov_pars,
                predict_response, offset, offset_pred, fixed_effects,
                fixed_effects_pred)
        if offset is not None:
            fixed_effects = np.asarray(offset, dtype=np.float64) + (
                0.0 if fixed_effects is None else fixed_effects)
        if offset_pred is not None:
            fixed_effects_pred = np.asarray(offset_pred, dtype=np.float64) \
                + (0.0 if fixed_effects_pred is None else fixed_effects_pred)
        resid, coef = self._residual(y, fixed_effects)
        pred_data = self._build_pred_data(
            group_data_pred, group_rand_coef_data_pred, gp_coords_pred,
            gp_rand_coef_data_pred, cluster_ids_pred)
        extra = {}
        if self._vecchia:
            extra = dict(vecchia_pred_type=self.vecchia_pred_type,
                         num_neighbors_pred=self.num_neighbors_pred)
        out = self._engine.predict(
            cov_pars, resid, pred_data, predict_var=predict_var,
            predict_cov_mat=predict_cov_mat,
            predict_response=predict_response, **extra)
        if coef is not None and X_pred is not None:
            out["mu"] = out["mu"] + np.asarray(X_pred, dtype=np.float64) @ coef
        if fixed_effects_pred is not None:
            out["mu"] = out["mu"] + np.asarray(fixed_effects_pred,
                                               dtype=np.float64)
        for k in ("cov", "var"):
            out.setdefault(k, None)
        return out

    def _draw(self, cov, num_samples, seed):
        """L z on the device for L = chol(cov + 1e-10 I) and z (n_pred,
        num_samples) standard normals from np.random.RandomState(seed), as
        the reference draws them (gp_model.py:916-920)."""
        k = len(cov)
        z = np.random.RandomState(seed).standard_normal((k, num_samples))
        C = torch.as_tensor(np.asarray(cov, dtype=np.float64),
                            device=self.device)
        L = torch.linalg.cholesky(C + 1e-10 * torch.eye(
            k, dtype=C.dtype, device=self.device))
        return (L @ torch.as_tensor(z, device=self.device)).cpu().numpy()

    def _sample_prior(self, group_data_pred, group_rand_coef_data_pred,
                      gp_coords_pred, gp_rand_coef_data_pred,
                      cluster_ids_pred, cov_pars, predict_response,
                      num_samples, seed):
        """Draws of the random effects' prior at the new points: the
        model's covariance there (models/gaussian_gp.py prior_pred_cov)
        from the fitted or the given parameters. The reference reads a
        non-Gaussian model's parameters as if an error variance came
        first (gp_model.py:909-913); the port reads each component's own."""
        pars = self._check_cov_pars(
            cov_pars if cov_pars is not None
            else self._require_fit().cov_pars)
        pred_data = self._build_pred_data(
            group_data_pred, group_rand_coef_data_pred, gp_coords_pred,
            gp_rand_coef_data_pred, cluster_ids_pred)
        if self.cluster_ids is not None:
            # the prior of different clusters is independent whatever the
            # engine (the Vecchia and Woodbury ones take no masks,
            # gp_model.py:1128-1135)
            cip = np.asarray(cluster_ids_pred)
            pred_data["pred_cluster_mask"] = (
                cip[:, None] == cip[None, :]).astype(float)
        gauss = self._likelihood_obj is None
        comp_pars, off = [], int(gauss)
        for comp in self.components:
            comp_pars.append(pars[off:off + comp.num_cov_par])
            off += comp.num_cov_par
        with torch.no_grad():
            K = prior_pred_cov(self.components, comp_pars, pred_data,
                               torch.float64, self.device)
            if predict_response and gauss:
                K = K + float(pars[0]) * torch.eye(
                    len(K), dtype=K.dtype, device=self.device)
            K = K.cpu().numpy()
        return {"mu": np.zeros(len(K)), "cov": K, "var": np.diagonal(K),
                "prior_samples": self._draw(K, num_samples, seed)}

    def _predict_laplace(self, y, group_data_pred, group_rand_coef_data_pred,
                         gp_coords_pred, gp_rand_coef_data_pred,
                         cluster_ids_pred, X_pred,
                         predict_cov_mat, predict_var, cov_pars,
                         predict_response, offset, offset_pred,
                         fixed_effects, fixed_effects_pred):
        """The non-Gaussian branch of predict (gp_model.py:887-1010)."""
        if y is None:
            if self.y is None:
                raise ValueError("y not provided and model not fitted with y")
            y = self.y
        y = np.asarray(y, dtype=np.float64)
        n = self.num_data
        nsets = self._engine.num_sets_fe
        # F and F_pred hold one block per predictor set (gp_model.py:
        # 1004-1050); a part of length n fills the first
        F = np.zeros(n * nsets)
        for part in (offset, fixed_effects):
            if part is not None:
                part = np.asarray(part, dtype=np.float64)
                F[:len(part)] += part
        coef, aux_pars = self._coef_override, self._aux_override
        a_init = None
        if self._fit_result is not None:
            if coef is None:
                coef = self._fit_result.coef
            if aux_pars is None:
                aux_pars = self._fit_result.aux_pars
            a_init = self._fit_result.mode_state
        if coef is not None and self.X is not None:
            F += _fixed_effects(self.X, coef, nsets)
        pred_data = self._build_pred_data(
            group_data_pred, group_rand_coef_data_pred, gp_coords_pred,
            gp_rand_coef_data_pred, cluster_ids_pred)
        n_pred = pred_data["n_pred"]
        F_pred = np.zeros(n_pred * nsets)
        for part in (offset_pred, fixed_effects_pred):
            if part is not None:
                part = np.asarray(part, dtype=np.float64)
                F_pred[:len(part)] += part
        if coef is not None and X_pred is not None:
            F_pred += _fixed_effects(np.asarray(X_pred, dtype=np.float64),
                                     coef, nsets)
        if a_init is not None and a_init.shape != (self._engine.dim_mode,):
            a_init = None
        out = self._engine.predict(
            cov_pars, aux_pars, y, F, pred_data, a_init=a_init,
            predict_var=predict_var, predict_cov_mat=predict_cov_mat,
            predict_response=predict_response, F_pred=F_pred)
        for k in ("cov", "var"):
            out.setdefault(k, None)
        return out

    def _build_pred_data(self, group_data_pred, group_rand_coef_data_pred,
                         gp_coords_pred, gp_rand_coef_data_pred,
                         cluster_ids_pred):
        """Per-component prediction inputs (gp_model.py:1058): level codes
        for the Woodbury engine, cross and prediction incidence matrices
        for the dense one, coordinates for a GP and the covariate column
        z_pred of a GP random coefficient; with cluster_ids the
        cross and prediction same-cluster masks of the dense engines
        (gp_model.py:1127-1137; the Woodbury engine's levels carry their
        clusters instead)."""
        comps = []
        n_pred = None
        ig = igrc = igp = 0
        for comp in self.components:
            pd = {}
            if comp.kind == "grouped":
                if group_data_pred is None:
                    raise ValueError("group_data_pred not provided")
                gdp = np.asarray(group_data_pred)
                if gdp.ndim == 1:
                    gdp = gdp[:, None]
                if comp.z is None:
                    col = gdp[:, ig]
                    ig += 1
                    z_pred = None
                else:
                    col = gdp[:, int(self.ind_effect_group_rand_coef[igrc])]
                    z_pred = np.asarray(group_rand_coef_data_pred,
                                        dtype=np.float64)
                    if z_pred.ndim == 2:
                        z_pred = z_pred[:, igrc]
                    igrc += 1
                codes_pred = comp.codes_for_prediction(col, cluster_ids_pred)
                n_pred = len(codes_pred)
                if self._use_woodbury or getattr(self._engine,
                                                 "wants_codes_pred", False):
                    pd["codes_pred"] = codes_pred
                    pd["z_pred"] = z_pred
                else:
                    cross = (comp.group_codes[:, None]
                             == codes_pred[None, :]).astype(float)
                    predW = (codes_pred[:, None]
                             == codes_pred[None, :]).astype(float)
                    if z_pred is not None:
                        cross = cross * np.outer(comp.z, z_pred)
                        predW = predW * np.outer(z_pred, z_pred)
                    pd["cross_W"] = cross
                    pd["pred_W"] = predW
            else:
                if gp_coords_pred is None:
                    raise ValueError("gp_coords_pred not provided")
                cp = np.asarray(gp_coords_pred, dtype=np.float64)
                if cp.ndim == 1:
                    cp = cp[:, None]
                if self.cov_function_name.startswith("ar1_mf_"):
                    bad = cp[~np.isin(cp[:, -1], (0.0, 1.0)), -1]
                    if len(bad):
                        raise ValueError(
                            "The last column of gp_coords_pred must contain "
                            "only 0 (low fidelity) and 1 (high fidelity), "
                            f"found {bad[0]:g}")
                pd["coords_pred"] = cp
                n_pred = len(cp)
                if comp.z is not None:
                    if gp_rand_coef_data_pred is None:
                        raise ValueError("gp_rand_coef_data_pred not "
                                         "provided")
                    zp = np.asarray(gp_rand_coef_data_pred,
                                    dtype=np.float64)
                    pd["z_pred"] = zp[:, igp] if zp.ndim == 2 else zp
                    igp += 1
            comps.append(pd)
        pred_data = {"comps": comps, "n_pred": n_pred,
                     "cross_cluster_mask": None, "pred_cluster_mask": None}
        if self.cluster_ids is not None:
            if cluster_ids_pred is None:
                raise ValueError("cluster_ids_pred not provided")
            if not self._use_woodbury and not self._vecchia:
                cip = np.asarray(cluster_ids_pred)
                pred_data["cross_cluster_mask"] = (
                    self.cluster_ids[:, None] == cip[None, :]).astype(float)
                pred_data["pred_cluster_mask"] = (
                    cip[:, None] == cip[None, :]).astype(float)
        return pred_data

    def predict_training_data_random_effects(self, predict_var=False,
                                              offset=None):
        """The random effects at the training points, one column per
        component (basic.py:6780; re_model_template.h:4420): a dict of
        float64 numpy columns named like the reference's DataFrame columns,
        with '<name>_var' columns when predict_var=True. A random slope
        reports the latent coefficient. offset: the fixed effects of the
        training data for a non-Gaussian likelihood (the Booster passes
        its ensemble)."""
        r = self._require_fit()
        if self._likelihood_obj is not None:
            means, vs = self._training_re_laplace(r, predict_var, offset)
        else:
            resid, _ = self._residual()
            means, vs = self._engine.training_re(r.cov_pars, resid,
                                                 predict_var=predict_var)
        out = {}
        names = []
        for i, comp in enumerate(self.components):
            kind = "Group" if comp.kind == "grouped" else "GP"
            tag = "_rand_coef" if comp.z is not None else ""
            names.append(f"{kind}_{i + 1}{tag}")
        for j, nm in enumerate(names):
            out[nm] = means[:, j]
        if predict_var and vs is not None:
            for j, nm in enumerate(names):
                out[nm + "_var"] = vs[:, j]
        return out

    def _training_re_laplace(self, r, predict_var, offset):
        eng = self._engine
        u = eng._u_from_pars(r.cov_pars, r.aux_pars, self.y)
        a_state = r.mode_state
        if offset is not None or a_state is None:
            nsets = eng.num_sets_fe
            F = np.zeros(self.num_data * nsets)
            if offset is not None:
                offs = np.asarray(offset, dtype=np.float64)
                F[:len(offs)] += offs
            if r.coef is not None and self.X is not None:
                F += _fixed_effects(self.X, r.coef, nsets)
            _, a_state = eng.laplace_nll(
                u, self.y, F, a_state if a_state is not None
                else eng.zero_mode())
        return eng.training_re(u, a_state, predict_var=predict_var)

    # ------------------------------------------------------------------
    def model_to_dict(self, include_response_data=True):
        """The reference's state dict (gp_model.py:1166 model_to_dict)."""
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
        }
        for attr in ("num_neighbors", "num_ind_points",
                     "ind_points_selection", "cov_fct_taper_range",
                     "cov_fct_taper_shape"):
            if getattr(self, attr) is not None:
                d[attr] = getattr(self, attr)
        if self.num_neighbors_pred is not None:
            d["num_neighbors_pred"] = self.num_neighbors_pred
        if self.likelihood_additional_param is not None:
            d["likelihood_additional_param"] = \
                self.likelihood_additional_param
        for key, val in (("coefs", r.coef), ("aux_pars", r.aux_pars),
                         ("std_dev_cov_pars", r.std_dev_cov_pars),
                         ("std_dev_coef", r.std_dev_coef),
                         ("weights", self.weights)):
            if val is not None:
                d[key] = np.asarray(val).tolist()
        if include_response_data and self.y is not None:
            d["y"] = np.asarray(self.y).tolist()
        if self.X is not None:
            d["X"] = self.X.tolist()
        if self.gp_coords is not None:
            d["gp_coords"] = self.gp_coords.tolist()
        if self.group_data is not None:
            d["group_data"] = self.group_data.tolist()
        if self.group_rand_coef_data is not None:
            d["group_rand_coef_data"] = self.group_rand_coef_data.tolist()
            d["ind_effect_group_rand_coef"] = (
                np.asarray(self.ind_effect_group_rand_coef) + 1).tolist()
        if self.gp_rand_coef_data is not None:
            d["gp_rand_coef_data"] = self.gp_rand_coef_data.tolist()
        if self.cluster_ids is not None:
            d["cluster_ids"] = self.cluster_ids.tolist()
        return d

    def _init_from_dict(self, model_file, model_dict):
        import json
        if model_dict is None:
            with open(model_file) as f:
                model_dict = json.load(f)
        d = model_dict

        def arr(key):
            return None if d.get(key) is None else np.asarray(d[key])

        kw = dict(likelihood=d["likelihood"], gp_coords=arr("gp_coords"),
                  group_data=arr("group_data"),
                  gp_rand_coef_data=arr("gp_rand_coef_data"),
                  cluster_ids=arr("cluster_ids"),
                  cov_function=d["cov_function"],
                  cov_fct_shape=d["cov_fct_shape"],
                  gp_approx=d.get("gp_approx", "none"),
                  matrix_inversion_method=d.get("matrix_inversion_method",
                                                "cholesky"),
                  seed=d.get("seed", 0), device=self.device,
                  weights=arr("weights"),
                  likelihood_additional_param=d.get(
                      "likelihood_additional_param"))
        for attr in ("num_neighbors", "vecchia_ordering", "num_ind_points",
                     "ind_points_selection", "cov_fct_taper_range",
                     "cov_fct_taper_shape"):
            if d.get(attr) is not None:
                kw[attr] = d[attr]
        if d.get("group_rand_coef_data") is not None:
            kw["group_rand_coef_data"] = arr("group_rand_coef_data")
            kw["ind_effect_group_rand_coef"] = arr(
                "ind_effect_group_rand_coef")
        self.__init__(**kw)
        if d.get("vecchia_pred_type"):
            self.vecchia_pred_type = d["vecchia_pred_type"]
        if d.get("num_neighbors_pred") is not None:
            self.num_neighbors_pred = d["num_neighbors_pred"]
        self._fit_result = OptimResult(
            cov_pars=np.asarray(d["cov_pars"], dtype=np.float64),
            num_it=d.get("num_optim_iter", 0),
            neg_log_likelihood=d.get("neg_log_likelihood", np.nan),
            converged=True,
            coef=arr("coefs"), std_dev_cov_pars=arr("std_dev_cov_pars"),
            std_dev_coef=arr("std_dev_coef"), aux_pars=arr("aux_pars"))
        self.model_has_been_fitted = d.get("model_has_been_fitted", True)
        if d.get("y") is not None:
            self.y = np.asarray(d["y"], dtype=np.float64)
        if d.get("X") is not None:
            self.X = np.asarray(d["X"], dtype=np.float64)


def _gp_cov_par_names(cov_function, dim):
    """A GP component's covariance-parameter names (basic.py:5057-5076;
    gp_model.py:1283-1309)."""
    if cov_function.startswith("ar1_mf_"):
        base = _gp_cov_par_names(cov_function[len("ar1_mf_"):], dim - 1)
        return (["low_" + nm for nm in base]
                + ["discrepancy_" + nm for nm in base] + ["rho"])
    if cov_function == "space_time_gneiting":
        return ["sigma2", "a", "c", "alpha", "nu", "beta", "delta"]
    if cov_function == "matern_space_time":
        return ["GP_var", "GP_range_time", "GP_range_space"]
    if cov_function in ("matern_ard", "gaussian_ard"):
        return ["GP_var"] + [f"GP_range_{i + 1}" for i in range(dim)]
    if cov_function in ("wendland", "linear"):
        return ["GP_var"]
    if cov_function == "matern_estimate_shape":
        return ["GP_var", "GP_range", "GP_smoothness"]
    if cov_function == "matern_ard_estimate_shape":
        return ["GP_var"] + [f"GP_range_{i + 1}" for i in range(dim)] \
            + ["GP_smoothness"]
    if cov_function in ("hurst", "hurst_ard"):
        names = ["GP_var", "H"]
        if cov_function == "hurst_ard":
            names += [f"GP_range_{i + 1}" for i in range(1, dim)]
        return names
    return ["GP_var", "GP_range"]


def _median_dist(x):
    """Median pairwise distance of the rows of x (their mean if the median
    is 0)."""
    iu = np.triu_indices(len(x), k=1)
    d = pairwise_dist(torch.as_tensor(x), method="direct").numpy()[iu]
    md = np.median(d)
    return md if md > 0 else np.mean(d)


def _matern_c(shape):
    return 3.0 if shape <= 1.0 else (4.7 if shape <= 2.0 else 5.9)


def _init_ranges(comp):
    """Initial ranges by the median-distance rule (cov_fcts.h:1599-1678
    FindInitCovPar; gp_model.py:1311-1400), on at most 1,000 sampled
    points; for an AR1 multifidelity kernel the base rule on the spatial
    coordinates for both levels, a discrepancy variance of 1 and rho 0."""
    cf = comp.cov_fn
    t = cf.cov_fct_type
    if t.startswith("ar1_mf_"):
        base = _init_ranges(GPComponent(comp.coords[:, :-1], cf.base_low))
        return base + [1.0] + base + [0.0]
    if t in ("hurst", "hurst_ard"):
        # H = 0.5 (Brownian motion), unit ranges (cov_fcts.h:1671-1678)
        return [0.5] + [1.0] * (comp.coords.shape[1] - 1
                                if t == "hurst_ard" else 0)
    if t in ("linear", "wendland"):
        return []
    coords = comp.coords
    n = len(coords)
    if n > 1000:
        coords = coords[np.random.RandomState(0).choice(n, 1000,
                                                        replace=False)]

    def per_col():
        return [_median_dist(coords[:, ic:ic + 1])
                for ic in range(coords.shape[1])]
    if t in ("exponential", "matern"):
        c = 3.0 if t == "exponential" else _matern_c(cf.shape)
        alpha = 2.0 * c / _median_dist(coords)
    elif t == "gaussian":
        alpha = 3.0 / (_median_dist(coords) / 2.0) ** 2
    elif t == "powered_exponential":
        alpha = 3.0 / (_median_dist(coords) / 2.0) ** cf.shape
    elif t == "matern_ard":
        alpha = np.asarray([2.0 * _matern_c(cf.shape) / m for m in per_col()])
    elif t == "gaussian_ard":
        alpha = np.asarray([3.0 / (m / 2.0) ** 2 for m in per_col()])
    elif t == "matern_space_time":
        c = _matern_c(cf.shape)
        alpha = np.asarray([2.0 * c / _median_dist(coords[:, :1]),
                            2.0 * c / _median_dist(coords[:, 1:])])
    elif t == "space_time_gneiting":
        # a, c, alpha, nu, beta, delta (cov_fcts.h:1640-1648)
        ds = coords.shape[1] - 1
        md_t = _median_dist(coords[:, :1])
        a = (20.0 ** (2.0 / ds) - 1.0) / (md_t * md_t) * 4.0
        return [a, 2.0 * 4.7 / _median_dist(coords[:, 1:]), 1.0, 1.5, 1.0,
                1.0]
    elif t == "matern_estimate_shape":
        # the range on the original scale and shape 1.5 (cov_fcts.h:
        # 1610-1613)
        return [_median_dist(coords) * math.sqrt(3.0) / 2.0 / 4.7, 1.5]
    elif t == "matern_ard_estimate_shape":
        return [m * math.sqrt(3.0) / 2.0 / 4.7 for m in per_col()] + [1.5]
    else:
        raise AssertionError(t)
    return list(np.atleast_1d(cf.range_from_transformed(alpha)))
