"""Carry a model trained by the JAX package over to the port.

The JAX package's `GPModel.model_to_dict()` and `Booster.model_to_dict()`
return plain numpy/JSON values: the likelihood with its additional
parameter, the covariance, aux and coefficient estimates, the
model-defining data (grouping variables, slopes, coordinates, the
covariates of GP random coefficients, cluster ids,
observation weights, covariates, the Vecchia ordering seed and neighbour
count, the inducing points' count, selection and seed, the taper's range
and shape), the response, and for a booster the trees, the init score,
the training score and the training residuals (the labels for
LaGaBoost). The port reads the same schema, so no array crosses between the
frameworks: the port rebuilds every engine from that data, as the reference
did. The port's own dicts load in the JAX package the same way.
"""

from .boosting.gbdt import Booster
from .gp_model import GPModel


def gp_model_from_jax_dict(d, device=None):
    """The port's GPModel from a JAX `GPModel.model_to_dict()`, ready to
    `predict` on `device` (default: the first CUDA card). Gaussian models
    with grouped random effects, an exact GP (alone or with grouped random
    effects), a Vecchia GP or a GP under FITC, tapering, full-scale
    tapering or full-scale Vecchia, a Vecchia GP with grouped random
    effects, and models of every likelihood of the JAX package (the 16 of
    likelihoods/base.py and the 34 of likelihoods/families.py) with
    grouped random effects, an exact GP (with grouped effects too) or a
    Vecchia, FITC or tapering GP (a Vecchia one with grouped effects too,
    for one predictor set), exact and tapered GPs with random coefficients
    (gp_rand_coef_data) included, are ported: a two-predictor likelihood's
    coefficients come in two stacked blocks, and a model with two
    random-effect sets carries its second set's parameters after the
    first's (the `_set2` names); any other model raises
    NotImplementedError. The
    inducing points are not in the dict:
    both packages draw them again from the coordinates, the seed,
    num_ind_points and ind_points_selection, and kmeans++ places the same
    centres in both."""
    return GPModel(model_dict=d, device=device)


def booster_from_jax_dict(d, device=None):
    """(Booster, GPModel) of the port from a JAX `Booster.model_to_dict()`,
    ready to `predict` on `device` (default: the first CUDA card). The
    GPModel is None for a booster trained without one. Every boosting
    model without a GP model loads: the LightGBM objectives, multiclass
    and mean_scale_regression (num_sets blocks of interleaved trees, their
    init_scores), tobit, lambdarank and rank_xendcg, random forests
    (boosting "rf": the trees averaged), DART and GOSS models, linear
    leaves (each tree's leaf_linear). With a GP model, Gaussian boosting
    with a GP model that `gp_model_from_jax_dict` loads, and LaGaBoost with
    such a non-Gaussian GP model, with a two-predictor likelihood's
    interleaved trees (num_sets = 2); several predictor blocks with any
    other GP model raise NotImplementedError."""
    booster = Booster(model_dict=d, device=device)
    return booster, booster.gp_model
