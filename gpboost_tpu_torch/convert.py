"""Carry a model trained by the JAX package over to the port.

The JAX package's `Booster.model_to_dict()` returns plain numpy/JSON values:
the trees, the init score, the embedded `GPModel.model_to_dict()` (training
coordinates, covariance parameters, ordering seed, neighbour count) and the
training residuals. The port reads the same schema, so no array crosses
between the frameworks: the port rebuilds the Vecchia ordering and the
neighbour sets from the seed and the coordinates, as the reference did.
"""

from .boosting.gbdt import Booster


def booster_from_jax_dict(d, device=None):
    """(Booster, GPModel) of the port from a JAX `Booster.model_to_dict()`,
    ready to `predict` on `device` (default: the first CUDA card). The
    GPModel is None for a booster trained without one. Gaussian regression
    boosting, alone or with a Vecchia GP, is ported so far; any other model
    raises NotImplementedError."""
    booster = Booster(model_dict=d, device=device)
    return booster, booster.gp_model
