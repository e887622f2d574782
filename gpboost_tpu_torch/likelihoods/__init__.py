from .base import Likelihood, get_likelihood, SUPPORTED_LIKELIHOODS

__all__ = ["Likelihood", "get_likelihood", "SUPPORTED_LIKELIHOODS"]
