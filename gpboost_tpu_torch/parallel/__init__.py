"""Parallel training of the port (counterpart of gpboost_tpu/parallel/):
the process group of the parallel tree learners and `spawn_train`, the
one-process entry point that starts local ranks."""

from .group import all_reduce, block, default_group
from .spawn import spawn_train

__all__ = ["all_reduce", "block", "default_group", "spawn_train"]
