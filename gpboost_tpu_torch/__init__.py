"""gpboost_tpu_torch — the PyTorch / CUDA port of gpboost_tpu.

Tree boosting combined with grouped random effects or a Gaussian process,
y = F(X) + Zb + xi, run with PyTorch tensors on an NVIDIA GPU (or the CPU).
Gaussian mixed-effects models and GPs fit alone (exact, grouped random
effects by the Woodbury identity, or Vecchia-approximated) and inside the
GPBoost algorithm:

    import gpboost_tpu_torch as gpt
    lmm = gpt.GPModel(group_data=group).fit(y=y, X=X,
                                            params={"std_dev": True})
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=20)
    bst = gpt.train({"objective": "regression", "num_leaves": 31},
                    gpt.Dataset(X, label=y), num_boost_round=100, gp_model=gp)
    pred = bst.predict(X_new, gp_coords_pred=coords_new)

Non-Gaussian likelihoods (binary, counts, positive and bounded responses,
Student-t, quantile; likelihoods/base.py) fit by the Laplace approximation
with grouped random effects or one exact GP, alone and inside boosting
(LaGaBoost, the objective taken from the GP model):

    glmm = gpt.GPModel(group_data=group, likelihood="bernoulli_logit")
    bst = gpt.train({"num_leaves": 15}, gpt.Dataset(X, label=y),
                    num_boost_round=100, gp_model=glmm)
    prob = bst.predict(X_new, group_data_pred=group_new)["response_mean"]

Plain Gaussian regression boosting (gp_model=None) also trains over a
torch.distributed group with the data-, feature- and voting-parallel tree
learners; `spawn_train` starts the local ranks from one process:

    bst = gpt.spawn_train({"objective": "regression", "num_leaves": 31,
                           "tree_learner": "data"}, X, y,
                          num_boost_round=100, world_size=4)

Plain boosting takes the LightGBM objectives (binary, poisson, gamma,
tweedie, quantile, l1, huber, fair, mape, cross_entropy, ...), bagging and
feature_fraction; model selection runs on validation sets with early
stopping and callbacks, by cross-validation or by grid search:

    bst = gpt.train({"objective": "binary", "metric": "binary_logloss"},
                    gpt.Dataset(X, label=y), num_boost_round=500,
                    valid_sets=[gpt.Dataset(X_val, label=y_val)],
                    early_stopping_rounds=10)
    prob = bst.predict(X_new, num_iteration=bst.best_iteration)
    res = gpt.cv({"learning_rate": 0.1}, gpt.Dataset(X, label=y),
                 gp_model=gpt.GPModel(group_data=group), nfold=4,
                 num_boost_round=100, early_stopping_rounds=5)

The booster's modes: DART, GOSS and random forests (`boosting`),
linear leaves (`linear_tree`), multiclass (`num_class`), mean-scale and
Grabit (`tobit`) regression, learning to rank (lambdarank, rank_xendcg,
with query sizes in the Dataset and ndcg / map for validation) and
`Booster.refit` on new data:

    bst = gpt.train({"objective": "lambdarank", "eval_at": [10]},
                    gpt.Dataset(X, label=relevance, group=query_sizes),
                    num_boost_round=100,
                    valid_sets=[gpt.Dataset(X_val, label=rel_val,
                                            group=val_sizes)])

The histograms of the tree learners are hand-written CUDA kernels
(csrc/histogram.cu, csrc/hist_masked.cu); everything else is plain torch.
The package never imports jax or gpboost_tpu; `convert` reads the JAX
package's model dicts.
"""

from .gp_model import GPModel
from .boosting import Dataset, Booster, train
from .engine import cv, grid_search_tune_parameters
from .parallel import spawn_train
from .utils.log import Log, register_logger, set_log_level
from . import callback

__version__ = "0.1.0"

__all__ = ["GPModel", "Dataset", "Booster", "train", "cv",
           "grid_search_tune_parameters", "spawn_train", "callback", "Log",
           "register_logger", "set_log_level", "__version__"]
