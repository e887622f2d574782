"""Training callbacks for train()/cv (a copy of gpboost_tpu/callback.py).

Reference: python-package/gpboost/callback.py:237 — print_evaluation /
log_evaluation, record_evaluation, reset_parameter, early_stopping, with the
CallbackEnv protocol and before/after-iteration ordering.
"""

import collections

from .utils.log import Log

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    """Raised by the early_stopping callback (callback.py:14)."""

    def __init__(self, best_iteration, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _fmt(res):
    name, metric, score, _ = res
    return f"{name}'s {metric}: {score:g}"


def log_evaluation(period=1, show_stdv=True):
    """Log evaluation results every `period` iterations (callback.py
    print_evaluation/log_evaluation)."""

    def _callback(env):
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(_fmt(r) for r in env.evaluation_result_list)
            Log.info(f"[{env.iteration + 1}]\t{result}")
    _callback.order = 10
    return _callback


print_evaluation = log_evaluation


def record_evaluation(eval_result):
    """Record evaluation history into the passed dict (callback.py
    record_evaluation)."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _callback(env):
        for name, metric, score, _ in env.evaluation_result_list:
            eval_result.setdefault(name, collections.OrderedDict()) \
                .setdefault(metric, []).append(score)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs):
    """Reset parameters each iteration (callback.py reset_parameter).

    kwargs values are either lists (one value per iteration) or callables
    iteration -> value; e.g. learning_rate=lambda it: 0.1 * 0.99 ** it.
    """

    def _callback(env):
        new_parameters = {}
        for key, value in kwargs.items():
            if callable(value):
                new_parameters[key] = value(env.iteration
                                            - env.begin_iteration)
            else:
                try:
                    new_parameters[key] = value[env.iteration
                                                - env.begin_iteration]
                except IndexError:
                    raise ValueError(
                        f"Length of list {key!r} has to be at least "
                        f"{env.iteration - env.begin_iteration + 1}")
        if new_parameters:
            env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds, first_metric_only=False, verbose=True):
    """Early-stopping callback (callback.py early_stopping): stop when no
    validation metric improved in the last `stopping_rounds` iterations."""
    best_score = []
    best_iter = []
    best_score_list = []
    cmp_op = []
    enabled = [True]

    def _init(env):
        enabled[0] = bool(env.evaluation_result_list)
        if not enabled[0]:
            return
        if verbose:
            Log.info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds")
        for res in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if res[3]:      # higher_better
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _callback(env):
        if not cmp_op:
            _init(env)
        if not enabled[0]:
            return
        for i, res in enumerate(env.evaluation_result_list):
            score = res[2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    Log.info(f"Early stopping, best iteration is:\n"
                             f"[{best_iter[i] + 1}]\t"
                             + "\t".join(_fmt(r)
                                         for r in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if first_metric_only:
                break
    _callback.order = 30
    return _callback
