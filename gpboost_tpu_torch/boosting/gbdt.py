"""Booster for Gaussian regression boosting, alone or with a GP model (the
GPBoost algorithm), and for non-Gaussian likelihoods with a GP model
(LaGaBoost); counterpart of gpboost_tpu/boosting/gbdt.py, host-loop path.

One boosting round (gbdt.cpp:412 TrainOneIter with the GP hooks):

  1. gradients at the current score F: without a GP model grad = F - y
     and hess = 1, both times the Dataset weights if it has them
     (gbdt.py:954-960, :1107-1108); with a Gaussian one, those of the
     marginal NLL, grad = Psi~^-1 (F - y) / sigma2 through the GP model's
     engine (dense, Woodbury or Vecchia); with a non-Gaussian one, the
     gradient in F of the Laplace-approximated NLL at the current mode
     (gbdt.py:1127-1139), in data order for every engine (grouped, dense
     or Vecchia-Laplace); hess = 1;
  2. one leaf-wise tree on them (tree_learner.py, histogram kernels);
     with leaves_newton_update the leaf values are re-solved by GLS, with
     line_search_step_length the tree is scaled by the 1-D GLS optimum;
  3. F += learning_rate * tree output;
  4. with a GP model, the covariance parameters are refitted on the new
     residuals (Gaussian) or at the new F (non-Gaussian): a full fit with
     the GP model's optimizer settings in the first round, warm-started
     Nesterov GD after.

With use_nesterov_acc (gbdt.cpp:421 ApplyMomentumStep,
nesterov_boosting.h:19) each round starts with a momentum step on the
score, F <- (1 + mu) F - mu F_prev with mu from `_nesterov_schedule`, and
with a GP model a refit on the post-momentum residuals: two refits a round.
`predict` replays the recursion over the trees (gbdt_prediction.cpp:22-34).

The objective of LaGaBoost is the GP model's likelihood, whatever the
`objective` parameter says (gbdt.py:647); its init score is the
intercept-only Laplace fit at the initial covariance parameters
(gbdt.py:857-887, FindInitialValueBoosting).

Boosting without a GP model can grow its trees over a torch.distributed
group (num_parallel_devices = the group's size, tree_learner data, feature
or voting); each rank then keeps the score of the rows its learner holds.

The training score F and the labels live on the booster's device in
float64; the trees are host numpy objects (tree.py), as in the reference.
The reference's `_psi_tilde_inv_mat` (gbdt.py:2395) is each engine's
`psi_tilde_inv_mat` here, on the device.
The reference's fused multi-round `lax.scan` paths wait (ROADMAP A13):
`train` always runs the host loop. Every parameter of the reference's
defaults (gbdt.py:448-521) and aliases (:523-539) is read or checked:
DART/GOSS/RF, sampling, constraints,
missing-value options, the other objectives' settings, a GP model together
with a parallel tree learner, and every objective other than Gaussian
regression without a non-Gaussian GP model raise NotImplementedError.
boost_from_average=False starts plain boosting from score 0.
"""

import numpy as np
import torch

from .tree import Tree
from .tree_learner import SerialTreeLearner
from ..models.jit_gd import gd_fit_engine, gd_fit_laplace_engine
from ..parallel.group import default_group
from ..utils.device import resolve_device

_OBJ_ALIASES = {
    "regression": "gaussian", "regression_l2": "gaussian", "l2": "gaussian",
    "mean_squared_error": "gaussian", "mse": "gaussian",
    "gaussian": "gaussian",
}

# the reference's defaults (gbdt.py:448-521): every parameter the port
# reads or checks; a non-default value of the last two groups raises
_BOOST_PARAM_DEFAULTS = dict(
    learning_rate=0.1, num_leaves=31, max_depth=-1, min_data_in_leaf=20,
    lambda_l2=0.0, lambda_l1=0.0, min_sum_hessian_in_leaf=1e-3,
    min_gain_to_split=0.0, objective="regression",
    train_gp_model_cov_pars=True, use_gp_model_for_validation=True,
    maxit_gp=10, reuse_learning_rates_gp_model=True, verbose=1, max_bin=255,
    boosting="gbdt", leaves_newton_update=False,
    line_search_step_length=False, use_nesterov_acc=False,
    nesterov_acc_rate=0.5, momentum_offset=0, momentum_schedule_version=1,
    boost_from_average=True,
    bagging_fraction=1.0, bagging_freq=0, feature_fraction=1.0,
    path_smooth=0.0, extra_trees=False, linear_tree=False,
    monotone_constraints=None, interaction_constraints=None,
    forcedsplits_filename="", cegb_penalty_split=0.0,
    cegb_penalty_feature_coupled=None, cegb_penalty_feature_lazy=None,
    num_parallel_devices=None, tree_learner="serial", top_k=20,
)
# the options of unported features (DART, GOSS, other objectives,
# ranking, class weights, refit, categorical splits, sampling seeds, CEGB,
# extra trees, missing values): only their defaults pass
_UNPORTED_DEFAULTS = dict(
    drop_rate=0.1, max_drop=50, skip_drop=0.5, drop_seed=4, top_rate=0.2,
    other_rate=0.1, num_class=1, alpha=0.9, sigmoid=1.0,
    lambdarank_norm=True, lambdarank_truncation_level=30,
    is_unbalance=False, scale_pos_weight=1.0, refit_decay_rate=0.9,
    cat_smooth=10.0, cat_l2=10.0, max_cat_threshold=32,
    min_data_per_group=100, label_gain=None, objective_seed=5,
    eval_at=(1, 2, 3, 4, 5), bagging_seed=3, feature_fraction_seed=2,
    cegb_tradeoff=1.0, extra_seed=6, use_missing=True, zero_as_missing=False,
)
_BOOST_PARAM_DEFAULTS.update(_UNPORTED_DEFAULTS)
_UNPORTED_IF_CHANGED = (
    "boosting", "bagging_fraction", "bagging_freq",
    "feature_fraction", "path_smooth", "extra_trees", "linear_tree",
    "monotone_constraints", "interaction_constraints",
    "forcedsplits_filename", "cegb_penalty_split",
    "cegb_penalty_feature_coupled", "cegb_penalty_feature_lazy") \
    + tuple(_UNPORTED_DEFAULTS)
# tree_learner values and their aliases -> the learner's parallel_mode
# (gbdt.py:590-596)
_TREE_LEARNERS = {
    "serial": "data", "data": "data", "data_parallel": "data",
    "feature": "feature", "feature_parallel": "feature",
    "voting": "voting", "voting_parallel": "voting",
}

_PARAM_ALIASES = {
    "shrinkage_rate": "learning_rate", "eta": "learning_rate",
    "num_leaf": "num_leaves", "min_data": "min_data_in_leaf",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "lambda": "lambda_l2", "reg_lambda": "lambda_l2",
    "reg_alpha": "lambda_l1", "l1_regularization": "lambda_l1",
    "min_split_gain": "min_gain_to_split",
    "num_iterations": "num_boost_round", "num_trees": "num_boost_round",
    "n_estimators": "num_boost_round", "num_round": "num_boost_round",
    "boosting_type": "boosting", "boost": "boosting",
    "monotone_constraint": "monotone_constraints",
    "sub_row": "bagging_fraction", "subsample": "bagging_fraction",
    "bagging": "bagging_fraction", "subsample_freq": "bagging_freq",
    "sub_feature": "feature_fraction", "colsample_bytree": "feature_fraction",
    "unbalance": "is_unbalance", "unbalanced_sets": "is_unbalance",
}


def _nesterov_schedule(i, version=1, rate=0.5, offset=0):
    """Momentum rate at boosting iteration i (gbdt.h:399
    NesterovSchedule)."""
    if i < offset:
        return 0.0
    if version == 0:
        return float(rate)
    if version == 1:
        return 1.0 - 3.0 / (6.0 + i)
    return 0.0


def _changed(value, default):
    """Whether a parameter differs from its default; sequences compare by
    their entries."""
    if isinstance(value, (list, tuple, np.ndarray)):
        return default is None or list(np.ravel(value)) != list(default)
    return value != default


def _parse_params(raw, laplace=False):
    """The booster's parameters; laplace: a non-Gaussian GP model sets the
    objective, so any `objective` passes."""
    p = dict(_BOOST_PARAM_DEFAULTS)
    for k, v in (raw or {}).items():
        p[_PARAM_ALIASES.get(k, k)] = v
    if p["use_nesterov_acc"] and p["boosting"] != "gbdt":
        raise ValueError("use_nesterov_acc requires boosting='gbdt'")
    changed = [k for k in _UNPORTED_IF_CHANGED
               if _changed(p[k], _BOOST_PARAM_DEFAULTS[k])]
    if changed:
        raise NotImplementedError("not ported yet: " + ", ".join(
            f"{k}={p[k]!r}" for k in changed))
    if not laplace and _OBJ_ALIASES.get(p["objective"]) != "gaussian":
        raise NotImplementedError(
            f"objective '{p['objective']}' is not ported yet (Gaussian "
            "regression only)")
    if str(p["tree_learner"]) not in _TREE_LEARNERS:
        raise ValueError(f"Unknown tree_learner '{p['tree_learner']}'")
    return p


class Booster:
    """Tree-boosting model for Gaussian regression, alone or combined with
    a GPModel, and for a non-Gaussian GPModel's likelihood (basic.py:2315
    Booster)."""

    def __init__(self, params=None, train_set=None, gp_model=None,
                 model_dict=None, device=None):
        if model_dict is not None:
            self._load(model_dict, device)
            return
        laplace = gp_model is not None and gp_model.likelihood != "gaussian"
        self.params = _parse_params(params, laplace)
        p = self.params
        if gp_model is not None:
            if int(p["num_parallel_devices"] or 1) > 1:
                raise NotImplementedError("a GP model with a parallel tree "
                                          "learner is not ported yet")
            group = None
        else:
            group = default_group(p["num_parallel_devices"])
        if device is None and gp_model is not None:
            device = gp_model.device
        self.device = resolve_device(device)
        self.train_set = train_set
        self.gp_model = gp_model
        train_set.construct()
        self.n = train_set.num_data
        y = train_set.get_label()
        if y is None:
            raise ValueError("train_set has no label")
        self.objective_name = gp_model.likelihood if laplace else "gaussian"
        self.learner = SerialTreeLearner(
            train_set, num_leaves=int(p["num_leaves"]),
            max_depth=int(p["max_depth"]),
            min_data_in_leaf=int(p["min_data_in_leaf"]),
            lambda_l2=float(p["lambda_l2"]), lambda_l1=float(p["lambda_l1"]),
            min_sum_hessian_in_leaf=float(p["min_sum_hessian_in_leaf"]),
            min_gain_to_split=float(p["min_gain_to_split"]),
            device=self.device,
            parallel_mode=_TREE_LEARNERS[str(p["tree_learner"])],
            top_k=int(p["top_k"]), group=group)
        self.trees = []
        if laplace:
            # the intercept-only Laplace fit, from the closed-form
            # intercept (FindInitialValueBoosting, re_model.cpp:634-690)
            c0 = gp_model._likelihood_obj.init_intercept(
                np.asarray(y, dtype=np.float64), self._gp_total_re_var(y))
            self.init_score = self._find_init_score_gp(y, c0)
        elif gp_model is None and not p["boost_from_average"]:
            self.init_score = 0.0
        else:
            # BoostFromScore for Gaussian regression, with or without a
            # GP model: the response mean over all rows, unweighted as in
            # the reference (regression_objective.hpp:239-283; gbdt.py:
            # 900-902 honours boost_from_average=False without a GP model
            # only)
            self.init_score = float(np.mean(y))
        # the score and labels of the rows this rank's learner holds
        self.y = torch.as_tensor(
            np.asarray(y, dtype=np.float64)[self.learner.rows],
            device=self.device)
        self.F = torch.full((self.learner.n,), self.init_score,
                            dtype=torch.float64, device=self.device)
        # Dataset weights scale grad and hess without a GP model
        # (gbdt.py:1107-1108); with one the reference ignores them
        w = train_set.weight
        self._w = None if w is None or gp_model is not None \
            else torch.as_tensor(w[self.learner.rows], device=self.device)
        self._gp_init_pars = None
        self._gp_lr = 0.1
        self._gp_refit_iter = -1
        self._F_lag1 = None
        self.current_iteration_ = 0

    # ------------------------------------------------------------------
    def _gp_init_cov_pars(self, y):
        gp = self.gp_model
        init = gp.params.init_cov_pars
        if init is None:
            init = gp._default_init_cov_pars(y)
        return np.asarray(init, dtype=np.float64)

    def _gp_total_re_var(self, y):
        """Total variance of the random effects at the GP model's initial
        covariance parameters (GetTotalVarComps, re_model_template.h:1240):
        the rand_eff_var of the closed-form initial intercept."""
        pars = self._gp_init_cov_pars(y)
        tot = sum(float(pars[off]) for off in self.gp_model._engine.par_offsets)
        return max(tot, 1e-10)

    def _find_init_score_gp(self, y, c0):
        """The intercept-only ML fit of the Laplace marginal likelihood at
        the initial covariance and aux parameters (gbdt.py:857-887):
        L-BFGS-B over one intercept, the mode warm-started."""
        from scipy.optimize import minimize
        from ..models.optimize import OptimConfig, _laplace_u0
        gp = self.gp_model
        eng = gp._engine
        cfg = OptimConfig(**{**gp.params.__dict__,
                             "init_cov_pars": self._gp_init_cov_pars(y)})
        u = _laplace_u0(eng, y, cfg)
        yd = eng.prep_y(gp._likelihood_obj.check_y(y))
        state = {"a": eng.zero_mode()}
        n = len(y)

        def fun(c):
            nll, _, gF, a = eng.laplace_vag_F(u, yd, np.full(n, float(c[0])),
                                              state["a"])
            state["a"] = a
            if not np.isfinite(nll):
                return 1e30, np.zeros(1)
            return float(nll), np.asarray([gF.sum()])

        r = minimize(fun, np.asarray([c0], dtype=np.float64), jac=True,
                     method="L-BFGS-B", options={"maxiter": 50})
        return float(r.x[0]) if np.all(np.isfinite(r.x)) else float(c0)

    def _gradients(self):
        """(grad, hess) at the current score F, as device tensors."""
        if self.gp_model is None:
            if self._w is None:
                return self.F - self.y, torch.ones_like(self.F)
            return (self.F - self.y) * self._w, self._w
        # covariance parameters are refitted after each tree (update());
        # here only when no fit for the current F exists yet
        if self._gp_refit_iter != self.current_iteration_:
            self._refit_gp_cov()
        gp = self.gp_model
        eng = gp._engine
        if gp._likelihood_obj is not None:
            # LaGaBoost: the gradient in F of the Laplace marginal NLL
            r = gp._fit_result
            u = eng._u_from_pars(r.cov_pars, r.aux_pars, gp.y)
            a = r.mode_state if r.mode_state is not None \
                else eng.zero_mode()
            _, _, gF, _ = eng.vag_F_device(u, self.y, self.F, a,
                                           value=False)
            return gF, torch.ones_like(gF)
        # grad = Sigma^-1 (F - y) = Psi~^-1 resid / sigma2 on the
        # nugget-scaled parameterization (re_model_template.h:9691)
        t = eng.transform_pars(gp._fit_result.cov_pars)
        resid = self.F - self.y
        grad = eng.psi_tilde_inv_mat(t, resid[:, None])[:, 0] / float(t[0])
        return grad, torch.ones_like(grad)

    def _refit_gp_cov(self):
        """(Re-)estimate the covariance parameters on the residuals of the
        current ensemble (gbdt.cpp:549): a full fit the first time, then
        the warm-started GD from the previous optimum
        (reuse_learning_rates_gp_model, config.h:181)."""
        gp = self.gp_model
        if gp._likelihood_obj is not None:
            self._refit_laplace()
            self._gp_refit_iter = self.current_iteration_
            return
        resid = self.F - self.y
        if self.params["train_gp_model_cov_pars"]:
            if self._gp_init_pars is None:
                gp.fit(y=resid)
                self._gp_init_pars = gp._fit_result.cov_pars
                self._gp_lr = 0.1
            else:
                lr0 = self._gp_lr \
                    if self.params["reuse_learning_rates_gp_model"] else 0.1
                pars, nll, lr, _ = gd_fit_engine(
                    gp._engine, self._gp_init_pars, resid, lr0=lr0,
                    max_iter=int(self.params["maxit_gp"]))
                self._gp_lr = min(max(lr, 1e-8) * 2.0, 0.1)
                self._gp_init_pars = pars
                gp._fit_result.cov_pars = pars
                gp._fit_result.neg_log_likelihood = nll
        elif not gp.model_has_been_fitted:
            gp.fit(y=resid)
            self._gp_init_pars = gp._fit_result.cov_pars
        self._gp_refit_iter = self.current_iteration_

    def _refit_laplace(self):
        """The non-Gaussian refit at the current F (gbdt.py:1181-1227): a
        full fit with the GP model's own settings the first time (or
        whenever the fast path does not apply), then the warm-started GD
        refit of the parameters and the mode, with the learning rate
        restarted at its default each round."""
        gp = self.gp_model
        if not (self.params["train_gp_model_cov_pars"]
                or not gp.model_has_been_fitted):
            return
        eng = gp._engine
        if gp.model_has_been_fitted and gp.X is None:
            r = gp._fit_result
            a0 = r.mode_state if r.mode_state is not None \
                else eng.zero_mode()
            lr0 = float(gp.params.lr_cov) if gp.params.lr_cov > 0 else 0.1
            pars, aux, nll, _, _, a = gd_fit_laplace_engine(
                eng, r.cov_pars, r.aux_pars if eng.num_aux else None,
                self.y, self.F, a0, lr0=lr0,
                max_iter=int(self.params["maxit_gp"]),
                est_aux=bool(gp.params.estimate_aux_pars))
            r.cov_pars = pars
            if aux is not None:
                r.aux_pars = aux
            r.neg_log_likelihood = nll
            r.mode_state = a
            self._gp_init_pars = pars
        else:
            fp = {}
            if self._gp_init_pars is not None:
                fp["init_cov_pars"] = self._gp_init_pars
            gp.fit(y=self.y.cpu().numpy(), offset=self.F.cpu().numpy(),
                   params=fp)
            self._gp_init_pars = gp._fit_result.cov_pars

    def _newton_leaf_values(self, tree, slot_of_row, leaf_value_of_slot):
        """Joint GLS re-solve of the leaf values given the tree's
        structure, a* = (H' Psi~^-1 H)^-1 H' Psi~^-1 (y - F) with H the
        (n, leaves) leaf incidence (re_model_template.h:4947
        NewtonUpdateLeafValues; gbdt.py:1411-1430), on the device."""
        eng = self.gp_model._engine
        t = eng.transform_pars(self.gp_model._fit_result.cov_pars)
        slots = torch.unique(slot_of_row)
        H = (slot_of_row[:, None] == slots[None, :]).to(torch.float64)
        PiH = eng.psi_tilde_inv_mat(t, H)
        A = H.T @ PiH + 1e-12 * torch.eye(len(slots), dtype=torch.float64,
                                          device=H.device)
        vals = torch.linalg.solve(A, PiH.T @ (self.y - self.F))
        for s_, v_ in zip(slots.tolist(), vals.tolist()):
            leaf_value_of_slot[s_] = v_
            node = tree.slot_to_node.get(s_)
            if node is not None:
                tree.leaf_value[node] = v_

    def _line_search(self, tree, slot_of_row, leaf_value_of_slot):
        """Optimal step length of the Gaussian GPBoost algorithm: the 1-D
        GLS optimum alpha = h' Psi~^-1 r / h' Psi~^-1 h, clipped to [0, 10]
        (re_model.cpp:697 LineSearchLearningRate; gbdt.py:1431-1450).
        Returns the scaled leaf values; the tree is scaled in place."""
        eng = self.gp_model._engine
        t = eng.transform_pars(self.gp_model._fit_result.cov_pars)
        h = torch.as_tensor(leaf_value_of_slot,
                            device=self.device)[slot_of_row]
        Pih = eng.psi_tilde_inv_mat(t, h[:, None])[:, 0]
        denom, num = torch.stack([h @ Pih, (self.y - self.F) @ Pih]).tolist()
        if denom > 1e-300:
            alpha = min(max(num / denom, 0.0), 10.0)
            tree.shrinkage(alpha)
            leaf_value_of_slot = leaf_value_of_slot * alpha
        return leaf_value_of_slot

    def _momentum_mu(self, i):
        p = self.params
        return _nesterov_schedule(i, int(p["momentum_schedule_version"]),
                                  float(p["nesterov_acc_rate"]),
                                  int(p["momentum_offset"]))

    def update(self):
        """One boosting iteration (gbdt.cpp:412 TrainOneIter)."""
        if self.params["use_nesterov_acc"]:
            # the momentum step on the score comes before the gradients;
            # with a GP model the covariance parameters are refitted on the
            # post-momentum residuals (gbdt.cpp:428 condition iii)
            if self._F_lag1 is None:
                self._F_lag1 = self.F.clone()
            mu = self._momentum_mu(self.current_iteration_)
            F_new = (1.0 + mu) * self.F - mu * self._F_lag1
            self._F_lag1, self.F = self.F, F_new
            if self.gp_model is not None:
                self._refit_gp_cov()
        grad, hess = self._gradients()
        tree, slot_of_row, leaf_value_of_slot = self.learner.train(grad, hess)
        if self.gp_model is not None \
                and self.gp_model._likelihood_obj is None:
            if self.params["leaves_newton_update"]:
                self._newton_leaf_values(tree, slot_of_row,
                                         leaf_value_of_slot)
            if self.params["line_search_step_length"]:
                leaf_value_of_slot = self._line_search(
                    tree, slot_of_row, leaf_value_of_slot)
        lr = float(self.params["learning_rate"])
        tree.shrinkage(lr)
        lv = torch.as_tensor(leaf_value_of_slot, device=self.device)
        self.F = self.F + lr * lv[slot_of_row]
        self.trees.append(tree)
        self.current_iteration_ = len(self.trees)
        # refit on the post-tree residuals so get_cov_pars(), predictions
        # and the next round's gradients see the current ensemble
        if self.gp_model is not None:
            self._refit_gp_cov()
        return False

    # ------------------------------------------------------------------
    def predict(self, data, group_data_pred=None,
                group_rand_coef_data_pred=None, gp_coords_pred=None,
                cluster_ids_pred=None, predict_var=False,
                predict_cov_mat=False, pred_latent=False, cov_pars=None):
        """Fixed effect from the trees plus the GP model's random effect
        (basic.py:3455; gbdt.py:2095-2124 Gaussian branch);
        random_effect_cov holds the covariance matrix with predict_cov_mat,
        else the variances. Without a GP model, the raw score (n,) numpy."""
        X = np.asarray(data, dtype=np.float64)
        if X.ndim == 1:
            X = X[:, None]
        F_pred = np.zeros(len(X))
        lag = None
        for it, tree in enumerate(self.trees):
            if self.params["use_nesterov_acc"]:
                # the training-time momentum recursion
                if it == 1:
                    lag = F_pred.copy()
                elif it > 1:
                    mu = self._momentum_mu(it)
                    F_pred, lag = (1.0 + mu) * F_pred - mu * lag, F_pred
            F_pred = F_pred + tree.predict_raw(X)
        F_pred = F_pred + self.init_score
        if self.gp_model is None:
            return F_pred
        if self.gp_model._likelihood_obj is not None:
            return self._predict_laplace(
                F_pred, group_data_pred, group_rand_coef_data_pred,
                gp_coords_pred, cluster_ids_pred, predict_var,
                predict_cov_mat, pred_latent, cov_pars)
        resid = (self.y - self.F).cpu().numpy()
        pred = self.gp_model.predict(
            y=resid, group_data_pred=group_data_pred,
            group_rand_coef_data_pred=group_rand_coef_data_pred,
            gp_coords_pred=gp_coords_pred, cluster_ids_pred=cluster_ids_pred,
            predict_var=predict_var, predict_cov_mat=predict_cov_mat,
            predict_response=not pred_latent, cov_pars=cov_pars)
        out = {"fixed_effect": F_pred, "random_effect_mean": pred["mu"],
               "random_effect_cov": pred["cov"] if predict_cov_mat
               else pred["var"],
               "random_effect_var": pred["var"],
               "response_mean": F_pred + pred["mu"]}
        if not pred_latent:
            out["response_var"] = pred["var"]
        return out

    def _predict_laplace(self, F_pred, group_data_pred,
                         group_rand_coef_data_pred, gp_coords_pred,
                         cluster_ids_pred, predict_var, predict_cov_mat,
                         pred_latent, cov_pars):
        """LaGaBoost predictions (gbdt.py:2126-2150): random_effect_mean is
        the latent random effect without the trees; the ensemble enters
        the response predictions as fixed_effects_pred."""
        pred = self.gp_model.predict(
            y=self.y.cpu().numpy(), offset=self.F.cpu().numpy(),
            group_data_pred=group_data_pred,
            group_rand_coef_data_pred=group_rand_coef_data_pred,
            gp_coords_pred=gp_coords_pred, cluster_ids_pred=cluster_ids_pred,
            predict_var=predict_var, predict_cov_mat=predict_cov_mat,
            predict_response=not pred_latent, cov_pars=cov_pars,
            fixed_effects_pred=None if pred_latent else F_pred)
        out = {"fixed_effect": F_pred, "random_effect_mean": pred["mu"],
               "random_effect_cov": pred["cov"] if predict_cov_mat
               else pred["var"],
               "random_effect_var": pred["var"]}
        if not pred_latent:
            out["response_mean"] = pred["mu"]
            out["response_var"] = pred["var"]
        return out

    def predict_training_data_random_effects(self, predict_var=False):
        """The random effects at the training points with the current
        ensemble as fixed effects (basic.py:3407; gbdt.py:2155)."""
        if self.gp_model is None:
            raise ValueError("predict_training_data_random_effects: "
                             "Booster has no gp_model")
        if self.gp_model._likelihood_obj is not None:
            return self.gp_model.predict_training_data_random_effects(
                predict_var=predict_var, offset=self.F.cpu().numpy())
        # the Gaussian hook works on residuals: refresh them to the current
        # ensemble
        self.gp_model.y = (self.y - self.F).cpu().numpy()
        return self.gp_model.predict_training_data_random_effects(
            predict_var=predict_var)

    # ------------------------------------------------------------------
    def model_to_dict(self):
        """The reference's model dict (gbdt.py:2282) for this booster."""
        d = {
            "init_score": self.init_score,
            "objective": self.objective_name,
            "params": {k: v for k, v in self.params.items()
                       if isinstance(v, (int, float, str, bool))},
            "trees": [t.to_dict() for t in self.trees],
            "has_gp_model": int(self.gp_model is not None),
            "num_sets": 1,
            "init_score2": 0.0,
        }
        if self.gp_model is not None and self.gp_model.model_has_been_fitted:
            d["gp_model"] = self.gp_model.model_to_dict()
            d["residual_or_y"] = (
                self.y if self.gp_model._likelihood_obj is not None
                else self.y - self.F).cpu().numpy().tolist()
            d["fixed_effect_train"] = self.F.cpu().numpy().tolist()
        return d

    def _load(self, d, device):
        """Rebuild a booster that predicts from a model dict (gbdt.py:2330
        _load), with its GP model, if it has one, on `device`."""
        from ..gp_model import GPModel
        unsupported = [k for k in ("efb", "init_scores", "pandas_categorical",
                                   "binary_label_weights") if d.get(k)]
        if int(d.get("num_sets", 1)) != 1:
            unsupported.append("num_sets")
        laplace = bool(d.get("has_gp_model")) \
            and d["gp_model"]["likelihood"] not in ("gaussian", "regression")
        if d["objective"] != "gaussian" and not laplace:
            unsupported.append(f"objective '{d['objective']}'")
        if unsupported:
            raise NotImplementedError(
                "model dict holds parts that are not ported yet: "
                + ", ".join(unsupported))
        self.params = dict(_BOOST_PARAM_DEFAULTS)
        self.params.update(d.get("params", {}))
        self.init_score = float(d["init_score"])
        self.objective_name = d["objective"]
        self.trees = [Tree.from_dict(td) for td in d["trees"]]
        self.train_set = None
        self.current_iteration_ = len(self.trees)
        self.device = resolve_device(device)
        self.gp_model = None
        if not d.get("has_gp_model"):
            return
        self.gp_model = GPModel(model_dict=d["gp_model"], device=self.device)
        F = np.asarray(d["fixed_effect_train"], dtype=np.float64)
        y = np.asarray(d["residual_or_y"], dtype=np.float64)
        if not laplace:
            y = F + y
        self.F = torch.as_tensor(F, device=self.device)
        self.y = torch.as_tensor(y, device=self.device)
        self.n = len(F)


def train(params, train_set, num_boost_round=100, gp_model=None,
          device=None):
    """Train a boosting model, with or without a GP model (engine.py:22
    train), with the host loop: one `Booster.update` per round. Run inside
    an initialised torch.distributed group with num_parallel_devices equal
    to its size, the trees grow over the group (tree_learner data, feature
    or voting). Validation sets and callbacks are not ported yet."""
    raw = dict(params or {})
    for k in list(raw):
        if _PARAM_ALIASES.get(k, k) == "num_boost_round":
            num_boost_round = int(raw.pop(k))
    booster = Booster(params=raw, train_set=train_set, gp_model=gp_model,
                      device=device)
    for _ in range(num_boost_round):
        booster.update()
    return booster
