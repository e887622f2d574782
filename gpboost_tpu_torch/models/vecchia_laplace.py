"""Vecchia-Laplace engines: non-Gaussian likelihoods with a
Vecchia-approximated latent GP (counterpart of
gpboost_tpu/models/vecchia_laplace.py; reference likelihoods.h:3728
FindModePostRandEffCalcMLLVecchia, :6476
CalcGradNegMargLikelihoodLaplaceApproxVecchia, :7954
PredictLaplaceApproxVecchia).

The latent precision is Q(theta) = B' D^-1 B from the Vecchia factors of
the LATENT covariance (no nugget; `VecchiaGaussianEngine._bd(latent=True)`),
and the Laplace objective in precision form is

    nll = 0.5 b'Qb - loglik(b + F) + 0.5 (log|Q + W| - log|Q|),
    mode: Newton on (Q + W),  log|Q| = -sum log D.

On the dense-precision path Q is formed as an n x n matrix, as in the
reference, but summed from B's pattern instead of the reference's dense
product B' (B / D): row i of B has its m + 1 non-zeros on S_i = {i} and
i's neighbours, so Q[j, l] is the sum over the rows i with j, l in S_i of
B[i, j] B[i, l] / D[i], n (m + 1)^2 products in all. The (j, l) pairs of the pattern (j <= l) are sorted once on
the host when the engine is built; each is summed with the deterministic
`SegmentSum` of models/grouped_re.py and placed with `index_put` at unique
positions (no atomics, no duplicate scatter positions from padded
neighbours). Autograd reaches the batched A and D through that assembly,
whose backward is gathers only (`_AssembleQ`).

Every Newton step is one Cholesky of Q + W (cuSOLVER on the card) and one
host read: the 20 Armijo step lengths are evaluated in one batched pass.
Gradients in u and F come from the implicit-function method of
models/laplace.py, with third derivatives through W(b) in log|Q + W|; the
engine's `_VecchiaLaplaceNLL` runs it on one Q per evaluation and takes the
gradient of 0.5 log|Q + W| as 0.5 (Q + W)^-1 from the factor.

Data order: every host-facing method takes y and F in data order; the
engine's `_nll_raw` puts both into the Vecchia order with a permutation
whose backward is the inverse gather, so g_F comes back in data order on
every path (host wrappers, the GD refit, the device L-BFGS) and nothing is
permuted twice. The mode state stays in the Vecchia order.

`VecchiaLaplaceEngine` is the dense-precision path (the Cholesky half of
the reference); `VecchiaLaplaceIterativeEngine`, below, the matrix-free
one (matrix_inversion_method="iterative", the reference's :452-894).
Both take the two-predictor likelihoods (num_sets_fe == 2: F is (2n,), both
blocks permuted into the Vecchia order, the second entering log_lik2);
cluster_ids raise NotImplementedError on both.
"""

import numpy as np
import torch

from ..ops.batched_chol import cho_solve_batched
from ..ops.iterative import (make_slq_logdet_congruence, pcg_it,
                             pivoted_cholesky_kernel)
from .gaussian_base import chol
from .gaussian_gp import _dist
from .grouped_re import SegmentSum
from .laplace import (DELTA_CONV_MODE, MAXIT_MODE_NEWTON, LaplaceEngineBase,
                      _LaplaceNLL)
from .vecchia import VecchiaGaussianEngine, _col, require_isotropic
from ..ops.neighbor_bags import NeighborBags, _At, _Att


class _Permute(torch.autograd.Function):
    """x[perm] along the first axis; the backward is the inverse gather,
    so no scatter and no atomics."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.inv = inv
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.inv), None, None


class _VecchiaLaplaceNLL(torch.autograd.Function):
    """The implicit-function NLL of models/laplace.py `_LaplaceNLL`, with
    one Q per evaluation. The forward builds Q (with its graph, kept for
    the backward, when u needs a gradient), finds the mode and evaluates g
    on it. The backward differentiates g with Q and log|Q| held as leaves
    (the one log-determinant backward; it gives g_b, g_F, and g_u through
    the aux parameters), solves the adjoint lam = (Q + W)^-1 g_b with g's
    own factor, differentiates -lam' r through d1 (r's aux and F parts),
    and makes one pass through the Q assembly and the batched Vecchia
    factors with the cotangents dg/dQ - lam b' and dg/dlog|Q|. The sums are
    g_u - r_u' lam and g_F - r_F' lam, as the separate passes of
    `_LaplaceNLL` give them."""

    @staticmethod
    def forward(ctx, u, F, engine, y, b_init):
        ctx.q_graph = None
        if ctx.needs_input_grad[0]:
            # Q with its graph, kept for the backward
            with torch.enable_grad():
                uu = u.detach().requires_grad_(True)
                ctx.q_graph = (uu,) + tuple(engine._Q_aux(uu))
            Q, logdetQ, aux = (t.detach() for t in ctx.q_graph[1:])
        else:
            Q, logdetQ, aux = engine._Q_aux(u)
        b, nit = engine._newton(Q, aux, F, y, b_init)
        nll, _ = engine._g_Q(Q, logdetQ, aux, F, b, y, False)
        engine._note_it(nit)
        ctx.engine, ctx.y = engine, y
        ctx.save_for_backward(u, F, b)
        ctx.mark_non_differentiable(b)
        return nll.detach(), b

    @staticmethod
    def backward(ctx, ct, _ct_b):
        u, F, b = ctx.saved_tensors
        eng, y = ctx.engine, ctx.y
        need_F = ctx.needs_input_grad[1]
        b = b.detach()
        with torch.enable_grad():
            if ctx.q_graph is None:
                uu = u.detach().requires_grad_(True)
                Q, logdetQ, aux = eng._Q_aux(uu)
            else:
                uu, Q, logdetQ, aux = ctx.q_graph
                ctx.q_graph = None
            FF = F.detach().requires_grad_(need_F)
            bb = b.clone().requires_grad_(True)
            Ql = Q.detach().requires_grad_(True)
            ll = logdetQ.detach().requires_grad_(True)
            g, L = eng._g_Q(Ql, ll, aux, FF, bb, y, True)
            ins = (Ql, ll, bb, uu, FF) if need_F else (Ql, ll, bb, uu)
            # the aux parameters' graph serves the first two passes
            g_Q, g_l, g_b, *g_in = _grad(g, ins, retain_graph=True)
            lam = torch.cholesky_solve(g_b[:, None], L.detach())[:, 0]
            r = eng._r_Q(Q.detach(), aux, FF, b, y)
            r_in = _grad(-(lam @ r), ins[3:], retain_graph=True)
            (q_u,) = _grad((Q, logdetQ), (uu,),
                           (g_Q - lam[:, None] * b[None, :], g_l))
        du = (g_in[0] + r_in[0] + q_u) * ct
        dF = (g_in[1] + r_in[1]) * ct if need_F else None
        return du, dF, None, None, None


class _CholHalfLogdet(torch.autograd.Function):
    """(0.5 log|H|, chol(H)) for SPD H, with the gradient 0.5 H^-1 from
    the factor (`cholesky_inverse`, 2n^3/3 flops) instead of the general
    Cholesky backward (two n x n triangular solves and a product); the
    factor is returned for solves and takes no gradient."""

    @staticmethod
    def forward(ctx, H):
        L = chol(H)
        ctx.save_for_backward(L)
        ctx.mark_non_differentiable(L)
        return torch.sum(torch.log(torch.diagonal(L))), L

    @staticmethod
    def backward(ctx, ct, _ct_L):
        (L,) = ctx.saved_tensors
        return (0.5 * ct) * torch.cholesky_inverse(L)


def _grad(outputs, inputs, grad_outputs=None, retain_graph=None):
    """torch.autograd.grad with zeros for the inputs that are not
    reached."""
    gr = torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs,
                             retain_graph=retain_graph, allow_unused=True)
    return [torch.zeros_like(x) if d is None else d
            for d, x in zip(gr, inputs)]


class _AssembleQ(torch.autograd.Function):
    """Q (n x n) from the products c_a c_b / D (n, m+1, m+1): the kept
    products summed per pair by the engine's `SegmentSum` and placed at
    unique positions, both triangles. The backward is gathers only: each
    pair's cotangent is dQ[j, l] + dQ[l, j] (once on the diagonal), and
    each product takes its pair's (0 where it is not kept), so no
    scatter-add and no atomics."""

    @staticmethod
    def forward(ctx, prods, eng):
        """eng: the `PrecisionAssembly` of the pattern."""
        ctx.eng = eng
        vals = eng._pair_sum(prods.reshape(-1).index_select(0, eng._keep))
        n = eng.n
        Q = prods.new_zeros(n * n)
        Q.index_put_((eng._pos_upper,), vals)
        Q.index_put_((eng._pos_lower,), vals.index_select(0, eng._off))
        return Q.reshape(n, n)

    @staticmethod
    def backward(ctx, gQ):
        eng = ctx.eng
        zero = gQ.new_zeros(1)
        gflat = torch.cat([gQ.reshape(-1), zero])
        g_vals = gflat.index_select(0, eng._pos_upper) \
            + gflat.index_select(0, eng._pos_mirror)
        g = torch.cat([g_vals, zero]).index_select(0, eng._code_of_prod)
        return g.reshape(eng.n, -1, eng._m1), None


def precision_pattern(nn_idx, nn_mask):
    """The upper triangle (j <= l) of Q's pattern, from host arrays.

    Returns (keep, codes, rows, cols): keep indexes the (n, m+1, m+1)
    products c_a c_b / D of each row (c = [1, -A]) that land on a pair
    j <= l of valid entries, codes maps each kept product to its pair, and
    (rows[k], cols[k]) is pair k, sorted by position."""
    n = len(nn_idx)
    S = np.concatenate([np.arange(n)[:, None], nn_idx], 1)
    valid = np.concatenate([np.ones((n, 1), dtype=bool), nn_mask], 1)
    j = S[:, :, None]
    l = S[:, None, :]
    ok = valid[:, :, None] & valid[:, None, :] & (j <= l)
    keep = np.flatnonzero(ok)
    key = (np.broadcast_to(j, ok.shape).reshape(-1)[keep] * n
           + np.broadcast_to(l, ok.shape).reshape(-1)[keep])
    pairs, codes = np.unique(key, return_inverse=True)
    return keep, codes, pairs // n, pairs % n


class PrecisionAssembly:
    """Q = B' D^-1 B (n x n, dense) over a Vecchia engine's neighbour
    pattern: the pattern's pairs sorted once on the host, each summed by
    a `SegmentSum` and placed by `_AssembleQ`."""

    def __init__(self, vecchia, device):
        keep, codes, rows, cols = precision_pattern(
            vecchia._nn_idx.cpu().numpy(), vecchia._nn_mask.cpu().numpy())
        n, npairs = vecchia.n, len(rows)
        self.n = n
        self._m1 = vecchia.m + 1
        self._keep = torch.as_tensor(keep, device=device)
        self._pair_sum = SegmentSum(codes, npairs, device)
        code_of_prod = np.full(n * self._m1 ** 2, npairs, dtype=np.int64)
        code_of_prod[keep] = codes
        self._code_of_prod = torch.as_tensor(code_of_prod, device=device)
        off = np.flatnonzero(rows != cols)
        self._pos_upper = torch.as_tensor(rows * n + cols, device=device)
        self._pos_lower = torch.as_tensor(cols[off] * n + rows[off],
                                          device=device)
        # each pair's mirror position, the zero slot n^2 on the diagonal
        self._pos_mirror = torch.as_tensor(
            np.where(rows != cols, cols * n + rows, n * n), device=device)
        self._off = torch.as_tensor(off, device=device)

    def __call__(self, A, D):
        """Q from the factors A (n, m) and D (n,), differentiable in
        both."""
        c = torch.cat([torch.ones_like(D)[:, None], -A], 1)     # row of B
        prods = (c[:, :, None] * c[:, None, :]) / D[:, None, None]
        return _AssembleQ.apply(prods, self)


class _VecchiaLaplaceBase(LaplaceEngineBase):
    """What the dense-precision and the iterative Vecchia-Laplace engines
    share: the Gaussian Vecchia machinery (ordering, neighbours, batched
    factors), the data-order permutation, the parameter transforms and the
    training-point means."""

    # as in the reference: the fit takes the host L-BFGS-B or GD path
    device_opt_auto = False

    def _init_vecchia(self, components, num_data, likelihood, num_neighbors,
                      vecchia_ordering, seed, dtype, weights, cluster_ids,
                      device):
        if cluster_ids is not None:
            raise NotImplementedError(
                "cluster_ids with gp_approx='vecchia' are supported for the "
                "Gaussian likelihood only (per-cluster neighbor "
                "restriction)")
        # the Gaussian Vecchia machinery: ordering, neighbours, batched B/D
        self._vecchia = VecchiaGaussianEngine(
            components, num_data, num_neighbors=num_neighbors,
            vecchia_ordering=vecchia_ordering, seed=seed, dtype=dtype,
            device=device)
        self.perm = self._vecchia.perm
        # per-observation likelihood weights, in the Vecchia order
        self._init_common(likelihood, num_data, dtype, device,
                          None if weights is None
                          else np.asarray(weights, dtype=np.float64)[
                              self.perm])
        self.comp = self._vecchia.comp
        self.components = self._vecchia.components
        self.par_offsets = [0]
        self.num_theta = self.comp.num_cov_par
        self.num_cov_par = self.num_theta
        self.num_par = self.num_theta + self.num_aux
        self.dim_mode = self.n
        self._perm_d = self._vecchia._perm
        self._inv_d = torch.as_tensor(np.argsort(self.perm),
                                      device=self.device)

    def _split_u(self, u):
        nt = self.num_theta
        return u[:nt], torch.exp(u[nt:])

    def _to_vecchia(self, v):
        return _Permute.apply(v, self._perm_d, self._inv_d)

    def _F_to_vecchia(self, F):
        """F in the Vecchia order, each predictor block on its own."""
        if self.num_sets_fe == 1:
            return self._to_vecchia(F)
        n = self.n
        return torch.cat([self._to_vecchia(F[:n]), self._to_vecchia(F[n:])])

    # parameter transforms (sigma2 = 1 for non-Gaussian likelihoods)
    def transform_pars(self, pars_orig):
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        out = [pars_orig[0]]
        out.extend(np.atleast_1d(self.comp.cov_fn.range_to_transformed(
            pars_orig[1:], var=pars_orig[0])))
        return np.asarray(out)

    def back_transform_pars(self, pars_internal):
        t = np.asarray(pars_internal, dtype=np.float64)
        out = [t[0]]
        out.extend(np.atleast_1d(self.comp.cov_fn.range_from_transformed(
            t[1:], var=t[0])))
        return np.asarray(out)

    def training_re(self, u, a_state, predict_var=False):
        """The posterior (Laplace) mean of the GP at the training points:
        the mode itself, in data order."""
        if predict_var:
            raise ValueError("predict_training_data_random_effects with "
                             "predict_var=True is not implemented for "
                             "gp_approx='vecchia' non-Gaussian; use "
                             "predict()")
        with torch.no_grad():
            b = a_state.index_select(0, self._inv_d)
        return self._host(b)[0][:, None], None


class VecchiaLaplaceEngine(_VecchiaLaplaceBase):
    """Laplace-approximated NLL, gradients and prediction with the Vecchia
    latent precision, dense n x n Cholesky path."""

    def __init__(self, components, num_data, likelihood, num_neighbors=20,
                 vecchia_ordering="random", seed=0, dtype=torch.float64,
                 matrix_inversion_method="cholesky", weights=None,
                 cluster_ids=None, *, device):
        if matrix_inversion_method != "cholesky":
            raise ValueError(
                "the dense-precision engine runs matrix_inversion_method="
                "'cholesky'; 'iterative' is VecchiaLaplaceIterativeEngine")
        self._init_vecchia(components, num_data, likelihood, num_neighbors,
                           vecchia_ordering, seed, dtype, weights,
                           cluster_ids, device)
        self.matrix_inversion_method = matrix_inversion_method
        self._q_asm = PrecisionAssembly(self._vecchia, self.device)

    # ------------------------------------------------------------------
    def _Q_logdetQ(self, theta_log):
        """Latent precision Q = B' D^-1 B (n x n) and log|Q| = -sum log D,
        differentiable in theta_log."""
        A, D = self._vecchia._bd(theta_log, latent=True)
        return self._q_asm(A, D), -torch.sum(torch.log(D))

    def _Q_aux(self, u):
        theta_log, aux = self._split_u(u)
        Q, logdetQ = self._Q_logdetQ(theta_log)
        return Q, logdetQ, aux

    @staticmethod
    def _solve_H(Q, W, rhs):
        """(Q + diag(W))^-1 rhs; a failed factorization (an indefinite
        iterate) gives NaN, which the Armijo test rejects."""
        L = chol(Q + torch.diag(W))
        return torch.cholesky_solve(rhs[:, None], L)[:, 0]

    # ------------------------------------------------------------------
    def _nll_raw(self, u, F, y, b_init, value=True):
        """(nll, (mode state, Newton steps)) for y and F in data order,
        differentiable in u and F; the mode state is in the Vecchia
        order. The value is always computed (value is accepted)."""
        nll, b = _VecchiaLaplaceNLL.apply(u, self._F_to_vecchia(F), self,
                                          self._to_vecchia(y), b_init)
        return nll, (b, self.last_num_mode_it)

    # the hooks of LaplaceEngineBase, each from u; `_VecchiaLaplaceNLL`
    # runs the same steps on one Q per pass
    def _mode_solve(self, u, F, y, b_init):
        with torch.no_grad():
            Q, _, aux = self._Q_aux(u)
            return self._newton(Q, aux, F, y, b_init)

    def _g(self, u, F, b, y, create_graph, value=True):
        return self._g_Q(*self._Q_aux(u), F, b, y, create_graph)[0]

    def _r(self, u, F, b, y):
        Q, _, aux = self._Q_aux(u)
        return self._r_Q(Q, aux, F, b, y)

    def _adjoint_solve(self, u, F, b, y, g_b):
        """(Q + W)^-1 g_b at the mode, W the determinant's curvature."""
        with torch.no_grad():
            Q, _, aux = self._Q_aux(u)
            _, W = self._d1_W(y, self._loc(b, F), aux, self._fisher_det, False)
            return self._solve_H(Q, W, g_b)

    def _newton(self, Q, aux, F, y, b):
        """Newton with Armijo backtracking on Q + W from b: one batched
        pass over the 20 step lengths and one host read per step."""
        obj = -0.5 * (b @ (Q @ b)) + self._loglik(y, self._loc(b, F), aux)
        lrs = self._lrs[:, None]
        it = 0
        while it < MAXIT_MODE_NEWTON:
            d1, W = self._d1_W(y, self._loc(b, F), aux, self._fisher_mode,
                               False)
            grad = d1 - Q @ b
            delta = self._solve_H(Q, W, grad)
            gdd = grad @ delta
            b_k = b + lrs * delta
            obj_k = -0.5 * torch.sum(b_k * (b_k @ Q), -1) \
                + self._loglik(y, self._loc(b_k, F), aux)
            k = self._armijo(obj_k, obj, gdd)
            b_new, obj_new = self._pick(k, b_k, obj_k)
            done = self._newton_done(obj_new, obj, it)
            b, obj = b_new, obj_new
            it += 1
            if done:
                break
        return b, it

    def _g_Q(self, Q, logdetQ, aux, F, b, y, create_graph):
        """(nll at the fixed mode b, the Cholesky factor of Q + W)."""
        loc = self._loc(b, F)
        _, W = self._d1_W(y, loc, aux, self._fisher_det, create_graph)
        half_logdet, L = _CholHalfLogdet.apply(Q + torch.diag(W))
        g = (0.5 * (b @ (Q @ b)) - self._loglik(y, loc, aux) + half_logdet
             - 0.5 * logdetQ)
        return g, L

    def _r_Q(self, Q, aux, F, b, y):
        return Q @ b - self._d1(y, self._loc(b, F), aux)

    # ------------------------------------------------------------------
    def predict(self, pars_orig, aux_pars, y, F, pred_data, a_init=None,
                predict_var=False, predict_cov_mat=False,
                predict_response=False, F_pred=None):
        """Latent (or response) predictions: cross covariances from the
        exact kernel, the training precision from Vecchia
        (PredictLaplaceApproxVecchia). Like the reference it ignores
        vecchia_pred_type."""
        require_isotropic(self.comp.cov_fn,
                          "the dense Vecchia-Laplace engine's prediction")
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        u = self._u_from_pars(pars_orig, aux_pars, y)
        cp = np.asarray(pred_data["comps"][0]["coords_pred"],
                        dtype=np.float64)
        if cp.ndim == 1:
            cp = cp[:, None]
        with torch.no_grad():
            ud = self._t(u)
            theta_log, aux = self._split_u(ud)
            yd = self._to_vecchia(self.prep_y(y))
            Fd = self._F_to_vecchia(self._F(F))
            if a_init is None:
                a_init = self.zero_mode()
            b, nit = self._mode_solve(ud, Fd, yd, a_init)
            self._note_it(nit)
            v = float(pars_orig[0])
            alphas = torch.exp(theta_log[1:])
            cf = self.comp.cov_fn
            K_cross = v * cf.corr_from_dist(
                _dist(self._vecchia.coords_ord, cp, self.dtype, self.device),
                alphas)
            loc = self._loc(b, Fd)
            a, W = self._d1_W(yd, loc, aux, self._fisher_det, False)
            mu, zeta = self._split_pred(K_cross.T @ a, F_pred)  # K' Q b
            var = cov = None
            if predict_var or predict_cov_mat or predict_response:
                # K_pp - K' (Sigma + W^-1)^-1 K with
                # (Sigma + W^-1)^-1 = W - W H^-1 W, H = Q + W
                Q, _ = self._Q_logdetQ(theta_log)
                H = Q + torch.diag(W)
                WK = W[:, None] * K_cross
                if self.likelihood.W_may_be_negative:
                    LU, piv = torch.linalg.lu_factor(H)
                    HinvWK = torch.linalg.lu_solve(LU, piv, WK)
                else:
                    HinvWK = torch.cholesky_solve(WK, chol(H))
                M = WK - W[:, None] * HinvWK
                if predict_cov_mat:
                    K_pp = v * cf.corr_from_dist(
                        _dist(cp, cp, self.dtype, self.device), alphas)
                    cov = K_pp - K_cross.T @ M
                    var = torch.diagonal(cov)
                else:
                    k_pp = v * cf.corr_from_dist(
                        torch.zeros(len(cp), dtype=self.dtype,
                                    device=self.device), alphas)
                    var = k_pp - torch.sum(K_cross * M, 0)
            if predict_response:
                m, vv = self._response(mu, var, zeta, aux)
                out = {"mu": self._host(m)[0]}
                if predict_var or predict_cov_mat:
                    out["var"] = self._host(vv)[0]
                return out
            out = {"mu": self._host(mu)[0]}
            if predict_cov_mat:
                out["cov"] = self._host(cov)[0]
            if predict_var:
                out["var"] = self._host(var)[0].copy()
            return out


# ======================================================================
# The matrix-free (iterative) path: no n x n matrix is formed.
#
# Q v = B'(D^-1 (B v)) with B = I - A, A the (n, m) neighbour coefficients;
# A t and A' t act on a vector (n,) or on columns (n, k): weighted
# `embedding_bag` sums over the neighbour pattern and its transpose
# (ops/neighbor_bags.py), without atomics, so every evaluation, its
# gradient and the CG counts are deterministic.
#
# Preconditioners (re_model_template.h:5859-5867) for the CG solves of
# (Q + W):
#   * "vadu" (Sigma_inv_plus_BtWB, the reference's default):
#     P = B'(D^-1 + W)B with B^-1 applied as the Neumann series
#     S_J = I + A + ... + A^J, J = 32 (A strictly lower triangular in the
#     Vecchia order, so the series is exact once J exceeds the neighbour
#     graph's depth);
#   * "pivoted_cholesky" (piv_chol_on_Sigma_nn): a rank-k pivoted Cholesky
#     L of the kernel matrix, P = (L L' + eps I)^-1 + W by two Woodbury
#     identities;
#   * "vecchia_response": the (Sigma + W^-1)(W x) = Sigma r reformulation,
#     preconditioned by the Vecchia factors of Sigma + W^-1
#     (CG_utils.h:233);
#   * "diagonal" (jacobi) and "none".
# The log-determinant log|Q + W| always rides the vadu congruence
# log|Q + W| = log|M'(Q + W)M| + sum log(D^-1 + W), M = S_J (D^-1 + W)^-1/2,
# exact for every J (S_J is unit triangular), whatever the CG
# preconditioner.
NEUMANN_J = 32
_PC_ALIASES = {"Sigma_inv_plus_BtWB": "vadu",
               "piv_chol_on_Sigma_nn": "pivoted_cholesky",
               "jacobi": "diagonal"}
_PRECONDITIONERS = ("vadu", "pivoted_cholesky", "vecchia_response",
                    "diagonal", "none")


class VecchiaOperators:
    """The matrix-free Vecchia operators over `self._nb`, the
    `NeighborBags` of the factors' (n, m) pattern, and the CG counts over
    `self._cg_acc` and `self.cg_max_num_it` (shared by the iterative
    Vecchia-Laplace engine and the combined engine of
    models/vecchia_grouped.py)."""

    # matrix-free Vecchia operators; v (n,) or columns (n, k)
    def _Bv(self, A, v):
        return v - _At.apply(A, v, self._nb)

    def _Btv(self, A, w):
        return w - _Att.apply(A, w, self._nb)

    def _Qv(self, A, D, v):
        return self._Btv(A, self._Bv(A, v) / _col(D, v))

    def _diag_Q(self, A, D):
        return 1.0 / D + _Att.apply(A * A, 1.0 / D, self._nb)

    def _SJ(self, A, v):
        """S_J v, S_J = I + A + ... + A^J ~= B^-1 (no graph)."""
        w, t = A.reshape(-1), v
        for _ in range(NEUMANN_J):
            t = v + self._nb._a_bags(t, w)
        return t

    def _SJt(self, A, w):
        wt, t = self._nb._t_weights(A), w
        for _ in range(NEUMANN_J):
            t = w + self._nb._at_bags(t, wt)
        return t

    def _count_cg(self, it, maxit=None):
        """Adds one solve's per-column CG iterations (a device tensor) to
        `cg_stats`, without a host read."""
        maxit = self.cg_max_num_it if maxit is None else maxit
        it = it.reshape(-1)
        row = torch.stack([torch.full_like(it[0], it.numel()), it.sum(),
                           (it >= maxit).sum()])
        self._cg_acc = row if self._cg_acc is None else self._cg_acc + row

    def cg_stats(self, reset=False):
        """{"solves", "iterations", "at_maxit"} over every CG solve of this
        engine since the last reset: columns solved (Newton steps, adjoint
        solves, the SLQ gradient's probes, predictive draws), their CG
        iterations and those that stopped at cg_max_num_it (one host
        read)."""
        vals = [0, 0, 0] if self._cg_acc is None else self._cg_acc.tolist()
        if reset:
            self._cg_acc = None
        return dict(zip(("solves", "iterations", "at_maxit"), vals))


class VecchiaLaplaceIterativeEngine(VecchiaOperators, _VecchiaLaplaceBase):
    """Laplace-approximated NLL, gradients and prediction with the Vecchia
    latent precision, matrix-free: Newton with preconditioned CG solves,
    SLQ log-determinants, simulation-based predictive variances
    (counterpart of the iterative half of
    gpboost_tpu/models/vecchia_laplace.py, :452-894)."""

    def __init__(self, components, num_data, likelihood, num_neighbors=20,
                 vecchia_ordering="random", seed=0, dtype=torch.float64,
                 matrix_inversion_method="iterative", num_rand_vec_trace=50,
                 cg_max_num_it=1000, cg_delta_conv=1e-6,
                 seed_rand_vec_trace=1, nsim_var_pred=500,
                 cg_preconditioner_type="vadu", piv_chol_rank=50,
                 weights=None, cluster_ids=None, *, device):
        if matrix_inversion_method != "iterative":
            raise ValueError("VecchiaLaplaceIterativeEngine runs "
                             "matrix_inversion_method='iterative'")
        self._init_vecchia(components, num_data, likelihood, num_neighbors,
                           vecchia_ordering, seed, dtype, weights,
                           cluster_ids, device)
        self.matrix_inversion_method = "iterative"
        # the bags of B v and B'w: row i's slots, and point l's slots of
        # the transposed pattern, sorted once
        self._nb = NeighborBags(self._vecchia._nn_idx_np, self.device)
        self._cg_acc = None
        self._coords_d = torch.as_tensor(self._vecchia.coords_ord,
                                         dtype=dtype, device=self.device)
        self._slq_fn = None
        self.set_iterative_params(
            num_rand_vec_trace=num_rand_vec_trace,
            cg_max_num_it=cg_max_num_it, cg_delta_conv=cg_delta_conv,
            seed_rand_vec_trace=seed_rand_vec_trace,
            nsim_var_pred=nsim_var_pred,
            cg_preconditioner_type=cg_preconditioner_type,
            piv_chol_rank=piv_chol_rank)

    def set_iterative_params(self, **kw):
        """The CG / SLQ settings (gp_model.py:556-600 in the reference):
        num_rand_vec_trace, cg_max_num_it, cg_delta_conv,
        seed_rand_vec_trace, nsim_var_pred, piv_chol_rank and
        cg_preconditioner_type (with the reference's aliases)."""
        casts = {"num_rand_vec_trace": int, "cg_max_num_it": int,
                 "cg_delta_conv": float, "seed_rand_vec_trace": int,
                 "nsim_var_pred": int, "piv_chol_rank": int}
        for k, v in kw.items():
            if k == "cg_preconditioner_type":
                pc = _PC_ALIASES.get(v, v)
                if pc not in _PRECONDITIONERS:
                    raise ValueError(
                        f"cg_preconditioner_type '{v}' is not supported; "
                        "use 'vadu' (Sigma_inv_plus_BtWB), "
                        "'pivoted_cholesky' (piv_chol_on_Sigma_nn), "
                        "'vecchia_response', 'diagonal' or 'none' "
                        "(re_model_template.h:5859)")
                self.cg_preconditioner_type = pc
            elif k in casts:
                setattr(self, k, casts[k](v))
            else:
                raise ValueError(f"unknown iterative setting '{k}'")
        self._slq_fn = None

    def _qw_matvec(self, p, v):
        A, D, W = p
        return self._Qv(A, D, v) + _col(W, v) * v

    @staticmethod
    def _vadu_d(p):
        A, D, W = p
        return torch.clamp(1.0 / D + W, min=1e-10)

    def _precond_vadu(self, p):
        A = p[0]
        d = self._vadu_d(p)
        return lambda r: self._SJ(A, self._SJt(A, r) / _col(d, r))

    def _precond_diag(self, p):
        A, D, W = p
        pd = torch.clamp(self._diag_Q(A, D) + W, min=1e-10)
        return lambda r: r / _col(pd, r)

    def _precond_pivchol(self, p, theta_log):
        """(L L' + eps I)^-1 + W by nested Woodbury identities:
        P^-1 r = G r - G (W^-1 + G)^-1 G r, G = L L' + eps I,
        (W^-1 + eps + L L')^-1 = E - E L (I + L' E L)^-1 L' E,
        E = diag(W / (1 + eps W))."""
        A, D, W = p
        var = torch.exp(theta_log[0])
        alphas = torch.exp(theta_log[1:])
        cov_fn = self.comp.cov_fn
        require_isotropic(cov_fn, "the pivoted_cholesky preconditioner")
        rank = min(self.piv_chol_rank, self.n)
        L, d_rem = pivoted_cholesky_kernel(
            self._coords_d, var,
            lambda dist: cov_fn.corr_from_dist(dist, alphas), rank)
        eps = torch.clamp(torch.mean(d_rem), min=1e-10 * var)
        Wp = torch.clamp(W, min=1e-10)
        E = Wp / (1.0 + eps * Wp)
        EL = E[:, None] * L
        Lc = torch.linalg.cholesky(
            torch.eye(rank, dtype=L.dtype, device=L.device) + L.T @ EL)

        def apply(r):
            Gr = L @ (L.T @ r) + eps * r
            rhs = EL.T @ Gr
            s = torch.cholesky_solve(rhs[:, None] if r.ndim == 1 else rhs,
                                     Lc)
            u = _col(E, r) * Gr - EL @ (s[:, 0] if r.ndim == 1 else s)
            Gu = L @ (L.T @ u) + eps * u
            return Gr - Gu

        return apply

    def _solve_vecchia_response(self, A, D, W, rhs, theta_log):
        """(Q + W) x = rhs through (Sigma + W^-1)(W x) = Sigma rhs
        (CGVecchiaLaplace_Version_SigmaPlusWinvVec, CG_utils.h:233),
        preconditioned by the Vecchia factors (B~, D~) of Sigma + W^-1:
        P^-1 r = B~'(D~^-1 (B~ r)). Returns (x, CG iterations)."""
        Wp = torch.clamp(W, min=1e-10)
        At, Dt = self._vecchia._bd_add_diag(theta_log, 1.0 / Wp)

        def sigma_apply(v):             # Sigma v = B^-1 (D (B^-T v))
            return self._SJ(A, _col(D, v) * self._SJt(A, v))

        def mv(v):
            return sigma_apply(v) + v / _col(Wp, v)

        def pre(r):
            return self._Btv(At, self._Bv(At, r) / _col(Dt, r))

        u, it = pcg_it(mv, sigma_apply(rhs), precond=pre,
                       tol=self.cg_delta_conv, maxit=self.cg_max_num_it)
        self._count_cg(it)
        return u / _col(Wp, u), it

    def _solve_qw(self, A, D, W, rhs, theta_log):
        """(Q + W)^-1 rhs with the engine's preconditioner, rhs (n,) or
        columns (n, k), each column on its own convergence; returns (x,
        CG iterations)."""
        pc = self.cg_preconditioner_type
        if pc == "vecchia_response":
            return self._solve_vecchia_response(A, D, W, rhs, theta_log)
        p = (A, D, W)
        pre = {"vadu": lambda: self._precond_vadu(p),
               "pivoted_cholesky": lambda: self._precond_pivchol(p,
                                                                 theta_log),
               "diagonal": lambda: self._precond_diag(p),
               "none": lambda: None}[pc]()
        x, it = pcg_it(lambda v: self._qw_matvec(p, v), rhs, precond=pre,
                       tol=self.cg_delta_conv, maxit=self.cg_max_num_it)
        self._count_cg(it)
        return x, it

    def _slq(self):
        """log|Q + W| over p = (A, D, W) by the vadu congruence; rebuilt
        when the probe settings change."""
        if self._slq_fn is None:
            def m_apply(p, v):
                return self._SJ(p[0], v / _col(torch.sqrt(self._vadu_d(p)),
                                               v))

            def mt_apply(p, w):
                return self._SJt(p[0], w) / _col(
                    torch.sqrt(self._vadu_d(p)), w)

            self._slq_fn = make_slq_logdet_congruence(
                self._qw_matvec, m_apply, mt_apply,
                lambda p: torch.sum(torch.log(self._vadu_d(p))),
                self._precond_vadu, self.n, rank=min(self.n, 50),
                num_probes=self.num_rand_vec_trace,
                seed=self.seed_rand_vec_trace, dtype=self.dtype,
                device=self.device, count=self._count_cg)
        return self._slq_fn

    # ------------------------------------------------------------------
    # the hooks of LaplaceEngineBase, run by `_LaplaceNLL`
    def _nll_raw(self, u, F, y, b_init, value=True):
        """(nll, (mode state, Newton steps)) for y and F in data order,
        differentiable in u and F; the mode state is in the Vecchia
        order. value=False skips the SLQ value (nll is 0)."""
        nll, b = _LaplaceNLL.apply(u, self._F_to_vecchia(F), self,
                                   self._to_vecchia(y), b_init, value)
        return nll, (b, self.last_num_mode_it)

    def _mode_solve(self, u, F, y, b_init):
        """(mode, (Newton steps, CG iterations))."""
        with torch.no_grad():
            theta_log, aux = self._split_u(u)
            A, D = self._vecchia._bd(theta_log, latent=True)
            return self._newton(A, D, aux, F, y, b_init, theta_log)

    def _newton(self, A, D, aux, F, y, b, theta_log):
        """Newton with Armijo backtracking on Q + W, PCG inner solves: the
        20 step lengths in one batched pass (a Q v over their columns) and
        one host read per step, which also brings the CG count."""
        obj = -0.5 * (b @ self._Qv(A, D, b)) \
            + self._loglik(y, self._loc(b, F), aux)
        lrs = self._lrs[:, None]
        cg = torch.zeros((), dtype=torch.int64, device=self.device)
        it = 0
        while it < MAXIT_MODE_NEWTON:
            d1, W = self._d1_W(y, self._loc(b, F), aux, self._fisher_mode,
                               False)
            grad = d1 - self._Qv(A, D, b)
            delta, cg_it = self._solve_qw(A, D, W, grad, theta_log)
            cg = cg + cg_it
            gdd = grad @ delta
            b_k = b + lrs * delta
            obj_k = -0.5 * torch.sum(b_k * self._Qv(A, D, b_k.T).T, -1) \
                + self._loglik(y, self._loc(b_k, F), aux)
            k = self._armijo(obj_k, obj, gdd)
            b_new, obj_new = self._pick(k, b_k, obj_k)
            rel = DELTA_CONV_MODE * torch.abs(obj)
            conv = torch.abs(obj_new - obj) < rel if it == 0 \
                else (obj_new - obj) < rel
            flag = conv | ~torch.isfinite(obj_new)
            done, ncg = torch.stack([flag.to(cg.dtype), cg]).tolist()
            b, obj = b_new, obj_new
            it += 1
            if done:
                break
        return b, (it, ncg)

    def _note_it(self, stats):
        nit, ncg = stats
        super()._note_it(nit)
        if ncg > 0:
            self.last_num_cg_it = int(ncg)
            self.total_num_cg_it = getattr(self, "total_num_cg_it", 0) \
                + int(ncg)

    def _g(self, u, F, b, y, create_graph, value=True):
        """nll at the fixed mode b; value=False leaves out the SLQ
        log-determinant's value (its gradient stays)."""
        theta_log, aux = self._split_u(u)
        A, D = self._vecchia._bd(theta_log, latent=True)
        loc = self._loc(b, F)
        _, W = self._d1_W(y, loc, aux, self._fisher_det, create_graph)
        logdetQ = -torch.sum(torch.log(D))
        return (0.5 * (b @ self._Qv(A, D, b)) - self._loglik(y, loc, aux)
                + 0.5 * (self._slq()(A, D, W, value=value) - logdetQ))

    def _r(self, u, F, b, y):
        theta_log, aux = self._split_u(u)
        A, D = self._vecchia._bd(theta_log, latent=True)
        return self._Qv(A, D, b) - self._d1(y, self._loc(b, F), aux)

    def _adjoint_solve(self, u, F, b, y, g_b):
        """(Q + W)^-1 g_b at the mode, W the determinant's curvature."""
        with torch.no_grad():
            theta_log, aux = self._split_u(u)
            A, D = self._vecchia._bd(theta_log, latent=True)
            _, W = self._d1_W(y, self._loc(b, F), aux, self._fisher_det, False)
            return self._solve_qw(A, D, W, g_b, theta_log)[0]

    # ------------------------------------------------------------------
    def predict(self, pars_orig, aux_pars, y, F, pred_data, a_init=None,
                predict_var=False, predict_cov_mat=False,
                predict_response=False, F_pred=None):
        """Neighbour-based predictions (CalcPredVecchiaObservedFirstOrder):
        each point conditions on its num_neighbors nearest observed points;
        variances from nsim_var_pred draws of N(mode, (Q + W)^-1), each a CG
        solve (Q + W) x = Q^1/2 u1 + W^1/2 u2 with the JAX package's
        RandomState draws, solved in batches of columns that each stop on
        their own convergence. As there, predict_cov_mat gives no "cov"."""
        from scipy.spatial import cKDTree
        from .vecchia import _corr_sets
        u = self._u_from_pars(np.asarray(pars_orig, dtype=np.float64),
                              aux_pars, y)
        m_nb = self._vecchia.m
        cp = np.asarray(pred_data["comps"][0]["coords_pred"],
                        dtype=np.float64)
        if cp.ndim == 1:
            cp = cp[:, None]
        n_pred = len(cp)
        _, idx_p = cKDTree(self._vecchia.coords_ord).query(
            cp, k=min(m_nb, self.n))
        idx_p = np.asarray(idx_p).reshape(n_pred, -1)
        if idx_p.shape[1] < m_nb:
            idx_p = np.pad(idx_p, ((0, 0), (0, m_nb - idx_p.shape[1])),
                           mode="edge")
        with torch.no_grad():
            ud = self._t(u)
            theta_log, aux = self._split_u(ud)
            yd = self._to_vecchia(self.prep_y(y))
            Fd = self._F_to_vecchia(self._F(F))
            if a_init is None:
                a_init = self.zero_mode()
            b, _ = self._mode_solve(ud, Fd, yd, a_init)
            t0 = torch.exp(theta_log[0])
            idx_d = torch.as_tensor(idx_p, device=self.device)
            cn = self._coords_d[idx_d]                     # (n_pred, m, d)
            ci = self._t(cp)
            corr_nn, corr_ni = _corr_sets(self.comp.cov_fn, cn, ci,
                                          torch.exp(theta_log[1:]))
            K_nn = t0 * corr_nn + 1e-10 * self._vecchia._eye
            k_ni = t0 * corr_ni
            a_p = cho_solve_batched(K_nn, k_ni)            # (n_pred, m)
            d_p = t0 - torch.sum(a_p * k_ni, 1)
            mu = torch.sum(a_p * b[idx_d], 1)
            var = None
            if predict_var or predict_response:
                var = d_p + self._sim_var(theta_log, aux, yd, Fd, b, a_p,
                                          idx_d)
            mu, zeta = self._split_pred(mu, F_pred)
            if predict_response:
                m_, v_ = self._response(mu, var, zeta, aux)
                out = {"mu": self._host(m_)[0]}
                if predict_var:
                    out["var"] = self._host(v_)[0]
                return out
            out = {"mu": self._host(mu)[0]}
            if predict_var:
                out["var"] = self._host(var)[0]
            return out

    def _sim_var(self, theta_log, aux, yd, Fd, b, a_p, idx_d, chunk=100):
        """The variance over nsim_var_pred draws of x ~ N(0, (Q + W)^-1) of
        each prediction point's conditional mean a_p' x[neighbours]."""
        A, D = self._vecchia._bd(theta_log, latent=True)
        _, W = self._d1_W(yd, self._loc(b, Fd), aux, self._fisher_det, False)
        sW = torch.sqrt(torch.clamp(W, min=0.0))
        rng = np.random.RandomState(self.seed_rand_vec_trace)
        nsim = self.nsim_var_pred
        u1 = rng.standard_normal((nsim, self.n))
        u2 = rng.standard_normal((nsim, self.n))
        sD = torch.sqrt(D)
        proj = []
        for s in range(0, nsim, chunk):
            U1 = self._t(np.ascontiguousarray(u1[s:s + chunk].T))
            U2 = self._t(np.ascontiguousarray(u2[s:s + chunk].T))
            rhs = self._Btv(A, U1 / sD[:, None]) + sW[:, None] * U2
            X, _ = self._solve_qw(A, D, W, rhs, theta_log)  # (n, chunk)
            proj.append(torch.einsum("pm,pms->sp", a_p, X[idx_d]))
        return torch.var(torch.cat(proj), 0, unbiased=False)
