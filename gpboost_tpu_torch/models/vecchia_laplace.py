"""Vecchia-Laplace engine, dense-precision path: non-Gaussian likelihoods
with a Vecchia-approximated latent GP (counterpart of the Cholesky half of
gpboost_tpu/models/vecchia_laplace.py; reference likelihoods.h:3728
FindModePostRandEffCalcMLLVecchia, :6476
CalcGradNegMargLikelihoodLaplaceApproxVecchia, :7954
PredictLaplaceApproxVecchia).

The latent precision is Q(theta) = B' D^-1 B from the Vecchia factors of
the LATENT covariance (no nugget; `VecchiaGaussianEngine._bd(latent=True)`),
and the Laplace objective in precision form is

    nll = 0.5 b'Qb - loglik(b + F) + 0.5 (log|Q + W| - log|Q|),
    mode: Newton on (Q + W),  log|Q| = -sum log D.

Q is formed as an n x n matrix, as in the reference, but summed from B's
pattern instead of the reference's dense product B' (B / D): row i of B has
its m + 1 non-zeros on S_i = {i} and i's neighbours, so Q[j, l] is the sum
over the rows i with j, l in S_i of B[i, j] B[i, l] / D[i], n (m + 1)^2
products in all. The (j, l) pairs of the pattern (j <= l) are sorted once on
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

matrix_inversion_method="iterative" (the matrix-free PCG / SLQ path),
two-predictor likelihoods (num_sets_fe == 2) and cluster_ids raise
NotImplementedError.
"""

import numpy as np
import torch

from .gaussian_base import chol
from .gaussian_gp import _dist
from .grouped_re import SegmentSum
from .laplace import MAXIT_MODE_NEWTON, LaplaceEngineBase
from .vecchia import VecchiaGaussianEngine


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


class VecchiaLaplaceEngine(LaplaceEngineBase):
    """Laplace-approximated NLL, gradients and prediction with the Vecchia
    latent precision, dense n x n Cholesky path."""

    # as in the reference: the fit takes the host L-BFGS-B or GD path
    device_opt_auto = False

    def __init__(self, components, num_data, likelihood, num_neighbors=20,
                 vecchia_ordering="random", seed=0, dtype=torch.float64,
                 matrix_inversion_method="cholesky", weights=None,
                 cluster_ids=None, *, device):
        if matrix_inversion_method == "iterative":
            raise NotImplementedError(
                "matrix_inversion_method='iterative' for gp_approx='vecchia' "
                "with a non-Gaussian likelihood (the matrix-free PCG / SLQ "
                "path with its preconditioners, ops/iterative.py) is not "
                "ported yet; pass matrix_inversion_method='cholesky'")
        if getattr(likelihood, "num_sets_fe", 1) == 2:
            raise NotImplementedError(
                "two-predictor likelihoods (num_sets_fe = 2) are not ported "
                "yet for gp_approx='vecchia'")
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
        self.matrix_inversion_method = matrix_inversion_method
        dev = self.device
        self._perm_d = self._vecchia._perm
        self._inv_d = torch.as_tensor(np.argsort(self.perm), device=dev)
        keep, codes, rows, cols = precision_pattern(
            self._vecchia._nn_idx.cpu().numpy(),
            self._vecchia._nn_mask.cpu().numpy())
        n, npairs = self.n, len(rows)
        self._m1 = self._vecchia.m + 1
        self._keep = torch.as_tensor(keep, device=dev)
        self._pair_sum = SegmentSum(codes, npairs, dev)
        code_of_prod = np.full(n * self._m1 ** 2, npairs, dtype=np.int64)
        code_of_prod[keep] = codes
        self._code_of_prod = torch.as_tensor(code_of_prod, device=dev)
        off = np.flatnonzero(rows != cols)
        self._pos_upper = torch.as_tensor(rows * n + cols, device=dev)
        self._pos_lower = torch.as_tensor(cols[off] * n + rows[off],
                                          device=dev)
        # each pair's mirror position, the zero slot n^2 on the diagonal
        self._pos_mirror = torch.as_tensor(
            np.where(rows != cols, cols * n + rows, n * n), device=dev)
        self._off = torch.as_tensor(off, device=dev)

    # ------------------------------------------------------------------
    def _Q_logdetQ(self, theta_log):
        """Latent precision Q = B' D^-1 B (n x n) and log|Q| = -sum log D,
        differentiable in theta_log."""
        A, D = self._vecchia._bd(theta_log, latent=True)
        c = torch.cat([torch.ones_like(D)[:, None], -A], 1)     # row of B
        prods = (c[:, :, None] * c[:, None, :]) / D[:, None, None]
        return _AssembleQ.apply(prods, self), -torch.sum(torch.log(D))

    def _split_u(self, u):
        nt = self.num_theta
        return u[:nt], torch.exp(u[nt:])

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
    def _nll_raw(self, u, F, y, b_init):
        """(nll, (mode state, Newton steps)) for y and F in data order,
        differentiable in u and F; the mode state is in the Vecchia
        order."""
        nll, b = _VecchiaLaplaceNLL.apply(u, self._to_vecchia(F), self,
                                          self._to_vecchia(y), b_init)
        return nll, (b, self.last_num_mode_it)

    def _to_vecchia(self, v):
        return _Permute.apply(v, self._perm_d, self._inv_d)

    # the hooks of LaplaceEngineBase, each from u; `_VecchiaLaplaceNLL`
    # runs the same steps on one Q per pass
    def _mode_solve(self, u, F, y, b_init):
        with torch.no_grad():
            Q, _, aux = self._Q_aux(u)
            return self._newton(Q, aux, F, y, b_init)

    def _g(self, u, F, b, y, create_graph):
        return self._g_Q(*self._Q_aux(u), F, b, y, create_graph)[0]

    def _r(self, u, F, b, y):
        Q, _, aux = self._Q_aux(u)
        return self._r_Q(Q, aux, F, b, y)

    def _adjoint_solve(self, u, F, b, y, g_b):
        """(Q + W)^-1 g_b at the mode, W the determinant's curvature."""
        with torch.no_grad():
            Q, _, aux = self._Q_aux(u)
            _, W = self._d1_W(y, b + F, aux, self._fisher_det, False)
            return self._solve_H(Q, W, g_b)

    def _newton(self, Q, aux, F, y, b):
        """Newton with Armijo backtracking on Q + W from b: one batched
        pass over the 20 step lengths and one host read per step."""
        obj = -0.5 * (b @ (Q @ b)) + self._loglik(y, b + F, aux)
        lrs = self._lrs[:, None]
        it = 0
        while it < MAXIT_MODE_NEWTON:
            d1, W = self._d1_W(y, b + F, aux, self._fisher_mode, False)
            grad = d1 - Q @ b
            delta = self._solve_H(Q, W, grad)
            gdd = grad @ delta
            b_k = b + lrs * delta
            obj_k = -0.5 * torch.sum(b_k * (b_k @ Q), -1) \
                + self._loglik(y, b_k + F, aux)
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
        loc = b + F
        _, W = self._d1_W(y, loc, aux, self._fisher_det, create_graph)
        half_logdet, L = _CholHalfLogdet.apply(Q + torch.diag(W))
        g = (0.5 * (b @ (Q @ b)) - self._loglik(y, loc, aux) + half_logdet
             - 0.5 * logdetQ)
        return g, L

    def _r_Q(self, Q, aux, F, b, y):
        return Q @ b - self._d1(y, b + F, aux)

    # ------------------------------------------------------------------
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

    def predict(self, pars_orig, aux_pars, y, F, pred_data, a_init=None,
                predict_var=False, predict_cov_mat=False,
                predict_response=False, F_pred=None):
        """Latent (or response) predictions: cross covariances from the
        exact kernel, the training precision from Vecchia
        (PredictLaplaceApproxVecchia). Like the reference it ignores
        vecchia_pred_type."""
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
            Fd = self._to_vecchia(self._F(F))
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
            loc = b + Fd
            a, W = self._d1_W(yd, loc, aux, self._fisher_det, False)
            mu = K_cross.T @ a                          # = K' Q b
            if F_pred is not None:
                mu = mu + self._F(F_pred)
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
                m, vv = self.likelihood.response_mean_var(
                    mu, torch.clamp(var, min=0.0), aux)
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
