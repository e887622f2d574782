"""Combined Vecchia GP + grouped random effects: the Laplace engine over the
joint latent vector [GP at the unique coordinates, grouped effects]
(counterpart of gpboost_tpu/models/vecchia_grouped.py; reference
re_model_template.h:7042-7045 grouped_RE_and_vecchia_GP_, likelihoods.h
FindModePostRandEffCalcMLLVecchia with grouped components).

With both grouped random effects and a Vecchia GP the whole model runs
through the Laplace machinery, exact for a Gaussian likelihood, whose error
variance becomes the likelihood's aux parameter (`gaussian_latent`). The
latent GP lives on the unique coordinates, in first-occurrence order, so
duplicate locations share one latent value. With b = [b_u (n_u, the Vecchia
order of the unique points), b_g (q, the grouped levels)]:

    P(theta) = blockdiag(Q = B' D^-1 B, diag(1 / sigma_j^2)),
    H = P + Z' W Z,   Z = [Z_u | Z_g],   loc = F + Z b,
    nll = 0.5 b' P b - loglik(loc) + 0.5 (log|H| - log|P|).

Z is never formed: Z b is a gather (each row's unique point, each
component's level times its covariate), Z' x a deterministic segment sum
(`SegmentSum` of models/grouped_re.py, no atomics). Data vectors (y, F,
weights) stay in data order; only b_u is in the Vecchia order.

Two formulations, chosen by matrix_inversion_method:

  * "cholesky": H formed densely, (n_u + q)^2. Q from the Vecchia
    pattern's pairs (`PrecisionAssembly` of models/vecchia_laplace.py);
    Z_u' W Z_u is diagonal (a segment sum of W over the rows' unique
    points), Z_u' W Z_g and the cross-component blocks of Z_g' W Z_g are
    segment sums over their occupied (row, level) and (level, level) pairs,
    sorted once on the host and placed at unique positions;
  * "iterative": matrix-free. H v by gathers, segment sums and the
    neighbour bags of ops/neighbor_bags.py; Newton with preconditioned CG;
    log|H| by the exact-congruence SLQ of ops/iterative.py; predictive
    variances by one batched CG over the prediction points. Block
    preconditioners: "vadu" (B'(D^-1 + W_u)B on the GP block with the
    Neumann S_J for B^-1, Jacobi on the grouped block), "ssor" (an SSOR
    sweep over the grouped components, CG_utils.h:977-1078; with one
    grouping it is Jacobi), "diagonal" and "none".

Newton with Armijo backtracking runs as in the port's other Laplace
engines: the 20 step lengths in one batched pass and one host read per
step, which also brings the CG count. Gradients in u and F come from the
implicit-function `_LaplaceNLL` of models/laplace.py through this engine's
hooks (_mode_solve, _g, _r, _adjoint_solve).
"""

import numpy as np
import torch

from ..ops.iterative import (make_slq_logdet_congruence, pcg_batched_it,
                             pcg_it)
from ..ops.neighbor_bags import NeighborBags
from .components import GPComponent
from .gaussian_base import chol
from .gaussian_gp import _dist
from .grouped_re import SegmentSum
from .laplace import DELTA_CONV_MODE, MAXIT_MODE_NEWTON, LaplaceEngineBase
from .vecchia import VecchiaGaussianEngine, _col, require_isotropic
from .vecchia_laplace import (_PC_ALIASES, PrecisionAssembly,
                              VecchiaOperators, _CholHalfLogdet)

_PRECONDITIONERS = ("vadu", "ssor", "diagonal", "none")
_CASTS = {"num_rand_vec_trace": int, "cg_max_num_it": int,
          "cg_delta_conv": float, "seed_rand_vec_trace": int,
          "nsim_var_pred": int,
          # accepted without effect (no pivoted-Cholesky preconditioner here)
          "piv_chol_rank": int}


def _pair_segments(rows, cols, ncols, device):
    """(SegmentSum over the occupied (row, col) pairs, their flat positions
    row * ncols + col, sorted) for per-entry host index arrays."""
    uniq, code = np.unique(rows * ncols + cols, return_inverse=True)
    return (SegmentSum(code, len(uniq), device),
            torch.as_tensor(uniq, device=device))


class VecchiaGroupedLaplaceEngine(VecchiaOperators, LaplaceEngineBase):
    """Laplace NLL, gradients and predictions over the joint [Vecchia GP,
    grouped random effects] latent vector."""

    # prediction data in codes form (gp_model.py `_build_pred_data`)
    wants_codes_pred = True

    def __init__(self, components, num_data, likelihood, num_neighbors=20,
                 vecchia_ordering="random", seed=0, dtype=torch.float64,
                 weights=None, matrix_inversion_method="cholesky",
                 num_rand_vec_trace=50, cg_max_num_it=1000,
                 cg_delta_conv=1e-6, seed_rand_vec_trace=1,
                 nsim_var_pred=500, cg_preconditioner_type="vadu", *,
                 device):
        gp_comps = [c for c in components if c.kind == "gp"]
        g_comps = [c for c in components if c.kind == "grouped"]
        if len(gp_comps) != 1 or gp_comps[0].z is not None:
            raise NotImplementedError(
                "gp_approx='vecchia' with grouped random effects requires "
                "exactly one GP component without random coefficients")
        if getattr(likelihood, "num_sets_fe", 1) == 2 \
                or getattr(likelihood, "num_sets_re", 1) == 2:
            raise NotImplementedError(
                "two-predictor likelihoods are not supported with "
                "gp_approx='vecchia' plus grouped random effects")
        self._init_common(likelihood, num_data, dtype, device, weights)
        dev = self.device
        n = self.n
        # parameters in the components' order: grouped variances first,
        # then the GP's (the exact engine's layout)
        self.components = list(components)
        self.par_offsets, off, self._gp_off = [], 0, None
        for c in self.components:
            self.par_offsets.append(off)
            if c.kind == "gp":
                self._gp_off = off
            off += c.num_cov_par
        self.num_theta = self.num_cov_par = off
        self.num_par = self.num_theta + self.num_aux

        # the latent GP on the unique coordinates in first-occurrence order
        # (the reference's duplicate detection keeps data order,
        # GP_utils.h:26): row i maps to unique point data_to_u[i]
        gp = gp_comps[0]
        u_coords, first_idx, data_to_u = np.unique(
            gp.coords, axis=0, return_index=True, return_inverse=True)
        order = np.argsort(first_idx)
        u_coords = u_coords[order]
        remap = np.empty(len(order), dtype=np.int64)
        remap[order] = np.arange(len(order))
        data_to_u = remap[data_to_u.ravel()]
        self.n_u = nu = len(u_coords)
        self._vecchia = VecchiaGaussianEngine(
            [GPComponent(u_coords, gp.cov_fn, name=gp.name)], nu,
            num_neighbors=min(int(num_neighbors), nu - 1),
            vecchia_ordering=vecchia_ordering, seed=seed, dtype=dtype,
            device=dev)
        self.comp = self._vecchia.comp
        self.perm = self._vecchia.perm
        inv_perm = np.empty(nu, dtype=np.int64)
        inv_perm[self.perm] = np.arange(nu)
        # data row -> position of its unique point in the Vecchia order
        self._row_pos = inv_perm[data_to_u]
        self._row_pos_d = torch.as_tensor(self._row_pos, device=dev)
        self._seg_u = SegmentSum(self._row_pos, nu, dev)

        # each grouped component as level codes and values (the slope
        # covariate for a random coefficient, re_comp.h:227)
        q_sizes = [c.num_groups for c in g_comps]
        self.q_total = q = int(sum(q_sizes))
        self.dim_mode = nu + q
        g_codes = [np.asarray(c.group_codes, dtype=np.int64)
                   for c in g_comps]
        g_vals = [np.ones(n) if c.z is None
                  else np.asarray(c.z, dtype=np.float64) for c in g_comps]
        # each component's first column in the grouped block
        self._g_cols = [int(c0) for c0 in
                        np.concatenate([[0], np.cumsum(q_sizes)])[:-1]]
        # per component: its latent columns of the rows, values, codes,
        # segment sum, first column and size
        self._gz = [(torch.as_tensor(nu + c0 + cd, device=dev), self._t(v),
                     torch.as_tensor(cd, device=dev),
                     SegmentSum(cd, qj, dev), c0, qj)
                    for cd, v, c0, qj in zip(g_codes, g_vals, self._g_cols,
                                             q_sizes)]
        self._gvar_of_col = torch.as_tensor(
            np.repeat(np.arange(len(q_sizes)), q_sizes), device=dev)

        self.matrix_inversion_method = matrix_inversion_method
        self._cg_acc = None
        self._slq_fn = None
        self._prior_cache = None
        self.set_iterative_params(
            num_rand_vec_trace=num_rand_vec_trace,
            cg_max_num_it=cg_max_num_it, cg_delta_conv=cg_delta_conv,
            seed_rand_vec_trace=seed_rand_vec_trace,
            nsim_var_pred=nsim_var_pred,
            cg_preconditioner_type=cg_preconditioner_type)
        if matrix_inversion_method == "iterative":
            self._nb = NeighborBags(self._vecchia._nn_idx_np, dev)
        else:
            self._q_asm = PrecisionAssembly(self._vecchia, dev)
            # Z_u' W Z_g: the occupied (unique point, level) pairs
            self._h12 = _pair_segments(
                np.tile(self._row_pos, len(q_sizes)),
                np.concatenate([c0 + cd for cd, c0 in
                                zip(g_codes, self._g_cols)]),
                q, dev) if q else None
            # the cross-component blocks of Z_g' W Z_g, j < k
            self._h22 = []
            for j in range(len(q_sizes)):
                for k in range(j + 1, len(q_sizes)):
                    seg, pos = _pair_segments(
                        self._g_cols[j] + g_codes[j],
                        self._g_cols[k] + g_codes[k], q, dev)
                    self._h22.append((j, k, seg, pos,
                                      (pos % q) * q + pos // q))

    def set_iterative_params(self, **kw):
        """The CG / SLQ settings of the iterative formulation:
        num_rand_vec_trace, cg_max_num_it, cg_delta_conv,
        seed_rand_vec_trace, nsim_var_pred and cg_preconditioner_type
        ('vadu' or its alias 'Sigma_inv_plus_BtWB', 'ssor', 'diagonal' or
        its alias 'jacobi', 'none'; another raises ValueError on the
        iterative formulation, which reads it)."""
        for k, v in kw.items():
            if k == "cg_preconditioner_type":
                pc = _PC_ALIASES.get(v, v)
                if pc not in _PRECONDITIONERS \
                        and self.matrix_inversion_method == "iterative":
                    raise ValueError(
                        f"cg_preconditioner_type '{pc}' is not supported "
                        "for grouped REs + Vecchia GP; use 'vadu' "
                        "(Sigma_inv_plus_BtWB), 'ssor', 'diagonal' or "
                        "'none'")
                self.cg_preconditioner_type = pc
            elif k in _CASTS:
                setattr(self, k, _CASTS[k](v))
            else:
                raise ValueError(f"unknown iterative setting '{k}'")
        self._slq_fn = None

    # ------------------------------------------------------------------
    # Z and the prior precision; v is (N,) or columns (N, k)
    def _Z(self, b):
        """Z b: each row's unique point plus each component's level times
        its value, by gathers; (n,) or (n, k)."""
        loc = b.index_select(0, self._row_pos_d)
        for cols, vals, *_ in self._gz:
            loc = loc + _col(vals, loc) * b.index_select(0, cols)
        return loc

    def _Zt(self, x):
        """Z' x by segment sums; (N,) or (N, k)."""
        parts = [self._seg_u(x)]
        for _, vals, _, seg, _, _ in self._gz:
            parts.append(seg(_col(vals, x) * x))
        return torch.cat(parts)

    def _zgwzg_diag(self, W):
        """diag(Z_g' W Z_g), per component a segment sum of v^2 W."""
        return torch.cat([seg(vals * vals * W)
                          for _, vals, _, seg, _, _ in self._gz]) \
            if self._gz else W.new_zeros(0)

    def _split_u(self, u):
        nt = self.num_theta
        return u[:nt], torch.exp(u[nt:])

    def _theta_split(self, theta_log):
        """(grouped log-variances (G,), the GP's [log v, log alphas])."""
        gvars = torch.stack([theta_log[o] for o, c in zip(
            self.par_offsets, self.components) if c.kind == "grouped"]) \
            if self.q_total else theta_log.new_zeros(0)
        return gvars, theta_log[self._gp_off:
                                self._gp_off + self.comp.num_cov_par]

    def _prior(self, theta_log):
        """(P, log|P|): P = (Q, prior_dg) on the dense path, (A, D,
        prior_dg) on the matrix-free one; prior_dg the grouped block's
        diagonal 1 / sigma_j^2."""
        gvars_log, gp_log = self._theta_split(theta_log)
        A, D = self._vecchia._bd(gp_log, latent=True)
        prior_dg = torch.exp(-gvars_log).index_select(0, self._gvar_of_col)
        logdet = torch.sum(torch.log(prior_dg)) - torch.sum(torch.log(D))
        if self.matrix_inversion_method == "iterative":
            return (A, D, prior_dg), logdet
        return (self._q_asm(A, D), prior_dg), logdet

    def _Qv_of(self, P, v):
        if self.matrix_inversion_method == "iterative":
            return self._Qv(P[0], P[1], v)
        return P[0] @ v

    def _Pv(self, P, v):
        """P v."""
        nu = self.n_u
        return torch.cat([self._Qv_of(P, v[:nu]),
                          _col(P[-1], v) * v[nu:]])

    # ------------------------------------------------------------------
    # the dense joint H
    def _H(self, P, W):
        """H = P + Z' W Z, dense (N, N)."""
        Q, prior_dg = P
        nu, q = self.n_u, self.q_total
        H11 = Q + torch.diag(self._seg_u(W))
        if not q:
            return H11
        seg, pos = self._h12
        H12 = W.new_zeros(nu * q).index_put(
            (pos,), seg(torch.cat([vals * W for _, vals, *_ in self._gz])))
        H12 = H12.reshape(nu, q)
        H22 = torch.diag(prior_dg + self._zgwzg_diag(W)).reshape(-1)
        for j, k, seg, pos, mirror in self._h22:
            vals = seg(self._gz[j][1] * self._gz[k][1] * W)
            H22 = H22.index_put((pos,), vals).index_put((mirror,), vals)
        return torch.cat([torch.cat([H11, H12], 1),
                          torch.cat([H12.T, H22.reshape(q, q)], 1)])

    # ------------------------------------------------------------------
    # the matrix-free H, its preconditioners and its log-determinant;
    # p = (A, D, prior_dg, W)
    def _Hv(self, p, v):
        """(P + Z' W Z) v by gathers and segment sums."""
        A, D, prior_dg, W = p
        nu = self.n_u
        zv = self._Z(v)
        t = self._Zt(_col(W, zv) * zv)
        return torch.cat([self._Qv(A, D, v[:nu]) + t[:nu],
                          _col(prior_dg, v) * v[nu:] + t[nu:]])

    def _block_diags(self, p):
        """(diag of the GP block's vadu middle D^-1 + W_u, diag of the
        grouped block), W_u the segment sum of W over duplicate rows."""
        A, D, prior_dg, W = p
        d_gp = torch.clamp(1.0 / D + self._seg_u(W), min=1e-10)
        d_g = torch.clamp(prior_dg + self._zgwzg_diag(W), min=1e-10)
        return d_gp, d_g

    def _ssor(self, W, d_g, r):
        """The SSOR sweep (D + L) D^-1 (D + L)' over the grouped
        components, L the cross-component blocks Z_i' W Z_j as gather and
        segment-sum pairs (CG_utils.h:977-1078 P_SSOR); one component
        gives Jacobi. r (q,) or (q, k)."""
        gz = self._gz
        K = len(gz)

        def sweep(rhs_of, order):
            x, acc = [None] * K, None
            for j in order:
                _, vals, codes, seg, c0, qj = gz[j]
                rhs = rhs_of(j)
                if acc is not None:
                    rhs = rhs - seg(_col(vals, acc) * acc)
                x[j] = rhs / _col(d_g[c0:c0 + qj], rhs)
                if j != order[-1]:
                    t = _col(W * vals, rhs) * x[j].index_select(0, codes)
                    acc = t if acc is None else acc + t
            return x

        y = sweep(lambda j: r[gz[j][4]:gz[j][4] + gz[j][5]], range(K))
        z = [y[j] * _col(d_g[gz[j][4]:gz[j][4] + gz[j][5]], y[j])
             for j in range(K)]
        return torch.cat(sweep(lambda j: z[j], range(K - 1, -1, -1)))

    def _precond(self, p):
        """r -> M^-1 r for the engine's preconditioner (None: none)."""
        pc = self.cg_preconditioner_type
        if pc == "none":
            return None
        A, D, prior_dg, W = p
        d_gp, d_g = self._block_diags(p)
        nu = self.n_u
        if pc == "diagonal":
            pd = torch.cat([self._diag_Q(A, D) + d_gp - 1.0 / D, d_g])
            return lambda r: r / _col(pd, r)

        def apply(r):
            gp = self._SJ(A, self._SJt(A, r[:nu]) / _col(d_gp, r))
            rg = r[nu:]
            g = self._ssor(W, d_g, rg) if pc == "ssor" \
                else rg / _col(d_g, rg)
            return torch.cat([gp, g])

        return apply

    def _m_apply(self, p, v):
        """M v, M = blockdiag(S_J d_gp^-1/2, d_g^-1/2) (the SLQ
        congruence)."""
        d_gp, d_g = self._block_diags(p)
        nu = self.n_u
        return torch.cat([
            self._SJ(p[0], v[:nu] / _col(torch.sqrt(d_gp), v)),
            v[nu:] / _col(torch.sqrt(d_g), v)])

    def _mt_apply(self, p, w):
        d_gp, d_g = self._block_diags(p)
        nu = self.n_u
        return torch.cat([
            self._SJt(p[0], w[:nu]) / _col(torch.sqrt(d_gp), w),
            w[nu:] / _col(torch.sqrt(d_g), w)])

    def _logdet_m(self, p):
        """-2 log|det M| = sum log d_gp + sum log d_g (det S_J = 1)."""
        d_gp, d_g = self._block_diags(p)
        return torch.sum(torch.log(d_gp)) + torch.sum(torch.log(d_g))

    def _slq(self):
        """log|H| over p by the exact congruence; rebuilt when the probe
        settings change. Its backward's probe solves are the engine's
        preconditioned CG (tol 1e-6, maxit 1000, as the JAX package)."""
        if self._slq_fn is None:
            N = self.dim_mode
            self._slq_fn = make_slq_logdet_congruence(
                self._Hv, self._m_apply, self._mt_apply, self._logdet_m,
                self._precond, N, rank=min(N, 50),
                num_probes=self.num_rand_vec_trace,
                seed=self.seed_rand_vec_trace, dtype=self.dtype,
                device=self.device, count=self._count_cg)
        return self._slq_fn

    # ------------------------------------------------------------------
    # the hooks of LaplaceEngineBase
    def _solve(self, P, W, rhs):
        """(H^-1 rhs, CG iterations): a Cholesky of the dense H (NaN where
        it fails, which the Armijo test rejects), or a preconditioned CG
        whose columns stop on their own."""
        if self.matrix_inversion_method != "iterative":
            L = chol(self._H(P, W))
            x = torch.cholesky_solve(rhs[:, None] if rhs.ndim == 1 else rhs,
                                     L).reshape(rhs.shape)
            return x, torch.zeros((), dtype=torch.int64, device=rhs.device)
        p = P + (W,)
        x, it = pcg_it(lambda v: self._Hv(p, v), rhs,
                       precond=self._precond(p), tol=self.cg_delta_conv,
                       maxit=self.cg_max_num_it)
        self._count_cg(it)
        return x, it.sum()

    def _prior_of(self, u):
        """(P, log|P|, aux) for u without a graph. The forward's mode
        finding and value, and the backward's adjoint solve, see the same
        u (one storage, one version): its P is built once."""
        key = (u.data_ptr(), u._version, u.shape)
        if self._prior_cache is None or self._prior_cache[0] != key:
            theta_log, aux = self._split_u(u)
            # u itself is kept, so its storage cannot be reused
            self._prior_cache = (key, u, *self._prior(theta_log), aux)
        return self._prior_cache[2:]

    def _mode_solve(self, u, F, y, b_init):
        """(mode, (Newton steps, CG iterations))."""
        with torch.no_grad():
            P, _, aux = self._prior_of(u)
            return self._newton(P, aux, F, y, b_init)

    def _newton(self, P, aux, F, y, b):
        """Newton with Armijo backtracking on H from b: the 20 step
        lengths in one batched pass, one host read per step (which also
        brings the CG count)."""
        obj = -0.5 * (b @ self._Pv(P, b)) + self._loglik(y, self._Z(b) + F,
                                                        aux)
        lrs = self._lrs[:, None]
        cg = torch.zeros((), dtype=torch.int64, device=self.device)
        it = ncg = 0
        while it < MAXIT_MODE_NEWTON:
            d1, W = self._d1_W(y, self._Z(b) + F, aux, self._fisher_mode,
                               False)
            grad = self._Zt(d1) - self._Pv(P, b)
            delta, cg_it = self._solve(P, W, grad)
            cg = cg + cg_it
            gdd = grad @ delta
            bk = (b + lrs * delta).T                     # (N, 20)
            obj_k = -0.5 * torch.sum(bk * self._Pv(P, bk), 0) \
                + self._loglik(y, self._Z(bk).T + F, aux)
            k = self._armijo(obj_k, obj, gdd)
            b_new, obj_new = self._pick(k, bk.T, obj_k)
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
        if torch.is_grad_enabled() and u.requires_grad:
            theta_log, aux = self._split_u(u)
            P, logdet_p = self._prior(theta_log)
        else:
            P, logdet_p, aux = self._prior_of(u)
        loc = self._Z(b) + F
        _, W = self._d1_W(y, loc, aux, self._fisher_det, create_graph)
        if self.matrix_inversion_method == "iterative":
            half_logdet_h = 0.5 * self._slq()(*P, W, value=value)
        else:
            half_logdet_h = _CholHalfLogdet.apply(self._H(P, W))[0]
        return (0.5 * (b @ self._Pv(P, b)) - self._loglik(y, loc, aux)
                + half_logdet_h - 0.5 * logdet_p)

    def _r(self, u, F, b, y):
        theta_log, aux = self._split_u(u)
        P, _ = self._prior(theta_log)
        return self._Pv(P, b) - self._Zt(self._d1(y, self._Z(b) + F, aux))

    def _d1_W_at(self, aux, F, b, y):
        """(d1, W) at the mode, W the determinant's curvature."""
        return self._d1_W(y, self._Z(b) + F, aux, self._fisher_det, False)

    def _adjoint_solve(self, u, F, b, y, g_b):
        """H^-1 g_b at the mode, W the determinant's curvature."""
        with torch.no_grad():
            P, _, aux = self._prior_of(u)
            _, W = self._d1_W_at(aux, F, b, y)
            return self._solve(P, W, g_b)[0]

    # ------------------------------------------------------------------
    # parameter transforms: grouped variances pass through, the GP's
    # ranges take its kernel's transform
    def transform_pars(self, pars_orig):
        out = np.array(pars_orig, dtype=np.float64)
        o, k = self._gp_off, self.comp.num_cov_par
        out[o + 1:o + k] = np.atleast_1d(self.comp.cov_fn.range_to_transformed(
            out[o + 1:o + k], var=out[o]))
        return out

    def back_transform_pars(self, pars_internal):
        out = np.array(pars_internal, dtype=np.float64)
        o, k = self._gp_off, self.comp.num_cov_par
        out[o + 1:o + k] = np.atleast_1d(
            self.comp.cov_fn.range_from_transformed(out[o + 1:o + k],
                                                    var=out[o]))
        return out

    def training_re(self, u, a_state, predict_var=False):
        """Posterior (Laplace) means at the training points, one column per
        component in the components' order (grouped first, then the GP),
        as PredictTrainingDataRandomEffects (re_model_template.h:4420); a
        random slope reports the latent coefficient."""
        if predict_var:
            raise ValueError(
                "predict_training_data_random_effects with predict_var=True "
                "is not implemented for gp_approx='vecchia' with grouped "
                "random effects; use predict()")
        with torch.no_grad():
            cols = [a_state.index_select(0, gcols)
                    for gcols, *_ in self._gz]
            cols.append(a_state.index_select(0, self._row_pos_d))
            return self._host(torch.stack(cols, 1))[0], None

    # ------------------------------------------------------------------
    def _pred_grouped(self, pred_data, gvars, n_pred, cov):
        """The grouped part of the prediction: Z_p' (q, n_pred) over the
        levels seen in training, and the prior variance of the new levels
        (a matrix with cov, else its diagonal), shared by the prediction
        rows with the same new level."""
        q = self.q_total
        Zpt = np.zeros((q, n_pred))
        new = np.zeros((n_pred, n_pred) if cov else n_pred)
        jg = 0
        for pd_c, c in zip(pred_data["comps"], self.components):
            if c.kind != "grouped":
                continue
            codes = np.asarray(pd_c["codes_pred"])
            z = pd_c.get("z_pred")
            vals = np.ones(n_pred) if z is None \
                else np.asarray(z, dtype=np.float64)
            old = codes < c.num_groups
            Zpt[self._g_cols[jg] + codes[old], np.flatnonzero(old)] = \
                vals[old]
            newm = ~old
            if cov:
                same = (codes[:, None] == codes[None, :]) \
                    & np.outer(newm, newm)
                new += gvars[jg] * same * np.outer(vals, vals)
            else:
                new += gvars[jg] * newm * vals * vals
            jg += 1
        return self._t(Zpt), self._t(new)

    def predict(self, pars_orig, aux_pars, y, F, pred_data, a_init=None,
                predict_var=False, predict_cov_mat=False,
                predict_response=False, F_pred=None):
        """Joint latent predictions (PredictLaplaceApproxVecchia with the
        grouped components): the GP part from exact cross-covariances
        against the ordered unique points and the Vecchia precision, the
        grouped part from the levels' posterior; new levels add their
        prior variance only. The mean is K' Z_u' d1 + Z_p b_g (the mode
        condition Q b_u = Z_u' d1), the covariance

            K_pp - K' Q K + U' H^-1 U + new-level priors,  U = [Q K; Z_p'],

        with H^-1 U from the dense factor (an LU where W can be negative)
        or from one batched CG over the prediction points."""
        require_isotropic(self.comp.cov_fn,
                          "the combined Vecchia + grouped engine's prediction")
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        u = self._u_from_pars(pars_orig, aux_pars, y)
        o = self._gp_off
        gvars = np.asarray([pars_orig[off] for off, c in zip(
            self.par_offsets, self.components) if c.kind == "grouped"])
        cp = np.asarray(next(pd["coords_pred"] for pd, c in zip(
            pred_data["comps"], self.components) if c.kind == "gp"),
            dtype=np.float64)
        if cp.ndim == 1:
            cp = cp[:, None]
        n_pred = len(cp)
        want_cov = predict_var or predict_cov_mat or predict_response
        nu = self.n_u
        with torch.no_grad():
            ud = self._t(u)
            theta_log, aux = self._split_u(ud)
            yd, Fd = self.prep_y(y), self._F(F)
            if a_init is None:
                a_init = self.zero_mode()
            P, _ = self._prior(theta_log)
            b, nit = self._newton(P, aux, Fd, yd, a_init)
            self._note_it(nit)
            v = float(pars_orig[o])
            alphas = torch.exp(theta_log[o + 1:o + self.comp.num_cov_par])
            cf = self.comp.cov_fn
            K = v * cf.corr_from_dist(_dist(self._vecchia.coords_ord, cp,
                                            self.dtype, self.device), alphas)
            Zpt, new = self._pred_grouped(pred_data, gvars, n_pred,
                                          predict_cov_mat)
            d1, W = self._d1_W_at(aux, Fd, b, yd)
            mu = K.T @ self._seg_u(d1) + Zpt.T @ b[nu:]
            if F_pred is not None:
                mu = mu + self._F(F_pred)
            var = cov = None
            if want_cov:
                QK = self._Qv_of(P, K)
                U = torch.cat([QK, Zpt])
                HU = self._solve_pred(P, W, U)
                if predict_cov_mat:
                    K_pp = v * cf.corr_from_dist(
                        _dist(cp, cp, self.dtype, self.device), alphas)
                    cov = K_pp - K.T @ QK + U.T @ HU + new
                    var = torch.diagonal(cov)
                else:
                    k_pp = v * cf.corr_from_dist(
                        torch.zeros(n_pred, dtype=self.dtype,
                                    device=self.device), alphas)
                    var = k_pp - torch.sum(K * QK, 0) \
                        + torch.sum(U * HU, 0) + new
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

    def _solve_pred(self, P, W, U):
        """H^-1 U for the prediction's columns U (N, n_pred)."""
        if self.matrix_inversion_method != "iterative":
            H = self._H(P, W)
            if self.likelihood.W_may_be_negative:
                LU, piv = torch.linalg.lu_factor(H)
                return torch.linalg.lu_solve(LU, piv, U)
            return torch.cholesky_solve(U, chol(H))
        p = P + (W,)
        X, it = pcg_batched_it(lambda V: self._Hv(p, V), U.T,
                               precond=self._precond(p),
                               tol=self.cg_delta_conv,
                               maxit=self.cg_max_num_it)
        self._count_cg(it)
        return X.T
