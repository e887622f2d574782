"""Vecchia approximation engine, Gaussian likelihood, response scale
(counterpart of gpboost_tpu/models/vecchia.py).

Sigma^-1 ~= B' D^-1 B with B = I - A unit lower triangular and at most m
off-diagonals per row, conditioning on nearest preceding neighbours in the
ordering ("random", "none", "time" or "time_random_space"). The ordering and
the neighbour search are the reference's host numpy / cKDTree code (or the
shared native search at n >= 20k without clusters), so both packages
condition on the same sets. With cluster_ids the search runs per cluster
(independent realizations: no conditioning set crosses a cluster).

Device layout: the (n, m) neighbour indices, masks and the theta-independent
neighbour distances live on the engine's device; each NLL evaluation is a
batch of (m, m) correlation matrices -> batched Cholesky solves -> masked
reductions, differentiated by torch.autograd through the custom-VJP solve of
ops/batched_chol.py. Observation weights w make the nugget of row i
sigma2 / w_i, on the conditioning sets' diagonals and on D.

Prediction (CalcPredVecchia*, Vecchia_utils.h:479-588), all batched on the
device:
  * "order_obs_first_cond_obs_only" (aliases "order_pred_first",
    "latent_order_obs_first_cond_obs_only"): each prediction point
    conditions on its k nearest observed points;
  * "order_obs_first_cond_all": joint Vecchia over [obs; pred], the
    predictive distribution N(-Lam_pp^-1 Lam_po y, Lam_pp^-1) with dense
    p x p matrices;
  * "latent_order_obs_first_cond_all": Vecchia on the latent process over
    [obs; pred], its posterior precision B'D^-1 B + blockdiag(I_n, 0)
    solved by Jacobi-preconditioned CG (tol 1e-8 relative to ||b||, at most
    1000 iterations, every column until all have converged). B' u is a
    weighted `embedding_bag` sum over the joint pattern's transpose, sorted
    once on the host: no atomics, so two launches give the same bits.
As in the reference, weights support only the first, clusters no
prediction, and latent variances at most 2,000 points; Fisher scoring and
Newton raise. A device mesh raises NotImplementedError.

Every kernel of ops/cov_fcts.py runs here: an isotropic one from the
precomputed neighbour distances, an anisotropic one (ARD, space-time)
from precomputed coordinate differences scaled by its ranges, a
coordinate-pair one (space_time_gneiting, hurst, linear, AR1
multifidelity, whose search skips the fidelity column) from the
neighbours' coordinates, with the non-stationary prior variances on D.
`redetermine_neighbors` searches again in the range-scaled space of an
anisotropic kernel and rebuilds what derives from the sets.
"""

import math
import os

import numpy as np
import torch

from .gaussian_base import GaussianEngineBase, chol
from ..ops.batched_chol import cho_solve_batched
from ..ops.cov_fcts import _safe_sqrt, pointwise_corr
from ..ops.iterative import _cg
from ..ops.neighbor_bags import bag_sums

LATENT_CG_TOL = 1e-8
LATENT_CG_MAXIT = 1000
LATENT_VAR_MAX_POINTS = 2000
# from this many points the neighbour search runs in chunks
CHUNKED_SEARCH_MIN_N = 20000
_COND_OBS_TYPES = ("order_obs_first_cond_obs_only", "order_pred_first",
                   "latent_order_obs_first_cond_obs_only")


def _corr_sets(cov_fn, cn, ci, alphas):
    """Batched neighbour-set correlations (corr_nn (B, k, k), corr_ni (B, k))
    between each row's neighbour coords cn (B, k, d) and its own point
    ci (B, d) (vecchia.py:37-66): `pointwise_corr`, which folds an
    anisotropic kernel's ranges into the coordinate differences (identical
    points stay exactly zero, so _safe_sqrt's zero-gradient guard holds)
    and evaluates a coordinate-pair kernel from the coordinates."""
    return (pointwise_corr(cov_fn, cn[:, :, None, :], cn[:, None, :, :],
                           alphas),
            pointwise_corr(cov_fn, cn, ci[:, None, :], alphas))


def _point_var(cov_fn, v, ci, alphas):
    """The prior variance at each point ci (B, d): v, or for the
    non-stationary kernels (hurst, linear, AR1; cov_fcts.h
    variance_on_the_diagonal_ = false) v k(ci, ci)."""
    if cov_fn.needs_coords:
        return v * cov_fn.corr_pointwise(ci, ci, alphas)
    return v


def require_isotropic(cov_fn, what):
    """Raise NotImplementedError for a non-isotropic kernel where the JAX
    package evaluates only distances (its Vecchia-Laplace and combined
    engines' predictions and the pivoted-Cholesky preconditioner:
    vecchia_laplace.py:392-393, :596; vecchia_grouped.py:897-995)."""
    if not cov_fn.is_isotropic:
        raise NotImplementedError(
            f"{what} takes isotropic covariance functions only (as the "
            f"JAX package); '{cov_fn.cov_fct_type}' is not")


def _col(d, v):
    """d (n,) broadcast against v (n,) or columns (n, k)."""
    return d if v.ndim == 1 else d[:, None]


def nearest_preceding_neighbors(coords, m, clusters=None):
    """Neighbour indices among preceding points in the ordering (a copy of
    the reference's host search, vecchia.py:77).

    With `clusters`, candidates are restricted to the row's own cluster:
    the search runs per cluster on its sub-coordinates (global order kept
    within each cluster) and local indices map back to global positions.

    Exact kNN via cKDTree over doubling batches: for the batch [s, 2s) a tree
    on points [0, 2s) is queried with an over-allocation factor and indices
    >= i are filtered out; rare rows fall back to a brute-force pass.

    From n = 20,000 (where the reference switches to its native 2-D search)
    the chunked search below finds the same sets.

    Returns (idx (n, m) int64, mask (n, m) bool). Rows without a preceding
    neighbour are padded with the row's own index, masked out.
    """
    from scipy.spatial import cKDTree
    n = len(coords)
    if clusters is not None:
        clusters = np.asarray(clusters)
        idx = np.tile(np.arange(n)[:, None], (1, m))
        mask = np.zeros((n, m), dtype=bool)
        for c in np.unique(clusters):
            sel = np.flatnonzero(clusters == c)
            sub_idx, sub_mask = nearest_preceding_neighbors(coords[sel], m)
            idx[sel] = sel[sub_idx]
            mask[sel] = sub_mask
        return idx, mask
    if n >= CHUNKED_SEARCH_MIN_N:
        return _nearest_preceding_chunked(coords, m)
    idx = np.zeros((n, m), dtype=np.int64)
    mask = np.zeros((n, m), dtype=bool)
    s = 1
    while s < n:
        e = min(2 * s, n)
        tree = cKDTree(coords[:e])
        k_query = min(e, 4 * m + 8)
        _, cand = tree.query(coords[s:e], k=k_query)
        cand = np.atleast_2d(cand)
        for r in range(s, e):
            row = cand[r - s]
            valid = row[row < r][:m]
            if len(valid) < min(m, r):
                d2 = ((coords[:r] - coords[r]) ** 2).sum(-1)
                k = min(m, r)
                valid = np.argpartition(d2, k - 1)[:k] if k < r else np.arange(r)
                valid = valid[np.argsort(d2[valid], kind="stable")]
            k = len(valid)
            idx[r, :k] = valid
            mask[r, :k] = True
            idx[r, k:] = r
        s = e
    idx[0, :] = 0
    return idx, mask


def _nearest_preceding_chunked(coords, m, chunk=1024):
    """The m nearest preceding points of every row, exactly, in chunks of
    rows: a cKDTree on all rows before the chunk gives each row's m
    nearest there, a dense distance block the m nearest of the chunk's
    own preceding rows, and the m smallest of the two (by a stable sort
    of the distances) are the row's set. The doubling search above falls
    back to a brute-force pass over all preceding rows for a row whose
    over-query finds too few of them, which the time orderings make the
    rule (space-time data at n = 100,000: 50 s against 5.5 s on one CPU
    core); the sets are the same, up to the order of equidistant points.
    The chunks are independent and run on a thread pool (numpy and
    cKDTree release the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor
    n = len(coords)
    idx = np.zeros((n, m), dtype=np.int64)
    mask = np.zeros((n, m), dtype=bool)
    upper = np.triu(np.ones((chunk, chunk), dtype=bool))
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        for f in [ex.submit(_chunk_neighbors, coords, m, a,
                            min(a + chunk, n), upper, idx, mask)
                  for a in range(0, n, chunk)]:
            f.result()
    idx[0, :] = 0
    return idx, mask


def _chunk_neighbors(coords, m, a, b, upper, idx, mask):
    """Rows [a, b) of `_nearest_preceding_chunked`, written into idx and
    mask."""
    from scipy.spatial import cKDTree
    q, c = coords[a:b], b - a
    D = np.zeros((c, c))
    for k in range(coords.shape[1]):
        diff = q[:, None, k] - q[None, :, k]
        D += diff * diff
    np.sqrt(D, out=D)
    D[upper[:c, :c]] = np.inf
    kw = min(m, c)
    part = np.argpartition(D, kw - 1, axis=1)[:, :kw]
    cand_d, cand_i = [np.take_along_axis(D, part, 1)], [a + part]
    if a:
        k1 = min(m, a)
        d1, i1 = cKDTree(coords[:a]).query(q, k=k1)
        cand_d.append(d1.reshape(c, k1))
        cand_i.append(i1.reshape(c, k1))
    cd, ci = np.concatenate(cand_d, 1), np.concatenate(cand_i, 1)
    order = np.argsort(cd, axis=1, kind="stable")[:, :m]
    ok = np.isfinite(np.take_along_axis(cd, order, 1))
    idx[a:b] = np.where(ok, np.take_along_axis(ci, order, 1),
                        np.arange(a, b)[:, None])
    mask[a:b] = ok


def vecchia_permutation(coords, n, vecchia_ordering, seed):
    """The reference's orderings (vecchia.py:166-177): "none", "random"
    (RandomState(seed)), "time" (stable sort on the first coordinate) and
    "time_random_space" (ties broken by RandomState(seed) jitter)."""
    if vecchia_ordering in ("none", None):
        return np.arange(n)
    if vecchia_ordering == "random":
        return np.random.RandomState(seed).permutation(n)
    if vecchia_ordering == "time":
        return np.argsort(coords[:, 0], kind="stable")
    if vecchia_ordering == "time_random_space":
        key = coords[:, 0] + 1e-12 * np.random.RandomState(seed).rand(n)
        return np.argsort(key, kind="stable")
    raise ValueError(f"vecchia_ordering '{vecchia_ordering}'")


class _JointBags:
    """The Vecchia pattern over [obs; pred] as `embedding_bag` bags: row i's
    slots (m for an observed point, k for a prediction point) for B v, and
    each point's slots of the transposed pattern, sorted once on the host
    (stable, so in slot order), for B'u."""

    def __init__(self, nn_idx, sel, n, device):
        p, k = sel.shape
        m = nn_idx.shape[1]
        flat = np.concatenate([nn_idx.reshape(-1), sel.reshape(-1)])
        rows = np.concatenate([np.repeat(np.arange(n), m),
                               n + np.repeat(np.arange(p), k)])
        order = np.argsort(flat, kind="stable")
        counts = np.bincount(flat, minlength=n + p)
        self.idx = torch.as_tensor(flat, device=device)
        self.offs = torch.as_tensor(
            np.concatenate([np.arange(n) * m, n * m + np.arange(p) * k]),
            device=device)
        self.t_order = torch.as_tensor(order, device=device)
        self.t_rows = torch.as_tensor(rows[order], device=device)
        self.t_offs = torch.as_tensor(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), device=device)

    def a(self, t, w):
        """A t: out[i] = sum over row i's slots of w[r] t[idx[r]]."""
        return bag_sums(t, self.idx, self.offs, w)

    def at(self, t, wt):
        """A' t for wt = w[t_order]."""
        return bag_sums(t, self.t_rows, self.t_offs, wt)


class VecchiaGaussianEngine(GaussianEngineBase):
    """Vecchia-approximated Gaussian marginal NLL, gradients and prediction.

    Parameters enter as float64 numpy on the host; the engine casts them to
    its dtype on its device. Tensor arguments named y are in the engine's
    (permuted) ordering unless a method says otherwise.
    """

    def __init__(self, components, num_data, num_neighbors=20,
                 vecchia_ordering="random", seed=0, dtype=torch.float64,
                 *, device, mesh=None, weights=None, cluster_ids=None):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet for gp_approx='vecchia'")
        if len(components) != 1 or components[0].kind != "gp":
            raise ValueError("gp_approx='vecchia' requires exactly one GP "
                             "component")
        comp = components[0]
        self.comp = comp
        self.components = [comp]
        self.par_offsets = [0]
        self.n = int(num_data)
        self.dtype = dtype
        self.device = torch.device(device)
        self.m = int(min(num_neighbors, self.n - 1))
        self.num_theta = comp.num_cov_par
        self.num_cov_par = self.num_theta + 1
        self.weights = None if weights is None \
            else np.asarray(weights, dtype=np.float64)

        perm = vecchia_permutation(comp.coords, self.n, vecchia_ordering,
                                   seed)
        self.perm = perm
        self.coords_ord = comp.coords[perm]
        self.cluster_ids = None if cluster_ids is None \
            else np.asarray(cluster_ids)
        self._clusters_ord = None if self.cluster_ids is None \
            else self.cluster_ids[perm]
        # ar1 multifidelity: the Euclidean search runs on the spatial
        # coordinates only, the fidelity is no distance axis
        # (vecchia.py:186-191)
        self._search_cols = slice(0, -1) if getattr(
            comp.cov_fn, "cov_fct_type", "").startswith("ar1_mf_") \
            else slice(None)
        # the prediction search's tree and its last result (_knn_obs)
        self._kdtree = self._knn_last = None
        search = self.coords_ord[:, self._search_cols]
        idx = mask = None
        if self.n >= 20000 and search.shape[1] == 2 \
                and self._clusters_ord is None:
            # native cell-bucketed search, as the reference does at this size
            from ..native import nn_preceding_2d
            res = nn_preceding_2d(search, self.m)
            if res is not None:
                idx, mask = res
        if idx is None:
            idx, mask = nearest_preceding_neighbors(
                search, self.m, clusters=self._clusters_ord)
        dev = self.device
        self._perm = torch.as_tensor(perm, device=dev)
        self._eye = torch.eye(self.m, dtype=dtype, device=dev)[None]
        self._coords_d = torch.as_tensor(self.coords_ord, device=dev).to(dtype)
        # per-row inverse weights in the Vecchia order (nugget sigma2 / w_i)
        self._winv = None if self.weights is None else torch.as_tensor(
            1.0 / self.weights[perm], dtype=dtype, device=dev)
        self.last_pred_cg_it = None
        self._set_neighbors(idx, mask)

    def _set_neighbors(self, idx, mask):
        """The neighbour sets and what is derived from them on the device:
        an isotropic kernel's distances among each row's neighbours and to
        the row (theta-independent; vecchia.py:211-222), side by side in
        one (n, m*m + m) tensor so that one kernel call covers both; an
        anisotropic kernel's coordinate differences, likewise side by side
        (n, m*m + m, d); a coordinate-pair kernel's neighbour
        coordinates (n, m, d)."""
        dev, dtype, m = self.device, self.dtype, self.m
        cf = self.comp.cov_fn
        self._nn_idx_np = np.asarray(idx, dtype=np.int64)
        self._nn_idx = torch.as_tensor(self._nn_idx_np, device=dev)
        self._nn_mask = torch.as_tensor(mask, device=dev)
        self._pair_mask = self._nn_mask[:, :, None] & self._nn_mask[:, None, :]
        self._d_all = self._d_nn = self._d_ni = None
        self._diff_all = self._cn = None
        if cf.is_isotropic:
            # computed once on the host in float64
            cn = self.coords_ord[idx]                      # (n, m, d)
            d_nn = np.sqrt(np.maximum(
                ((cn[:, :, None, :] - cn[:, None, :, :]) ** 2).sum(-1), 0.0))
            d_ni = np.sqrt(np.maximum(
                ((cn - self.coords_ord[:, None, :]) ** 2).sum(-1), 0.0))
            self._d_all = torch.as_tensor(np.concatenate(
                [d_nn.reshape(self.n, m * m), d_ni], 1), dtype=dtype,
                device=dev)
            self._d_nn = self._d_all[:, :m * m].view(self.n, m, m)
            self._d_ni = self._d_all[:, m * m:]
        elif cf.needs_coords:
            self._cn = self._coords_d[self._nn_idx]
        else:
            cn = self._coords_d[self._nn_idx]
            self._diff_all = torch.cat(
                [(cn[:, :, None, :] - cn[:, None, :, :]).reshape(
                    self.n, m * m, -1),
                 cn - self._coords_d[:, None, :]], 1)

    def redetermine_neighbors(self, alphas):
        """Re-determine the neighbour sets in the coordinate space scaled by
        the anisotropic ranges alphas (transformed, host numpy)
        (UpdateNearestNeighbors, Vecchia_utils.h:354;
        re_model_template.h:5105; vecchia.py:243-272): True when they
        changed, and then every structure derived from them is rebuilt."""
        cf = self.comp.cov_fn
        if cf.is_isotropic or cf.needs_coords:
            return False
        scale = cf.aniso_scale(torch.as_tensor(
            np.asarray(alphas, dtype=np.float64)),
            self.coords_ord.shape[1]).numpy()
        sc = self._search_cols
        idx, mask = nearest_preceding_neighbors(
            self.coords_ord[:, sc] * scale[sc], self.m,
            clusters=self._clusters_ord)
        if np.array_equal(idx, self._nn_idx_np) \
                and np.array_equal(mask, self._nn_mask.cpu().numpy()):
            return False
        self._set_neighbors(idx, mask)
        return True

    def _train_corr(self, alphas):
        """(corr_nn (n, m, m), corr_ni (n, m)) of the training sets."""
        cf, n, m = self.comp.cov_fn, self.n, self.m
        if cf.is_isotropic:
            c = cf.corr_from_dist(self._d_all, alphas)
        elif cf.needs_coords:
            return _corr_sets(cf, self._cn, self._coords_d, alphas)
        else:
            dd = self._diff_all * cf.aniso_scale(alphas,
                                                 self._diff_all.shape[-1])
            c = cf.base_corr_scaled_dist(_safe_sqrt((dd ** 2).sum(-1)),
                                         alphas)
        return c[:, :m * m].view(n, m, m), c[:, m * m:]

    # ------------------------------------------------------------------
    def prep_y(self, y):
        """y in data order (numpy or tensor) -> engine ordering, dtype and
        device."""
        y = torch.as_tensor(y, device=self.device)
        return y[self._perm].to(self.dtype)

    def _bd(self, theta_log, latent=False):
        """Batched Vecchia factors: A (n, m) coefficients, D (n,) diagonals
        of the response covariance C = v K + diag(1/w), or with latent=True
        of the latent covariance C = v K (no nugget; the Vecchia-Laplace
        precision)."""
        v = torch.exp(theta_log[0])
        alphas = torch.exp(theta_log[1:])
        corr_nn, corr_ni = self._train_corr(alphas)
        K_nn = v * corr_nn
        if not latent:
            if self._winv is None:
                K_nn = K_nn + self._eye
            else:
                # each conditioning set's diagonal carries its rows' 1 / w
                K_nn = K_nn + self._winv[self._nn_idx][:, :, None] * self._eye
        k_ni = v * corr_ni
        # padded neighbours: identity rows/cols in K_nn, zeros in k_ni
        K_nn = torch.where(self._pair_mask, K_nn, self._eye)
        k_ni = torch.where(self._nn_mask, k_ni, torch.zeros_like(k_ni))
        A = cho_solve_batched(K_nn, k_ni)
        # the non-stationary kernels' own prior variances (vecchia.py:303)
        diag_c = _point_var(self.comp.cov_fn, v, self._coords_d, alphas)
        if not latent:
            diag_c = diag_c + (1.0 if self._winv is None else self._winv)
        D = diag_c - torch.sum(A * k_ni, dim=1)
        return A, D

    def _bd_add_diag(self, theta_log, add_diag):
        """Vecchia factors of the latent covariance plus a per-point
        diagonal add_diag (n,), in the engine's order
        (CalcVecchiaApproxLatentAddDiagonal, re_model_template.h: the
        'vecchia_response' preconditioner's factors with pseudo-nugget
        W^-1)."""
        v = torch.exp(theta_log[0])
        alphas = torch.exp(theta_log[1:])
        corr_nn, corr_ni = self._train_corr(alphas)
        K_nn = v * corr_nn + add_diag[self._nn_idx][:, :, None] * self._eye
        K_nn = torch.where(self._pair_mask, K_nn, self._eye)
        k_ni = v * corr_ni
        k_ni = torch.where(self._nn_mask, k_ni, torch.zeros_like(k_ni))
        A = cho_solve_batched(K_nn, k_ni)
        D = _point_var(self.comp.cov_fn, v, self._coords_d, alphas) \
            + add_diag - torch.sum(A * k_ni, dim=1)
        return A, D

    def _B_apply(self, A, V):
        """B V for V (n, k): a gather, no scatter."""
        return V - torch.einsum("nm,nmk->nk", A, V[self._nn_idx])

    def _quad_logdet(self, theta_log, y):
        A, D = self._bd(theta_log)
        z = y - torch.sum(A * y[self._nn_idx], dim=1)          # (B y)_i
        return torch.sum(z * z / D), torch.sum(torch.log(D))

    def _nll_parts(self, theta_log, sigma2, y):
        quad, logdet = self._quad_logdet(theta_log, y)
        n = self.n
        nll = 0.5 * (quad / sigma2 + logdet + n * torch.log(sigma2)
                     + n * math.log(2.0 * math.pi))
        return nll, quad

    def _nll_profiled(self, theta_log, y):
        quad, logdet = self._quad_logdet(theta_log, y)
        n = self.n
        return 0.5 * (logdet + n * torch.log(quad / n) + n
                      + n * math.log(2.0 * math.pi)), quad

    def _wls(self, theta_log, y, X):
        """GLS coefficients by X' Psi~^-1 X = (BX)' D^-1 (BX)."""
        A, D = self._bd(theta_log)
        U = self._B_apply(A, X)
        By = self._B_apply(A, y[:, None])[:, 0]
        Lc = chol(U.T @ (U / D[:, None]))
        return torch.cholesky_solve((U.T @ (By / D))[:, None], Lc)[:, 0]

    def _coef_grad(self, theta_log, sigma2, resid, X):
        A, D = self._bd(theta_log)
        U = self._B_apply(A, X)
        Br = self._B_apply(A, resid[:, None])[:, 0]
        return -(U.T @ (Br / D)) / sigma2

    # the raw differentiable closures for the device L-BFGS (ops/lbfgs.py)
    nll_profiled_raw = _nll_profiled
    wls_coef_raw = _wls

    def fisher_transformed(self, u, include_error_var=True):
        raise NotImplementedError(
            "fisher_scoring is not supported with gp_approx='vecchia'; use "
            "gradient_descent or lbfgs")

    def fisher_original(self, pars_orig):
        """Standard-error Fisher information: the exact dense one as a
        proxy up to n = 4,000, NaN above (as the reference)."""
        if self.n > 4000:
            return np.full((self.num_cov_par, self.num_cov_par), np.nan)
        from .gaussian_gp import DenseGaussianEngine
        return DenseGaussianEngine([self.comp], self.n, dtype=self.dtype,
                                   device=self.device).fisher_original(
                                       pars_orig)

    # ------------------------------------------------------------------
    def psi_tilde_inv_mat(self, pars_internal, M):
        """Psi_tilde^-1 M for M (n, L) in data order, on the device
        (gbdt.py:2422-2434 Vecchia branch): B' D^-1 B M with the factors of
        the response covariance. The Bᵀ scatter is an index_add_, which uses
        atomics on CUDA and so sums in a run-dependent order; in float64
        that moves results by ~1e-16 relative, far inside the tolerances
        that hold the port to the reference."""
        theta_log = self._t(np.log(np.asarray(pars_internal)[1:]))
        with torch.no_grad():
            A, D = self._bd(theta_log)
        A = A.to(M.dtype)
        D = D.to(M.dtype)
        Mp = M[self._perm]                                  # (n, L)
        z = Mp - torch.einsum("nm,nml->nl", A, Mp[self._nn_idx])
        w = z / D[:, None]
        out = w.clone()
        out.index_add_(0, self._nn_idx.reshape(-1),
                       -(A[:, :, None] * w[:, None, :]).reshape(-1, M.shape[1]))
        inv = torch.empty_like(out)
        inv[self._perm] = out
        return inv

    def training_re(self, pars_orig, y_resid, predict_var=False):
        """Posterior mean of the GP at the training points, on the device
        (re_model_template.h:4420): Sigma~ = Psi~ - diag(1/w), so
        mean = Sigma~ Psi~^-1 r = r - diag(1/w) Psi~^-1 r with no dense
        matrix. The variance is not available for Vecchia, as in the
        reference. (With weights the reference's vecchia.py:516 leaves out
        the diag(1/w); the port keeps it, which makes the m = n - 1 result
        equal the dense engine's.)"""
        if predict_var:
            raise ValueError("predict_training_data_random_effects with "
                             "predict_var=True is not implemented for "
                             "gp_approx='vecchia'; use predict() instead")
        t = self.transform_pars(np.asarray(pars_orig, dtype=np.float64))
        with torch.no_grad():
            r = torch.as_tensor(np.asarray(y_resid, dtype=np.float64),
                                device=self.device).to(self.dtype)
            inv = self.psi_tilde_inv_mat(t, r[:, None])[:, 0]
            if self.weights is not None:
                inv = inv / torch.as_tensor(self.weights, dtype=self.dtype,
                                            device=self.device)
            return self._host((r - inv)[:, None])[0], None

    # ------------------------------------------------------------------
    def _knn_obs(self, coords_pred, k):
        """k nearest observed points per prediction point (host cKDTree
        over the observed points, built once; the spatial columns for an
        AR1 multifidelity kernel; in the unscaled coordinates for an
        anisotropic one, as in the JAX package). The search does not depend
        on the parameters: the last one is kept and returned again for the
        same points and k (a validation set, predicted every boosting
        round)."""
        if self._clusters_ord is not None:
            raise NotImplementedError(
                "prediction with cluster_ids under gp_approx='vecchia' is "
                "not implemented (training and the NLL are); predict with "
                "the dense engine (gp_approx='none') for clustered models")
        coords_pred = np.asarray(coords_pred)
        last = self._knn_last
        if last is not None and last[0] == k \
                and np.array_equal(last[1], coords_pred):
            return last[2], last[3]
        sc = self._search_cols
        if self._kdtree is None:
            from scipy.spatial import cKDTree
            self._kdtree = cKDTree(self.coords_ord[:, sc])
        dist, idx = self._kdtree.query(coords_pred[:, sc], k=k)
        p = len(coords_pred)
        self._knn_last = (k, coords_pred.copy(), idx.reshape(p, -1),
                          dist.reshape(p, -1))
        return self._knn_last[2], self._knn_last[3]

    def _joint_neighbors(self, coords_pred, k):
        """Neighbour sets of the prediction points among [obs; preceding
        preds]: global indices (p, k) (>= n marks a prediction point), the
        k nearest of the union of the k nearest observed points and the
        preceding prediction points' search, cut by a stable sort of the
        distances (vecchia.py:544-561; ties keep the candidates' order)."""
        n, p = self.n, len(coords_pred)
        obs_idx, obs_d = self._knn_obs(coords_pred, min(k, n))
        pidx, pmask = nearest_preceding_neighbors(coords_pred,
                                                  min(k, max(p - 1, 1)))
        pd = np.sqrt(((coords_pred[:, None, :]
                       - coords_pred[pidx]) ** 2).sum(-1))
        pd = np.where(pmask, pd, np.inf)
        cand_idx = np.concatenate([obs_idx, pidx + n], axis=1)
        cand_d = np.concatenate([obs_d, pd], axis=1)
        take = np.argsort(cand_d, axis=1, kind="stable")[:, :k]
        rows = np.arange(p)[:, None]
        sel = cand_idx[rows, take]
        valid = np.isfinite(cand_d[rows, take])
        return np.where(valid, sel, 0), valid

    def _pred_sets(self, theta_log, cn, ci, valid, nugget, pad, diag_add):
        """Each prediction row's (k, k) neighbour covariance with `nugget`
        on its diagonal and its cross covariances; returns their solve a
        and the conditional variance v + diag_add - a'k. Invalid slots get
        `pad` times the identity and zero cross covariance."""
        v = torch.exp(theta_log[0])
        alphas = torch.exp(theta_log[1:])
        corr_nn, corr_ni = _corr_sets(self.comp.cov_fn, cn, ci, alphas)
        k = cn.shape[1]
        eye = torch.eye(k, dtype=self.dtype, device=self.device)[None]
        K = v * corr_nn + nugget * eye
        kni = v * corr_ni
        if valid is not None:
            pair = valid[:, :, None] & valid[:, None, :]
            K = torch.where(pair, K, pad * eye)
            kni = torch.where(valid, kni, torch.zeros_like(kni))
        a = cho_solve_batched(K, kni)
        return a, _point_var(self.comp.cov_fn, v, ci, alphas) + diag_add \
            - torch.sum(a * kni, dim=1)

    def _pred_cond_obs(self, theta_log, cn, ci, y_nbr, winv_nbr=None):
        """Conditional mean and variance of each prediction point given its
        k nearest observed points (vecchia.py:563-587); with weights each
        neighbour's nugget is 1 / w."""
        nugget = 1.0 if winv_nbr is None else winv_nbr[:, :, None]
        a, var = self._pred_sets(theta_log, cn, ci, None, nugget, 1.0, 1.0)
        return torch.sum(a * y_nbr, dim=1), var

    def _pred_cond_all(self, theta_log, cn, ci, nbr_y, is_pred, pred_col,
                       valid, want_cov):
        """Joint Vecchia over [obs; pred] (vecchia.py:589-626): with the
        prediction rows of B as [Bp_o, Bp_p], Lam_pp = Bp_p' D^-1 Bp_p and
        Lam_po y = Bp_p' D^-1 (Bp_o y). Bp_p is the identity with -a at the
        (row, preceding prediction point) slots, pairs that are unique:
        set by index_put, no scatter-add."""
        a, D = self._pred_sets(theta_log, cn, ci, valid, 1.0, 1.0, 1.0)
        p = ci.shape[0]
        r = -torch.sum(a * nbr_y, dim=1)                       # Bp_o y
        rows = torch.arange(p, device=self.device)[:, None].expand_as(a)
        Bpp = torch.eye(p, dtype=self.dtype, device=self.device)
        Bpp.index_put_((rows[is_pred], pred_col[is_pred]), -a[is_pred])
        W = Bpp / D[:, None]
        L = chol(Bpp.T @ W)
        mu = -torch.cholesky_solve((W.T @ r)[:, None], L)[:, 0]
        if not want_cov:
            return mu, None, None
        cov = torch.cholesky_solve(
            torch.eye(p, dtype=self.dtype, device=self.device), L)
        return mu, torch.diagonal(cov), cov

    def _pred_latent(self, theta_log, cn, ci, sel, valid, y, want_var):
        """Latent-ordering joint prediction (vecchia.py:628-734): Vecchia
        on the latent process over [obs; pred], posterior precision
        P = B'D^-1 B + blockdiag(I_n, 0), solved by Jacobi-preconditioned
        CG. Returns (mean, variances or None); the CG iteration counts of
        the last solve are kept in `last_pred_cg_it` (a device tensor)."""
        n, dev = self.n, self.device
        v = torch.exp(theta_log[0])
        A_o, D_o = self._bd(theta_log, latent=True)
        A_o = torch.where(self._nn_mask, A_o, torch.zeros_like(A_o))
        a, D_p = self._pred_sets(theta_log, cn, ci, valid, 1e-10 * v, v, 0.0)
        D_p = torch.maximum(D_p, 1e-12 * v)
        p = ci.shape[0]
        Dinv = torch.cat([1.0 / D_o, 1.0 / D_p])
        obs_one = torch.cat([torch.ones(n, dtype=self.dtype, device=dev),
                             torch.zeros(p, dtype=self.dtype, device=dev)])
        bags = _JointBags(self._nn_idx_np, sel, n, dev)
        sel_d = bags.idx[n * self.m:].view(p, -1)
        w = torch.cat([A_o.reshape(-1), a.reshape(-1)])
        wt = w.index_select(0, bags.t_order)

        def B_apply(x):
            if x.ndim == 2:
                return x - bags.a(x, w)
            # one column: gathers and row sums, the reference's order
            return x - torch.cat([torch.sum(A_o * x[self._nn_idx], 1),
                                  torch.sum(a * x[sel_d], 1)])

        def P_apply(x):
            u = _col(Dinv, x) * B_apply(x)
            return u - bags.at(u, wt) + _col(obs_one, x) * x

        diagP = Dinv + obs_one + bags.at(Dinv, (w * w).index_select(
            0, bags.t_order))

        def precond(r):
            return r / _col(diagP, r)

        # _cg's shared-lane rule is the reference's loop (vecchia.py:693-720):
        # every column iterates until all have converged; its guards on
        # alpha and beta act only on a zero search direction
        rhs = torch.cat([y, torch.zeros(p, dtype=self.dtype, device=dev)])
        z, it = _cg(P_apply, rhs, precond, LATENT_CG_TOL, LATENT_CG_MAXIT,
                    None, False)
        self.last_pred_cg_it = it
        if not want_var:
            return z[n:], None
        E = torch.zeros((n + p, p), dtype=self.dtype, device=dev)
        jp = torch.arange(p, device=dev)
        E[n + jp, jp] = 1.0
        Z, it = _cg(P_apply, E, precond, LATENT_CG_TOL, LATENT_CG_MAXIT,
                    None, False)
        self.last_pred_cg_it = it
        return z[n:], Z[n + jp, jp]

    def predict(self, pars_orig, y_resid, pred_data, predict_var=False,
                predict_cov_mat=False, predict_response=False,
                vecchia_pred_type="order_obs_first_cond_obs_only",
                num_neighbors_pred=None):
        """Vecchia predictions for every ordering of the reference
        (vecchia.py:736-839), batched over all prediction points on the
        device; means, variances and covariance matrices as float64
        numpy."""
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        sigma2 = pars_orig[0]
        t = self.transform_pars(pars_orig)
        theta_log = self._t(np.log(t[1:]))
        y_ord = np.asarray(y_resid, dtype=np.float64)[self.perm]
        coords_pred = np.asarray(pred_data["comps"][0]["coords_pred"],
                                 dtype=np.float64)
        if coords_pred.ndim == 1:
            coords_pred = coords_pred[:, None]
        n, n_pred = self.n, len(coords_pred)
        mp = num_neighbors_pred or self.m
        cov = None
        joint = vecchia_pred_type in ("order_obs_first_cond_all",
                                      "latent_order_obs_first_cond_all")
        if vecchia_pred_type not in _COND_OBS_TYPES and not joint:
            raise ValueError(f"vecchia_pred_type '{vecchia_pred_type}'")
        if joint and self._winv is not None:
            raise NotImplementedError(
                "weighted Vecchia predictions currently support "
                "vecchia_pred_type='order_obs_first_cond_obs_only'")
        if vecchia_pred_type in _COND_OBS_TYPES:
            k = min(mp, n)
            nn, _ = self._knn_obs(coords_pred, k)
            with torch.no_grad():
                winv = None if self._winv is None else self._winv[
                    torch.as_tensor(nn, device=self.device)]
                mu, var = self._pred_cond_obs(
                    theta_log, self._t(self.coords_ord[nn]),
                    self._t(coords_pred), self._t(y_ord[nn]), winv)
                mu, var = self._host(mu, var)
            if predict_cov_mat:
                cov = np.diag(var)
        else:
            k = min(mp, n + n_pred - 1)
            sel, valid = self._joint_neighbors(coords_pred, k)
            all_coords = np.vstack([self.coords_ord, coords_pred])
            cn = self._t(all_coords[sel])
            ci = self._t(coords_pred)
            valid_d = torch.as_tensor(valid, device=self.device)
            if vecchia_pred_type == "order_obs_first_cond_all":
                is_pred = (sel >= n) & valid
                nbr_y = np.where(is_pred | ~valid, 0.0,
                                 y_ord[np.minimum(sel, n - 1)])
                pred_col = np.where(is_pred, sel - n, 0)
                want_cov = predict_var or predict_cov_mat
                with torch.no_grad():
                    mu, var, covd = self._pred_cond_all(
                        theta_log, cn, ci, self._t(nbr_y),
                        torch.as_tensor(is_pred, device=self.device),
                        torch.as_tensor(pred_col, device=self.device),
                        valid_d, want_cov)
                    if want_cov:
                        mu, var, cov = self._host(mu, var, covd)
                    else:
                        mu = self._host(mu)[0]
                        var = np.zeros(n_pred)
            else:
                want_var = predict_var or predict_cov_mat
                if want_var and n_pred > LATENT_VAR_MAX_POINTS:
                    raise ValueError(
                        "latent_order_obs_first_cond_all with predict_var "
                        "currently supports up to "
                        f"{LATENT_VAR_MAX_POINTS} prediction points (one CG "
                        "solve per point)")
                with torch.no_grad():
                    mu, var = self._pred_latent(
                        theta_log, cn, ci, sel, valid_d, self._t(y_ord),
                        want_var)
                    if want_var:
                        mu, var = self._host(mu, var)
                        # latent scale: add the nugget for the response
                        var = var + 1.0
                    else:
                        mu = self._host(mu)[0]
                        var = np.zeros(n_pred)
                if predict_cov_mat:
                    cov = np.diag(var)
        # sigma2 cancels in the mean; variances were computed on the
        # nugget-scaled parameterization -> multiply by sigma2
        var = var * sigma2
        if cov is not None:
            cov = cov * sigma2
        if not predict_response:
            var = var - sigma2
            if cov is not None:
                cov = cov - sigma2 * np.eye(n_pred)
        out = {"mu": mu}
        if predict_cov_mat:
            out["cov"] = cov
        if predict_var:
            out["var"] = var
        return out
