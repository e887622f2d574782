"""Iterative methods: preconditioned conjugate gradients (CG) and stochastic
Lanczos quadrature (SLQ) for log-determinants (counterpart of
gpboost_tpu/ops/iterative.py; reference CG_utils.h:42-1078 solvers,
:81-384 CG-tridiagonal log-determinants, :351-370 Rademacher probes).

Everything acts on an abstract SPD operator. A `matvec` (and a `precond`,
r -> P^-1 r) takes a vector of shape (n,) or a batch of columns (n, k) and
returns the same shape; the batched functions run the columns as lanes of
one loop, the way the JAX package vmaps its single-vector loops.

Two batched-CG rules, as there:

  * `pcg` / `pcg_it` on (n, k): every lane stops on its own test
    ||r|| > tol ||b|| (JAX's while_loop under vmap): a converged lane is
    frozen, and its iterates and count are those of a solve alone;
  * `pcg_batched` (rows of B, (k, n)): every lane runs until all have
    converged, with alpha and beta guarded against a degenerate direction.

The JAX loops never leave the device. Here the convergence flags are
computed on the device every iteration, each lane's update is masked by
its flag (`torch.where`), and the host reads "is any lane still running?"
once every `CG_READ_EVERY` iterations: the iterates and counts are those of
a per-iteration test, at one host read per `CG_READ_EVERY` iterations.
The Lanczos and Neumann loops have a fixed length and read nothing.

Probes are the JAX package's: np.random.RandomState(seed).randint(0, 2,
(num_probes, n)) * 2 - 1, so both packages estimate with the same vectors.
The log-determinants and the CG solves carry custom gradients as
torch.autograd.Functions (the JAX custom_vjps): d log|A| = tr(A^-1 dA)
estimated with the same probes and their CG solves, and d(A^-1 b) by one
adjoint solve.
"""

import numpy as np
import torch

CG_READ_EVERY = 4


def _dot(a, b):
    """Per-lane inner products: () for (n,) inputs, (k,) for (n, k)."""
    return (a * b).sum(0)


def _norm(a):
    return torch.linalg.vector_norm(a, dim=0)


def _cg(matvec, b, precond, tol, maxit, x0, own_lanes):
    """The CG loop of both rules; returns (x, per-lane iteration counts)."""
    if precond is None:
        precond = _identity
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = _dot(r, z)
    bnorm = _norm(b)
    thr = tol * bnorm if own_lanes else tol * torch.clamp(bnorm, min=1e-300)
    it = torch.zeros(rz.shape, dtype=torch.int64, device=b.device)
    step = 0
    while True:
        run = _norm(r) > thr
        run = run if own_lanes else run.any()
        run = run & (it < maxit)
        if step % CG_READ_EVERY == 0 and not bool(run.any()):
            break
        step += 1
        Ap = matvec(p)
        pAp = _dot(p, Ap)
        if own_lanes:
            alpha = rz / pAp
        else:
            ok = pAp > 0
            alpha = torch.where(ok, rz / torch.where(ok, pAp, 1.0), 0.0)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = precond(r_n)
        rz_n = _dot(r_n, z)
        if own_lanes:
            beta = rz_n / rz
        else:
            ok = rz > 0
            beta = torch.where(ok, rz_n / torch.where(ok, rz, 1.0), 0.0)
        p_n = z + beta * p
        x = torch.where(run, x_n, x)
        r = torch.where(run, r_n, r)
        p = torch.where(run, p_n, p)
        rz = torch.where(run, rz_n, rz)
        it = it + run.to(torch.int64)
    return x, it


def _identity(v):
    return v


def pcg(matvec, b, precond=None, tol=1e-6, maxit=1000, x0=None):
    """Solve A x = b for SPD A given matvec; optionally P^-1 via precond.
    b (n,) or (n, k): each column stops on its own convergence."""
    return _cg(matvec, b, precond, tol, maxit, x0, True)[0]


def pcg_it(matvec, b, precond=None, tol=1e-6, maxit=1000, x0=None):
    """pcg that also returns the iteration count (a device tensor; per
    column for a batch), the reference's GetNumCGSteps (re_model.h:145)."""
    return _cg(matvec, b, precond, tol, maxit, x0, True)


def pcg_batched(matvec, B, precond=None, tol=1e-6, maxit=1000):
    """Solve A X = B for the rows of B (k, n): one loop over all systems
    that stops when every residual is below tol times its right-hand side's
    norm; converged systems keep iterating with alpha and beta guarded to 0
    on a degenerate direction. matvec and precond act on (n, k) columns."""
    return pcg_batched_it(matvec, B, precond, tol, maxit)[0]


def pcg_batched_it(matvec, B, precond=None, tol=1e-6, maxit=1000):
    """pcg_batched that also returns the per-system iteration counts (a
    device tensor (k,)): the loop's length for every system that still ran
    in it."""
    X, it = _cg(matvec, B.T, precond, tol, maxit, None, False)
    return X.T, it


def lanczos_tridiag(matvec, z, rank):
    """Lanczos tridiagonalisation of A on K_rank(A, z), no
    reorthogonalisation. z (n,) or (n, k); returns (alphas (rank[, k]),
    betas (rank - 1[, k]))."""
    q = z / _norm(z)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros_like(_norm(z))
    alphas, betas = [], []
    for _ in range(rank):
        w = matvec(q) - beta_prev * q_prev
        alpha = _dot(q, w)
        w = w - alpha * q
        beta = _norm(w)
        q_next = torch.where(beta > 1e-12, w / torch.clamp(beta, min=1e-300),
                             q)
        q_prev, q, beta_prev = q, q_next, beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas[:-1])


def _chunks(total, probe_chunk):
    """[(start, end)) column ranges of at most probe_chunk columns."""
    ck = total if probe_chunk is None else max(1, min(int(probe_chunk),
                                                      total))
    return [(s, min(s + ck, total)) for s in range(0, total, ck)]


def _slq_logdet_value(matvec, n, rank, probes, probe_chunk=None):
    """SLQ estimate of log|A| (CG_utils.h:384): the mean over the probe
    columns z of ||z||^2 e1' log(T) e1, T the Lanczos tridiagonal of A on
    K(A, z). probes (n, num_probes); probe_chunk columns run at once."""
    vals = []
    for a, b in _chunks(probes.shape[1], probe_chunk):
        Z = probes[:, a:b]
        alphas, betas = lanczos_tridiag(matvec, Z, rank)
        T = torch.diag_embed(alphas.T) + torch.diag_embed(betas.T, 1) \
            + torch.diag_embed(betas.T, -1)
        evals, evecs = torch.linalg.eigh(T)
        evals = torch.clamp(evals, min=1e-300)
        w = evecs[:, 0, :] ** 2
        vals.append(_dot(Z, Z) * torch.sum(w * torch.log(evals), -1))
    return torch.cat(vals).mean()


def rademacher_probes(n, num_probes, seed, dtype, device):
    """The JAX package's probes, as (n, num_probes) columns."""
    rng = np.random.RandomState(seed)
    P = rng.randint(0, 2, size=(num_probes, n)) * 2.0 - 1.0
    return torch.as_tensor(np.ascontiguousarray(P.T), dtype=dtype,
                           device=device)


class _SLQSpec:
    """What one SLQ log-determinant needs: value(p) (no graph), the matvec
    A(p) v, precond(p) -> (r -> P^-1 r) or None for the backward's probe
    solves, their CG settings, and count(it, maxit) or None, given each
    probe solve's per-column CG iterations."""

    def __init__(self, value, matvec, precond, probes, probe_chunk, cg_tol,
                 cg_maxit, count=None):
        self.value, self.matvec, self.precond = value, matvec, precond
        self.probes, self.probe_chunk = probes, probe_chunk
        self.cg_tol, self.cg_maxit, self.count = cg_tol, cg_maxit, count

    def chunks(self):
        return _chunks(self.probes.shape[1], self.probe_chunk)


class _SLQLogdet(torch.autograd.Function):
    """log|A(p)| with d log|A| = tr(A^-1 dA) ~= mean_z (A^-1 z)' dA z over
    the same probes (P-preconditioned CG solves, each probe on its own
    convergence). With value False the forward returns 0 and skips the
    Lanczos runs: a graph built only for the gradient."""

    @staticmethod
    def forward(ctx, spec, value, *p):
        ctx.spec = spec
        ctx.save_for_backward(*p)
        if not value:
            return p[0].new_zeros(())
        return spec.value(p)

    @staticmethod
    def backward(ctx, ct):
        spec = ctx.spec
        p = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.no_grad():
            pinv = None if spec.precond is None else spec.precond(p)
            solves = []
            for a, b in spec.chunks():
                x, it = pcg_it(lambda v: spec.matvec(p, v),
                               spec.probes[:, a:b], precond=pinv,
                               tol=spec.cg_tol, maxit=spec.cg_maxit)
                solves.append(x)
                if spec.count is not None:
                    spec.count(it, spec.cg_maxit)
        with torch.enable_grad():
            pp = [t.detach().requires_grad_(nd) for t, nd in zip(p, need)]
            live = [t for t, nd in zip(pp, need) if nd]
            grads = [torch.zeros_like(t) for t in live]
            total = spec.probes.shape[1]
            for (a, b), S in zip(spec.chunks(), solves):
                tr = torch.sum(S * spec.matvec(pp, spec.probes[:, a:b])) \
                    / total
                gs = torch.autograd.grad(tr, live, allow_unused=True)
                grads = [g if d is None else g + d
                         for g, d in zip(grads, gs)]
        it = iter(grads)
        return (None, None) + tuple(next(it) * ct if nd else None
                                    for nd in need)


class SLQLogdet:
    """Callable logdet(*p, value=True) over parameter tensors p."""

    def __init__(self, spec):
        self.spec = spec

    def __call__(self, *p, value=True):
        return _SLQLogdet.apply(self.spec, value, *p)


def make_slq_logdet(matvec_of_theta, n, rank=50, num_probes=50, seed=0,
                    dtype=torch.float64, device="cpu"):
    """logdet(theta) ~= log|A(theta)| with the SLQ gradient; probes fixed
    across calls (reuse_rand_vec_trace), backward solves unpreconditioned
    (tol 1e-6, maxit 1000)."""
    probes = rademacher_probes(n, num_probes, seed, dtype, device)

    def matvec(p, v):
        return matvec_of_theta(p[0], v)

    def value(p):
        return _slq_logdet_value(lambda v: matvec(p, v), n, rank, probes)

    return SLQLogdet(_SLQSpec(value, matvec, None, probes, None, 1e-6, 1000))


def make_slq_logdet_precond(matvec_of_p, precond_diag_of_p, n, rank=50,
                            num_probes=50, seed=0, dtype=torch.float64,
                            device="cpu"):
    """Diagonally preconditioned SLQ: log|A| = log|P| + log|P^-1/2 A
    P^-1/2| with P = diag(precond_diag_of_p(p)), the second term by SLQ;
    backward solves Jacobi-preconditioned (tol 1e-6, maxit 1000)."""
    probes = rademacher_probes(n, num_probes, seed, dtype, device)

    def value(p):
        d = precond_diag_of_p(p)
        sqd = torch.sqrt(d)

        def mv(v):
            s = sqd if v.ndim == 1 else sqd[:, None]
            return matvec_of_p(p, v / s) / s

        return _slq_logdet_value(mv, n, rank, probes) + torch.sum(
            torch.log(d))

    def precond(p):
        d = precond_diag_of_p(p)
        return lambda r: r / (d if r.ndim == 1 else d[:, None])

    return SLQLogdet(_SLQSpec(value, matvec_of_p, precond, probes, None,
                              1e-6, 1000))


def make_slq_logdet_congruence(matvec_of_p, m_apply_of_p, mt_apply_of_p,
                               logdet_p_of_p, precond_of_p, n, rank=50,
                               num_probes=50, seed=0, dtype=torch.float64,
                               device="cpu", probe_chunk=None, cg_tol=1e-6,
                               cg_maxit=1000, count=None):
    """SLQ through the exact congruence log|A| = log|M' A M| - 2 log|det M|
    for a preconditioner P^-1 = M M' (logdet_p_of_p(p) returns
    -2 log|det M|): SLQ estimates only the congruent operator's log-det,
    whose spectrum clusters near 1 when P ~= A. Backward solves
    P-preconditioned (precond_of_p(p) -> r -> P^-1 r); count(it, maxit),
    when given, receives each probe solve's per-column CG iterations."""
    probes = rademacher_probes(n, num_probes, seed, dtype, device)

    def value(p):
        def mv(v):
            return mt_apply_of_p(p, matvec_of_p(p, m_apply_of_p(p, v)))

        return _slq_logdet_value(mv, n, rank, probes,
                                 probe_chunk=probe_chunk) + logdet_p_of_p(p)

    return SLQLogdet(_SLQSpec(value, matvec_of_p, precond_of_p, probes,
                              probe_chunk, cg_tol, cg_maxit, count))


def pivoted_cholesky_kernel(coords, var, corr_of_dist, rank, jitter=1e-10):
    """Rank-k pivoted Cholesky of the kernel matrix Sigma without forming it
    (CG_utils.h:438): columns from the covariance function on demand, the
    greedy pivot a device index (no host read). Returns (L (n, rank),
    d_rem), Sigma ~= L L' and d_rem the Schur complement's diagonal."""
    n = coords.shape[0]
    var = torch.as_tensor(var, dtype=coords.dtype, device=coords.device)
    d = var.expand(n).clone()
    L = coords.new_zeros((n, rank))
    ar = torch.arange(n, device=coords.device)
    for j in range(rank):
        i = torch.argmax(d).reshape(1)
        ci = coords.index_select(0, i)
        dist = torch.sqrt(torch.clamp(((coords - ci) ** 2).sum(1), min=0.0))
        col = var * corr_of_dist(dist) - L @ L.index_select(0, i)[0]
        piv = torch.sqrt(torch.clamp(d.index_select(0, i), min=jitter))
        lcol = torch.where(ar == i, piv, col / piv)
        L[:, j] = lcol
        d = torch.clamp(d - lcol * lcol, min=0.0)
    return L, d


class _CGSolve(torch.autograd.Function):
    """x = A(p)^-1 b with the implicit gradient: lam = A^-1 x_bar (one
    adjoint solve), b_bar = lam, p_bar = grad of -lam' A(p) x."""

    @staticmethod
    def forward(ctx, spec, b, *p):
        matvec, precond_of_p, tol, maxit, count = spec
        pre = None if precond_of_p is None else precond_of_p(p)
        x, it = pcg_it(lambda v: matvec(p, v), b, precond=pre, tol=tol,
                       maxit=maxit)
        if count is not None:
            count(it, maxit)
        ctx.spec = spec
        ctx.save_for_backward(x, *p)
        return x

    @staticmethod
    def backward(ctx, ct):
        matvec, precond_of_p, tol, maxit, count = ctx.spec
        x, *p = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.no_grad():
            pre = None if precond_of_p is None else precond_of_p(p)
            lam, it = pcg_it(lambda v: matvec(p, v), ct, precond=pre,
                             tol=tol, maxit=maxit)
            if count is not None:
                count(it, maxit)
        gp = [None] * len(p)
        if any(need):
            with torch.enable_grad():
                pp = [t.detach().requires_grad_(nd) for t, nd in zip(p, need)]
                live = [k for k, nd in enumerate(need) if nd]
                gs = torch.autograd.grad(-torch.sum(lam * matvec(pp, x)),
                                         [pp[k] for k in live],
                                         allow_unused=True)
                for k, g in zip(live, gs):
                    gp[k] = torch.zeros_like(p[k]) if g is None else g
        return (None, lam) + tuple(gp)


def make_cg_solve_precond(matvec_of_p, precond_of_p, tol=1e-6, maxit=1000,
                          count=None):
    """solve(p, b) = A(p)^-1 b for a tuple of parameter tensors p, with a
    P-preconditioned CG (precond_of_p(p) -> r -> P^-1 r) and the implicit
    gradient (CG_utils.h:505 with re_model_template.h's gradients);
    count(it, maxit), when given, receives the per-column CG iterations of
    every solve, forward and adjoint."""
    spec = (matvec_of_p, precond_of_p, tol, maxit, count)
    return lambda p, b: _CGSolve.apply(spec, b, *p)


def make_cg_solve(matvec_of_theta, tol=1e-6, maxit=1000):
    """solve(theta, b) = A(theta)^-1 b with the implicit gradient."""
    spec = (lambda p, v: matvec_of_theta(p[0], v), None, tol, maxit, None)
    return lambda theta, b: _CGSolve.apply(spec, b, theta)
