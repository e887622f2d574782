"""The iterative methods of the PyTorch port (gpboost_tpu_torch/ops/
iterative.py) against the JAX package's (gpboost_tpu/ops/iterative.py).

Every function on a small dense SPD operator (n <= 60), float64, on the
CPU, the same numpy inputs through both packages: solutions, iteration
counts (both batched-CG rules: each column on its own convergence, and
pcg_batched's run-until-all with guarded steps), Lanczos coefficients,
the three SLQ log-determinants with their gradients (the same Rademacher
probes from np.random.RandomState), the pivoted Cholesky and the CG solves
with their implicit gradients. Tolerance 1e-10 (relative to the largest
entry) throughout; counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpboost_tpu.ops import iterative as jit

from gpboost_tpu_torch.ops import iterative as pit

torch.set_num_threads(1)

TOL = 1e-10
N = 40


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    assert a.shape == b.shape
    assert float(np.max(np.abs(a - b))) <= tol * scale, \
        float(np.max(np.abs(a - b))) / scale


@pytest.fixture(scope="module")
def op():
    """An SPD matrix with a spread spectrum, right-hand sides of different
    scales (so the columns converge after different counts), coords."""
    rng = np.random.RandomState(0)
    M = rng.randn(N, N)
    G = M @ M.T / N + np.diag(0.05 + 2.0 * rng.rand(N))
    B = rng.randn(5, N) * np.array([1.0, 1e-3, 10.0, 1.0, 0.1])[:, None]
    # columns that unpreconditioned CG solves in few iterations: an
    # eigenvector (1) and a mix of three eigenvectors (3)
    E = np.linalg.eigh(G)[1]
    B[1] = E[:, 0] + E[:, 5] - 2.0 * E[:, 9]
    B[3] = E[:, 0]
    return G, B, rng.rand(N, 2)


def _mv_pair(G):
    Gj, Gt = jnp.asarray(G), torch.as_tensor(G)
    dj, dt = jnp.diagonal(Gj), torch.diagonal(Gt)
    return ((lambda v: Gj @ v), (lambda r: r / dj),
            (lambda v: Gt @ v),
            (lambda r: r / (dt if r.ndim == 1 else dt[:, None])))


def test_pcg_and_pcg_it_match_jax(op):
    G, B, _ = op
    mvj, prej, mvt, pret = _mv_pair(G)
    for pre in (False, True):
        xj = jit.pcg(mvj, jnp.asarray(B[0]), precond=prej if pre else None,
                     tol=1e-9)
        xt = pit.pcg(mvt, torch.as_tensor(B[0]),
                     precond=pret if pre else None, tol=1e-9)
        _close(xt.numpy(), xj)
        _close(G @ xt.numpy(), B[0], 1e-8)
    # a warm start x0 and the iteration count
    x0 = 0.5 * np.linalg.solve(G, B[2])
    xj, itj = jit.pcg_it(mvj, jnp.asarray(B[2]), precond=prej, tol=1e-8,
                         x0=jnp.asarray(x0))
    xt, itt = pit.pcg_it(mvt, torch.as_tensor(B[2]), precond=pret, tol=1e-8,
                         x0=torch.as_tensor(x0))
    _close(xt.numpy(), xj)
    assert int(itt) == int(itj)
    # maxit stops the loop
    xj, itj = jit.pcg_it(mvj, jnp.asarray(B[0]), tol=1e-14, maxit=7)
    xt, itt = pit.pcg_it(mvt, torch.as_tensor(B[0]), tol=1e-14, maxit=7)
    _close(xt.numpy(), xj)
    assert int(itt) == int(itj) == 7


def test_columns_stop_on_their_own_convergence(op):
    """pcg on columns equals JAX's pcg vmapped over the rows: each lane
    frozen at its own convergence, its own count."""
    G, B, _ = op
    mvj, prej, mvt, pret = _mv_pair(G)
    xj, itj = jax.vmap(lambda b: jit.pcg_it(mvj, b, tol=1e-8))(
        jnp.asarray(B))
    xt, itt = pit.pcg_it(mvt, torch.as_tensor(B.T.copy()), tol=1e-8)
    _close(xt.numpy().T, xj)
    np.testing.assert_array_equal(itt.numpy(), np.asarray(itj))
    assert len(set(itt.tolist())) > 2          # the lanes did stop apart
    # a lane alone gives its batched result
    x3, it3 = pit.pcg_it(mvt, torch.as_tensor(B[2]), tol=1e-8)
    _close(x3.numpy(), xt.numpy()[:, 2], 1e-13)
    assert int(it3) == int(itt[2])


def test_pcg_batched_matches_jax(op):
    """pcg_batched: every lane runs until all converge (guarded alpha and
    beta), so its iterates differ from the per-lane rule's."""
    G, B, _ = op
    mvj, prej, mvt, pret = _mv_pair(G)
    for pre in (None, "jacobi"):
        Xj = jit.pcg_batched(mvj, jnp.asarray(B),
                             precond=prej if pre else None, tol=1e-8)
        Xt = pit.pcg_batched(mvt, torch.as_tensor(B),
                             precond=pret if pre else None, tol=1e-8)
        _close(Xt.numpy(), Xj)
        _close((G @ Xt.numpy().T).T, B, 1e-6)


def test_lanczos_and_slq_value_match_jax(op):
    G, B, _ = op
    mvj, _, mvt, _ = _mv_pair(G)
    z = np.sign(B[0])
    aj, bj = jit.lanczos_tridiag(mvj, jnp.asarray(z), 12)
    at, bt = pit.lanczos_tridiag(mvt, torch.as_tensor(z), 12)
    _close(at.numpy(), aj)
    _close(bt.numpy(), bj)
    # batched over columns
    Z = np.sign(B[:3]).T.copy()
    at, bt = pit.lanczos_tridiag(mvt, torch.as_tensor(Z), 12)
    for k in range(3):
        aj, bj = jit.lanczos_tridiag(mvj, jnp.asarray(Z[:, k]), 12)
        _close(at.numpy()[:, k], aj)
        _close(bt.numpy()[:, k], bj)
    P = pit.rademacher_probes(N, 7, 3, torch.float64, "cpu")
    Pj = jnp.asarray(np.random.RandomState(3).randint(0, 2, (7, N)) * 2.0
                     - 1.0)
    np.testing.assert_array_equal(P.numpy().T, np.asarray(Pj))
    vj = jit._slq_logdet_value(mvj, N, 20, Pj, probe_chunk=3)
    for chunk in (None, 3):
        vt = pit._slq_logdet_value(mvt, N, 20, P, probe_chunk=chunk)
        _close(vt.numpy(), vj)


def test_slq_logdets_and_gradients_match_jax(op):
    G, _, _ = op
    Gj, Gt = jnp.asarray(G), torch.as_tensor(G)
    w = np.linspace(0.1, 0.5, N)
    wj, wt = jnp.asarray(w), torch.as_tensor(w)

    def mvj(p, v):
        return Gj @ v + jnp.exp(p[0][0]) * v + p[1] * v

    def mvt(p, v):
        ww = p[1] if v.ndim == 1 else p[1][:, None]
        return Gt @ v + torch.exp(p[0][0]) * v + ww * v

    th = np.asarray([0.3])
    # make_slq_logdet over theta
    lj = jit.make_slq_logdet(lambda t, v: mvj((t, wj), v), N, rank=20,
                             num_probes=9, seed=2)
    lt = pit.make_slq_logdet(lambda t, v: mvt((t, wt), v), N, rank=20,
                             num_probes=9, seed=2)
    vj, gj = jax.value_and_grad(lj)(jnp.asarray(th))
    tt = torch.tensor(th, requires_grad=True)
    vt = lt(tt)
    (gt,) = torch.autograd.grad(vt, tt)
    _close(vt.detach().numpy(), vj)
    _close(gt.numpy(), gj)
    v = float(vt.detach())
    exact = np.linalg.slogdet(G + np.exp(0.3) * np.eye(N) + np.diag(w))[1]
    assert abs(v - exact) < 0.05 * abs(exact)
    # make_slq_logdet_precond over (theta, w), Jacobi scaling
    dG = np.diagonal(G).copy()
    lj = jit.make_slq_logdet_precond(
        mvj, lambda p: jnp.asarray(dG) + jnp.exp(p[0][0]) + p[1], N,
        rank=20, num_probes=9, seed=4)
    lt = pit.make_slq_logdet_precond(
        mvt, lambda p: torch.as_tensor(dG) + torch.exp(p[0][0]) + p[1], N,
        rank=20, num_probes=9, seed=4)
    vj, gj = jax.value_and_grad(lj)((jnp.asarray(th), wj))
    pt = (torch.tensor(th, requires_grad=True),
          torch.tensor(w, requires_grad=True))
    vt = lt(*pt)
    gt = torch.autograd.grad(vt, pt)
    _close(vt.detach().numpy(), vj)
    for a, b in zip(gt, gj):
        _close(a.numpy(), b)
    # make_slq_logdet_congruence, M = diag(d^-1/2), probes in chunks

    def dj_(p):
        return jnp.asarray(dG) + jnp.exp(p[0][0]) + p[1]

    def dt_(p):
        return torch.as_tensor(dG) + torch.exp(p[0][0]) + p[1]

    def col(d, v):
        return d if v.ndim == 1 else d[:, None]

    lj = jit.make_slq_logdet_congruence(
        mvj, lambda p, v: v / jnp.sqrt(dj_(p)),
        lambda p, v: v / jnp.sqrt(dj_(p)),
        lambda p: jnp.sum(jnp.log(dj_(p))),
        lambda p: (lambda r: r / dj_(p)), N, rank=20, num_probes=8, seed=5,
        probe_chunk=3)
    lt = pit.make_slq_logdet_congruence(
        mvt, lambda p, v: v / col(torch.sqrt(dt_(p)), v),
        lambda p, v: v / col(torch.sqrt(dt_(p)), v),
        lambda p: torch.sum(torch.log(dt_(p))),
        lambda p: (lambda r: r / col(dt_(p), r)), N, rank=20, num_probes=8,
        seed=5, probe_chunk=3)
    vj, gj = jax.value_and_grad(lj)((jnp.asarray(th), wj))
    vt = lt(*pt)
    gt = torch.autograd.grad(vt, pt)
    _close(vt.detach().numpy(), vj)
    for a, b in zip(gt, gj):
        _close(a.numpy(), b)
    # value=False keeps the gradient and skips the value
    v0 = lt(*pt, value=False)
    assert float(v0.detach()) == 0.0
    for a, b in zip(torch.autograd.grad(v0, pt), gt):
        _close(a.numpy(), b.numpy(), 1e-14)


def test_pivoted_cholesky_matches_jax(op):
    _, _, coords = op
    Lj, dj = jit.pivoted_cholesky_kernel(
        jnp.asarray(coords), 1.3, lambda d: jnp.exp(-d / 0.2), 15)
    Lt, dt = pit.pivoted_cholesky_kernel(
        torch.as_tensor(coords), 1.3, lambda d: torch.exp(-d / 0.2), 15)
    _close(Lt.numpy(), Lj)
    _close(dt.numpy(), dj)
    D = np.sqrt(((coords[:, None] - coords[None]) ** 2).sum(-1))
    K = 1.3 * np.exp(-D / 0.2)
    np.testing.assert_allclose(np.diagonal(K - Lt.numpy() @ Lt.numpy().T),
                               dt.numpy(), atol=1e-10)


def test_cg_solves_and_their_gradients_match_jax(op):
    G, B, _ = op
    Gj, Gt = jnp.asarray(G), torch.as_tensor(G)
    dG = np.diagonal(G).copy()
    th, b, ct = np.asarray([0.2]), B[0], B[4]
    # make_cg_solve over theta
    sj = jit.make_cg_solve(lambda t, v: Gj @ v + jnp.exp(t[0]) * v,
                           tol=1e-10)
    st = pit.make_cg_solve(lambda t, v: Gt @ v + torch.exp(t[0]) * v,
                           tol=1e-10)
    xj, vjp = jax.vjp(sj, jnp.asarray(th), jnp.asarray(b))
    gj = vjp(jnp.asarray(ct))
    tt = torch.tensor(th, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    xt = st(tt, bt)
    gt = torch.autograd.grad(xt, (tt, bt), torch.as_tensor(ct))
    _close(xt.detach().numpy(), xj)
    for a, c in zip(gt, gj):
        _close(a.numpy(), c)
    # make_cg_solve_precond over (theta, w), Jacobi
    w = np.linspace(0.2, 0.4, N)

    def mvj(p, v):
        return Gj @ v + (jnp.exp(p[0][0]) + p[1]) * v

    def mvt(p, v):
        d = torch.exp(p[0][0]) + p[1]
        return Gt @ v + (d if v.ndim == 1 else d[:, None]) * v

    sj = jit.make_cg_solve_precond(
        mvj, lambda p: (lambda r: r / (jnp.asarray(dG) + jnp.exp(p[0][0])
                                       + p[1])), tol=1e-10)
    st = pit.make_cg_solve_precond(
        mvt, lambda p: (lambda r: r / (torch.as_tensor(dG)
                                       + torch.exp(p[0][0]) + p[1])),
        tol=1e-10)
    xj, vjp = jax.vjp(sj, (jnp.asarray(th), jnp.asarray(w)), jnp.asarray(b))
    (gpj, gbj) = vjp(jnp.asarray(ct))
    pt = (torch.tensor(th, requires_grad=True),
          torch.tensor(w, requires_grad=True))
    bt = torch.tensor(b, requires_grad=True)
    xt = st(pt, bt)
    gt = torch.autograd.grad(xt, (*pt, bt), torch.as_tensor(ct))
    _close(xt.detach().numpy(), xj)
    for a, c in zip(gt, (*gpj, gbj)):
        _close(a.numpy(), c)
