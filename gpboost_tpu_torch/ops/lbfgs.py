"""L-BFGS with the iterate, its history and the objective on the device
(counterpart of gpboost_tpu/ops/lbfgs.py `lbfgs_run` and, for the Laplace
engines, `lbfgs_run_state`, which threads the mode through every
evaluation).

The reference runs the whole loop as one jitted lax.while_loop. Here the
loop is Python on the host while every vector and scalar of the state stays
a device tensor; the host reads back one pair of flags per line-search
trial, (Armijo condition met, converged if accepted), and nothing else:

    host reads per fit = 1 per trial = 1 per iteration when the first
                         step t = 1 is accepted, as it usually is.

The two-loop recursion's masks, the curvature test and the history updates
are device `where`s; no parameter vector is uploaded inside the loop.

Semantics are the reference's, step for step: history m = 20 in circular
buffers; pairs with s'y <= 1e-10 |s| |y| are stored with rho = 0 and masked
out of the two-loop recursion; a direction that is not a descent direction
falls back to steepest descent; Armijo backtracking (c1 = 1e-4, t halved,
at most 30 trials); stop on (f - f_new) <= ftol max(|f|, 1), on
max |g| <= gtol, or when the line search fails. With has_aux the aux of
the last accepted iterate comes back, so no extra evaluation is needed.
"""

import torch


def _two_loop(g, S, Y, rho, gamma, k, m):
    """r = H_k g by the two-loop recursion over the valid history (newest
    to oldest, then oldest to newest); invalid pairs (rho = 0) are masked
    on the device."""
    n_hist = min(k, m)
    q = g
    alphas = {}
    for i in range(n_hist):
        j = (k - 1 - i) % m
        valid = rho[j] > 0
        a = rho[j] * torch.dot(S[j], q)
        q = torch.where(valid, q - a * Y[j], q)
        alphas[j] = torch.where(valid, a, torch.zeros_like(a))
    r = gamma * q
    for i in range(n_hist):
        j = (k - n_hist + i) % m
        b = rho[j] * torch.dot(Y[j], r)
        r = torch.where(rho[j] > 0, r + S[j] * (alphas[j] - b), r)
    return r


def lbfgs_run(vag, x0, max_iter, m=20, ftol=1e-16, gtol=1e-12, c1=1e-4,
              max_ls=30, has_aux=False):
    """Minimize from the device tensor x0 (d,).

    vag: x -> (f, g), 0-dim and (d,) device tensors (value and gradient);
    with has_aux=True, x -> (f, g, aux) and the aux of the last accepted
    iterate is returned too. Returns (x, f, num_iter, converged), or
    (x, f, aux, num_iter, converged); num_iter and converged are host
    values."""
    raw_vag = vag
    if not has_aux:
        def vag(x):
            f, g = raw_vag(x)
            return f, g, None

    d = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    x = x0
    f, g, aux = vag(x0)
    S = torch.zeros((m, d), dtype=dtype, device=dev)
    Y = torch.zeros((m, d), dtype=dtype, device=dev)
    rho = torch.zeros((m,), dtype=dtype, device=dev)
    gamma = torch.ones((), dtype=dtype, device=dev)
    k, done = 0, False
    while not done and k < max_iter:
        p = -_two_loop(g, S, Y, rho, gamma, k, m)
        gp = torch.dot(g, p)
        bad = gp >= 0
        p = torch.where(bad, -g, p)
        gp = torch.where(bad, -torch.dot(g, g), gp)
        # backtracking Armijo: halve t until f(x + t p) <= f + c1 t g'p
        t, ls_ok = 1.0, False
        fn, xn, gn, auxn = f, x, g, aux
        ftol_f = ftol * torch.clamp(torch.abs(f), min=1.0)
        for _ in range(max_ls):
            x_try = x + t * p
            f_try, g_try, aux_try = vag(x_try)
            ok = (f_try <= f + c1 * t * gp) & torch.isfinite(f_try)
            conv = ((f - f_try) <= ftol_f) | (torch.max(torch.abs(g_try))
                                              <= gtol)
            ok_h, conv_h = torch.stack([ok, conv]).tolist()
            if ok_h:
                fn, xn, gn, auxn = f_try, x_try, g_try, aux_try
                ls_ok = True
                break
            t *= 0.5
        j = k % m
        if ls_ok:
            s = xn - x
            yv = gn - g
            sy = torch.dot(s, yv)
            good = sy > 1e-10 * torch.linalg.norm(s) * torch.linalg.norm(yv)
            S[j] = torch.where(good, s, torch.zeros_like(s))
            Y[j] = torch.where(good, yv, torch.zeros_like(yv))
            rho[j] = torch.where(good, 1.0 / torch.where(
                good, sy, torch.ones_like(sy)), torch.zeros_like(sy))
            gamma = torch.where(good, sy / torch.dot(yv, yv), gamma)
            done = bool(conv_h)
        else:
            # a failed line search keeps the iterate and ends the run
            S[j] = 0.0
            Y[j] = 0.0
            rho[j] = 0.0
            done = True
        x, f, g, aux = xn, fn, gn, auxn
        k += 1
    if has_aux:
        return x, f, aux, k, done
    return x, f, k, done


def lbfgs_run_state(vag, x0, st0, max_iter, m=20, ftol=1e-16, gtol=1e-12,
                    c1=1e-4, max_ls=30, max_step=5.0):
    """L-BFGS with a warm-start state threaded through every evaluation
    (counterpart of gpboost_tpu/ops/lbfgs.py `lbfgs_run_state`): the Laplace
    mode carried from one objective evaluation to the next.

    vag: (x, st) -> (f, g, st_new) on device tensors. Every line-search
    trial warm-starts from the state of the last accepted iterate, and a
    non-finite trial keeps it (the reference's
    ResetLaplaceApproxModeToPreviousValue guard). Safeguards of
    the reference: the direction's largest coordinate is capped at
    max_step, the first step is scaled to unit length, and the relative
    objective test arms from the second iteration. One host read per
    line-search trial. Returns (x, f, st, num_iter, converged); num_iter and
    converged are host values."""
    d = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    f, g, st1 = vag(x0, st0)
    st = torch.where(torch.isfinite(f), st1, st0)
    x = x0
    S = torch.zeros((m, d), dtype=dtype, device=dev)
    Y = torch.zeros((m, d), dtype=dtype, device=dev)
    rho = torch.zeros((m,), dtype=dtype, device=dev)
    gamma = torch.ones((), dtype=dtype, device=dev)
    k, done = 0, False
    while not done and k < max_iter:
        p = -_two_loop(g, S, Y, rho, gamma, k, m)
        pn = torch.max(torch.abs(p))
        p = p * torch.clamp(max_step / torch.clamp(pn, min=1e-300), max=1.0)
        t0 = 1.0 / torch.clamp(torch.linalg.norm(p), min=1.0) if k == 0 \
            else torch.ones((), dtype=dtype, device=dev)
        gp = torch.dot(g, p)
        bad = gp >= 0
        p = torch.where(bad, -g, p)
        gp = torch.where(bad, -torch.dot(g, g), gp)
        ls_ok, t = False, t0
        fn, xn, gn, stn = f, x, g, st
        ftol_f = ftol * torch.clamp(torch.abs(f), min=1.0)
        for _ in range(max_ls):
            x_try = x + t * p
            f_try, g_try, st_try = vag(x_try, st)
            ok = (f_try <= f + c1 * t * gp) & torch.isfinite(f_try)
            conv = (torch.max(torch.abs(g_try)) <= gtol)
            if k >= 1:
                conv = conv | ((f - f_try) <= ftol_f)
            ok_h, conv_h = torch.stack([ok, conv]).tolist()
            if ok_h:
                fn, xn, gn, stn = f_try, x_try, g_try, st_try
                ls_ok = True
                break
            t = t * 0.5
        j = k % m
        if ls_ok:
            s = xn - x
            yv = gn - g
            sy = torch.dot(s, yv)
            good = sy > 1e-10 * torch.linalg.norm(s) * torch.linalg.norm(yv)
            S[j] = torch.where(good, s, torch.zeros_like(s))
            Y[j] = torch.where(good, yv, torch.zeros_like(yv))
            rho[j] = torch.where(good, 1.0 / torch.where(
                good, sy, torch.ones_like(sy)), torch.zeros_like(sy))
            gamma = torch.where(good, sy / torch.dot(yv, yv), gamma)
            done = bool(conv_h)
        else:
            S[j] = 0.0
            Y[j] = 0.0
            rho[j] = 0.0
            done = True
        x, f, g, st = xn, fn, gn, stn
        k += 1
    return x, f, st, k, done
