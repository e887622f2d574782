"""Special functions of the general-shape Matern kernels (counterpart of
gpboost_tpu/ops/special_fns.py): log Gamma, and the modified Bessel function
of the second kind K_v for a real order v (torch.special has K_0 and K_1
only).

The reference calls std::cyl_bessel_k (cov_fcts.h:2120-2152, the general
Matern shapes, matern_estimate_shape and space_time_gneiting's nu). As in
the JAX package:

- x < 2:  Temme's series for K_mu, K_{mu+1} with |mu| <= 1/2, 40 terms;
- x >= 2: Steed's continued fraction CF2, 80 steps, a lane frozen once it
  has converged (the auxiliary series diverges if iterated on), with the
  rescaling that keeps its carries inside the float32 exponent range;
- the forward recurrence K_{mu+k+1} = K_{mu+k-1} + 2 (mu+k)/x K_{mu+k} up
  to the order v = mu + floor(v + 1/2), at most MAX_RECURRENCE steps.

Each branch runs on its own part of the arguments only: the flat argument
is sorted stably into the x < 2 entries and the rest (no host read), and
one host read per call brings back the order's recurrence length and the
size of the first part (`host_reads` counts them). The loops run under
torch.no_grad(): bessel_kv is a torch.autograd.Function whose backward is
the JAX package's custom_jvp (special_fns.py:212-226),

- dK/dx = -(K_{|v-1|} + K_{v+1}) / 2, here with K_{v+1} from the forward
  recurrence and K_{v-1} = K_{v+1} - (2v/x) K_v (K_{-u} = K_u), so the x
  derivative costs no evaluation of its own;
- dK/dv by a central difference at h = 1e-6 max(|v|, 1) (the reference
  also differences in the smoothness, cov_fcts.h:2218-2232): two more
  evaluations, whose recurrences run masked up to the forward's length
  plus one, so the backward reads nothing back.
"""

import math

import torch

_EULER = 0.5772156649015328606
_MAXIT_SERIES = 40
_MAXIT_CF2 = 80

# Lanczos approximation (g = 7, n = 9), ~1e-15 relative for z > 0, the JAX
# package's coefficients
_LANCZOS_G = 7.0
_LANCZOS_C = (
    0.99999999999980993,
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
)

# the host reads bessel_kv has made (one per forward call)
host_reads = 0
# the longest forward recurrence evaluated: a larger (or a non-finite)
# order, which only a wild line-search trial proposes, gives +inf (NaN for
# a non-finite one), which the trial's Armijo test rejects
MAX_RECURRENCE = 1000


def lgamma(z):
    """log Gamma(z) for z > 0 by the Lanczos approximation: a Python float
    for a float, else a tensor."""
    log = math.log if not torch.is_tensor(z) else torch.log
    zm1 = z - 1.0
    base = zm1 + _LANCZOS_G + 0.5
    s = _LANCZOS_C[0]
    for i in range(1, 9):
        s = s + _LANCZOS_C[i] / (zm1 + i)
    return (0.5 * math.log(2.0 * math.pi) + (zm1 + 0.5) * log(base)
            - base + log(s))


def _recip_gamma_pair(mu):
    """gam1 = [1/G(1-mu) - 1/G(1+mu)]/(2 mu), gam2 = [1/G(1-mu) +
    1/G(1+mu)]/2, gampl = 1/G(1+mu), gammi = 1/G(1-mu) for a 0-dim tensor
    |mu| <= 1/2 (NR's beschb, from log Gamma instead of Chebyshev fits)."""
    gampl = torch.exp(-lgamma(1.0 + mu))
    gammi = torch.exp(-lgamma(1.0 - mu))
    gam2 = 0.5 * (gammi + gampl)
    small = torch.abs(mu) < 1e-7
    # gam1 -> -euler_gamma as mu -> 0
    safe_mu = torch.where(small, torch.ones_like(mu), mu)
    gam1 = torch.where(small, torch.full_like(mu, -_EULER),
                       (gammi - gampl) / (2.0 * safe_mu))
    return gam1, gam2, gampl, gammi


def _kv_smallx(mu, x):
    """Temme's series: (K_mu(x), K_{mu+1}(x)) for 0 < x < 2, |mu| <= 1/2
    (mu a 0-dim tensor, x flat)."""
    x = torch.clamp_min(x, 1e-290)
    x2 = 0.5 * x
    pimu = math.pi * mu
    tiny = torch.abs(pimu) < 1e-12
    fact = torch.where(tiny, torch.ones_like(mu),
                       pimu / torch.sin(torch.where(tiny,
                                                    torch.ones_like(mu),
                                                    pimu)))
    d0 = -torch.log(x2)
    e0 = mu * d0
    tiny = torch.abs(e0) < 1e-12
    safe = torch.where(tiny, torch.ones_like(e0), e0)
    fact2 = torch.where(tiny, torch.ones_like(e0), torch.sinh(e0) / safe)
    gam1, gam2, gampl, gammi = _recip_gamma_pair(mu)
    ff = fact * (gam1 * torch.cosh(e0) + gam2 * fact2 * d0)
    e = torch.exp(e0)
    p = 0.5 * e / gampl
    q = 0.5 / (e * gammi)
    c = torch.ones_like(x)
    d = x2 * x2
    ssum = ff
    sum1 = p
    # the order's terms, one 0-dim entry each
    fis = torch.arange(1, _MAXIT_SERIES + 1, dtype=x.dtype, device=x.device)
    den, pm, qm = fis * fis - mu * mu, fis - mu, fis + mu
    for i in range(_MAXIT_SERIES):
        fi = float(i + 1)
        ff = (fi * ff + p + q) / den[i]
        c = c * d / fi
        p = p / pm[i]
        q = q / qm[i]
        ssum = ssum + c * ff
        sum1 = sum1 + c * (p - fi * ff)
    return ssum, sum1 * (2.0 / x)


def _kv_largex(mu, x):
    """CF2: (K_mu(x), K_{mu+1}(x)) for x >= 2, |mu| <= 1/2. Only h and s
    reach the result, so only they (and the convergence flags) are frozen;
    a and c do not depend on x and stay 0-dim."""
    a1 = 0.25 - mu * mu
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = torch.zeros_like(x)
    q2 = torch.ones_like(x)
    q = a1 * torch.ones_like(x)
    c = a1
    a = -a1
    s = 1.0 + q * delh
    done = torch.zeros_like(x, dtype=torch.bool)
    for i in range(2, _MAXIT_CF2 + 1):
        fi = float(i)
        a = a - 2.0 * (fi - 1.0)
        c = -a * c / fi
        qnew = (q1 - b * q2) / a
        q1, q2 = q2, qnew
        q = q + c * qnew
        b = b + 2.0
        d = 1.0 / (b + a * d)
        delh = (b * d - 1.0) * delh
        hn = h + delh
        dels = q * delh
        sn = s + dels
        # c grows ~ i! while q1, q2 decay ~ 1/i!; only c * qnew enters
        resc = torch.where(torch.abs(c) > 1e25, 1e-25, 1.0)
        c = c * resc
        q1 = q1 / resc
        q2 = q2 / resc
        h = torch.where(done, h, hn)
        s = torch.where(done, s, sn)
        done = done | (torch.abs(dels) < torch.abs(sn) * 1e-16)
    h = a1 * h
    rkmu = torch.sqrt(math.pi / (2.0 * x)) * torch.exp(-x) / s
    return rkmu, rkmu * (mu + x + 0.5 - h) / x


def _kv_up(v, xp, k, n_up, masked):
    """(K_v, K_{v+1}) at the sorted flat arguments xp, whose first k lie
    below 2: the two branches, then n_up steps of the forward recurrence,
    each taken only while it is below floor(|v| + 1/2) when `masked`."""
    v = torch.abs(v)
    nl = torch.floor(v + 0.5)
    mu = v - nl
    parts = [_kv_smallx(mu, xp[:k])] if k else []
    if k < xp.numel():
        parts.append(_kv_largex(mu, xp[k:]))
    rkmu = torch.cat([p[0] for p in parts])
    rk1 = torch.cat([p[1] for p in parts])
    two_x = 2.0 / xp
    for i in range(1, n_up + 1):
        new = (mu + float(i)) * two_x * rk1 + rkmu
        if masked:
            take = nl >= float(i)
            rkmu, rk1 = (torch.where(take, rk1, rkmu),
                         torch.where(take, new, rk1))
        else:
            rkmu, rk1 = rk1, new
    return rkmu, rk1


def _kv_graph(v, x, perm, k, n_up, masked):
    """(K_v, K_{v+1}) in x's shape from `_kv_up` on the sorted arguments
    x.reshape(-1)[perm], whose first k lie below 2, with autograd
    recording every step (the backward's differentiable evaluation)."""
    kv_p, kv1_p = _kv_up(v, x.reshape(-1)[perm], k, n_up, masked)
    kv = torch.index_copy(torch.zeros_like(kv_p), 0, perm, kv_p)
    kv1 = torch.index_copy(torch.zeros_like(kv1_p), 0, perm, kv1_p)
    return kv.view_as(x), kv1.view_as(x)


class _BesselKv(torch.autograd.Function):
    """K_v(x) elementwise; v a 0-dim tensor (x's dtype and device) or a
    float, x > 0 of any shape. Outputs K_v and, not differentiable, what
    the derivatives reuse: K_{v+1}, the sort of the flat arguments, and
    [size of the x < 2 part, recurrence length] on the host. Reverse mode
    (backward; with a graph of its own, for a Hessian, from `_kv_graph`,
    the plain evaluations of K_v, K_{v+1} and K_{v+-h} under autograd)
    and forward mode (jvp, which
    torch.func.jacfwd takes under vmap for the Fisher information) apply
    the same derivatives."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, v):
        global host_reads
        vt = v.to(x.dtype) if torch.is_tensor(v) else x.new_full((), float(v))
        flat = x.reshape(-1)
        small = flat < 2.0
        # the x < 2 entries first, each part in its original order
        perm = torch.argsort((~small).to(torch.uint8), stable=True)
        nl, k = torch.stack([torch.floor(torch.abs(vt) + 0.5).double(),
                             small.sum().double()]).tolist()
        host_reads += 1
        k = int(k)
        if not nl <= MAX_RECURRENCE:
            kv = torch.full_like(flat, math.inf if math.isfinite(nl)
                                 else math.nan)
            kv1, n_up = kv.clone(), -1
        else:
            n_up = int(nl)
            kv_p, kv1_p = _kv_up(vt, flat[perm], k, n_up, False)
            kv = torch.empty_like(flat)
            kv[perm] = kv_p
            kv1 = torch.empty_like(flat)
            kv1[perm] = kv1_p
        return kv.view_as(x), kv1, perm, torch.tensor([k, n_up])

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, v = inputs
        kv, kv1, perm, meta = output
        ctx.mark_non_differentiable(kv1, perm, meta)
        vt = v.to(x.dtype) if torch.is_tensor(v) else x.new_full((), float(v))
        ctx.save_for_backward(x, vt, kv, kv1, perm)
        ctx.save_for_forward(x, vt, kv, kv1, perm)
        ctx.part = tuple(meta.tolist())
        ctx.order = v

    @staticmethod
    def _derivatives(ctx, want_x, want_v):
        """(dK/dx, dK/dv) in the arguments' shape, None where not
        wanted."""
        x, vt, kv, kv1, perm = ctx.saved_tensors
        k, n_up = ctx.part
        dx = dv = None
        with torch.no_grad():
            flat = x.reshape(-1)
            if want_x:
                # -(K_{v-1} + K_{v+1}) / 2 = (|v| / x) K_v - K_{v+1}
                dx = (torch.abs(vt) / flat * kv.reshape(-1) - kv1).view_as(x)
            if want_v and n_up < 0:
                dv = torch.full_like(x, math.nan)
            elif want_v:
                h = 1e-6 * torch.clamp_min(torch.abs(vt), 1.0)
                xp = flat[perm]
                d = (_kv_up(vt + h, xp, k, n_up + 1, True)[0]
                     - _kv_up(vt - h, xp, k, n_up + 1, True)[0]) / (2.0 * h)
                dv = torch.empty_like(flat)
                dv[perm] = d
                dv = dv.view_as(x)
        return dx, dv

    @staticmethod
    def backward(ctx, g, *_):
        want_x, want_v = ctx.needs_input_grad[:2]
        if torch.is_grad_enabled():
            # a graph of the backward (a Hessian): the same derivatives
            # from the plain series, CF2 and recurrence evaluated under
            # autograd, so a second derivative in v is the central
            # difference of the series' own v derivative, as the JAX
            # package's custom_jvp differences its plain _bessel_kv_impl
            # (special_fns.py:212-226), and not a difference of a
            # difference
            x, perm = ctx.saved_tensors[0], ctx.saved_tensors[4]
            v = ctx.order
            vt = v.to(x.dtype) if torch.is_tensor(v) \
                else x.new_full((), float(v))
            k, n_up = ctx.part
            gx = gv = None
            if n_up < 0:
                nan = torch.full_like(x, math.nan)
                return (g * nan if want_x else None,
                        torch.sum(g * nan) if want_v else None)
            if want_x:
                kv, kv1 = _kv_graph(vt, x, perm, k, n_up, False)
                gx = g * (torch.abs(vt) / x * kv - kv1)
            if want_v:
                h = 1e-6 * torch.clamp_min(torch.abs(vt), 1.0)
                gv = torch.sum(g * (
                    _kv_graph(vt + h, x, perm, k, n_up + 1, True)[0]
                    - _kv_graph(vt - h, x, perm, k, n_up + 1, True)[0])
                ) / (2.0 * h)
            return gx, gv
        dx, dv = _BesselKv._derivatives(ctx, want_x, want_v)
        return (None if dx is None else g * dx,
                None if dv is None else torch.sum(g * dv))

    @staticmethod
    def jvp(ctx, x_t, v_t):
        dx, dv = _BesselKv._derivatives(ctx, x_t is not None,
                                        torch.is_tensor(v_t))
        out = None
        if dx is not None:
            out = x_t * dx
        if dv is not None:
            out = v_t * dv if out is None else out + v_t * dv
        return out, None, None, None


def bessel_kv(v, x):
    """Modified Bessel function of the second kind K_v(x), elementwise in x
    (v a float or a 0-dim tensor, K_{-v} = K_v; x > 0)."""
    if x.numel() == 0:
        return torch.empty_like(x)
    return _BesselKv.apply(x, v)[0]


def matern_correlation_general(scaled_dist, shape):
    """Matern correlation 2^{1-s}/Gamma(s) rd^s K_s(rd) at rd = scaled
    distance (cov_fcts.h:2120-2152); 1 at rd = 0. shape: a float or a 0-dim
    tensor (an estimated smoothness)."""
    rd = scaled_dist
    const = (math.exp((1.0 - shape) * math.log(2.0) - lgamma(shape))
             if not torch.is_tensor(shape)
             else torch.exp((1.0 - shape) * math.log(2.0) - lgamma(shape)))
    pos = rd > 0.0
    safe = torch.where(pos, rd, torch.ones_like(rd))
    val = const * torch.pow(safe, shape) * bessel_kv(shape, safe)
    return torch.where(pos, val, torch.ones_like(val))
