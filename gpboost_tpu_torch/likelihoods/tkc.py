"""Triangular-kernel-curvature (TKC) approximation for kinked likelihoods
(counterpart of gpboost_tpu/likelihoods/tkc.py; reference likelihoods.h:13555
FindDeltaMode_TKC_Approx, :13637 GoodnessFit_TKC_approx, :13510
NegativeHessian_TKC_Approx_AsymLaplace).

The curvature is one constant c = (dll_up + dll_down) / (n delta^2), where
delta minimises the unexplained variance of a quadratic fit to the total
log-likelihood at +-delta and +-delta/2 around the current location. The
reference's search, upper-limit doubling from 0.1 and then ternary search
to 1e-3 relative width, is followed step for step so that the goldens
match. It runs as a device loop of scalar tensor operations:

  * the doubling phase evaluates the goodness of fit at every candidate
    upper limit 0.1 * 2^k (k <= 100) in one batched pass, and picks the
    reference's stopping point with device reductions;
  * the ternary phase runs its steps on the device with the finished state
    frozen, and reads the "done" flag back once every TERNARY_CHECK steps.

So one search costs ceil(steps / TERNARY_CHECK) host reads (`host_reads`
counts them). The returned curvature is differentiable in the location
with delta held constant, the convention of the reference's hand
derivative (likelihoods.h:14110).

The reference's "goodness of fit not met" sentinel is 1e98; the JAX package
lowers it to 1e30 for its TPU's float range. It is only compared against,
so either value gives the same result; the port keeps the reference's 1e98.
"""

import torch

TKC_MIN_DECREASE = 0.1       # TKC_MIN_DECREASE_LOG_LIKE_, likelihoods.h:17249
GF_NOT_MET = 1e98            # GOODNESS_FIT_MIN_DECREASE_LOG_LIKE_NOT_MET_
EPS_NUM = 1e-10              # EPSILON_NUMBERS, utils.h:24
CURV_FLOOR = 1e-10           # NegativeHessian floor, likelihoods.h:13516
MAX_STEPS = 100
TERNARY_CHECK = 8

#: host reads made by tkc_neg_curvature since the last reset
host_reads = 0


def _curv(nd, delta, d_up, d_dn):
    return torch.clamp((d_up + d_dn) / (nd * delta * delta), min=CURV_FLOOR)


def tkc_neg_curvature(ll_shift, n_data, like):
    """The TKC approximation's constant negative curvature.

    ll_shift(s) returns the total (weighted) log-likelihood with the
    location shifted by s, for s a tensor of shifts of shape (k, 1)
    (AddConstantToLocationPar, likelihoods.h:13528): a (k,) tensor; like
    gives the dtype and device. The search itself runs without a graph;
    the final evaluation at the chosen delta is differentiable through
    ll_shift.
    """
    global host_reads
    dt, dev = like.dtype, like.device
    with torch.no_grad():
        ll0 = ll_shift(torch.zeros((1, 1), dtype=dt, device=dev))[0]
        nd = torch.as_tensor(float(n_data), dtype=dt, device=dev)

        def gf(delta):
            """Goodness of fit at a batch of deltas (k,)."""
            d = delta[:, None]
            ll = ll_shift(torch.cat([d, -d, d / 2.0, -d / 2.0]))
            k = delta.shape[0]
            d_up, d_dn = ll0 - ll[:k], ll0 - ll[k:2 * k]
            d_uph, d_dnh = ll0 - ll[2 * k:3 * k], ll0 - ll[3 * k:]
            bad = (d_up < TKC_MIN_DECREASE) | (d_dn < TKC_MIN_DECREASE)
            c = _curv(nd, delta, d_up, d_dn)
            # quadratic-fit differences (sum of first derivatives = 0)
            a_full = nd * delta * delta * c / 2.0
            a_half = a_full / 4.0
            mean = (d_up + d_uph + d_dn + d_dnh) / 4.0
            ss_res = ((d_up - a_full) ** 2 + (d_uph - a_half) ** 2
                      + (d_dn - a_full) ** 2 + (d_dnh - a_half) ** 2)
            ss_tot = ((d_up - mean) ** 2 + (d_uph - mean) ** 2
                      + (d_dn - mean) ** 2 + (d_dnh - mean) ** 2)
            return torch.where(bad, torch.full_like(ss_res, GF_NOT_MET),
                               ss_res / ss_tot)

        # ---- upper limit: double from 0.1 until gf stops decreasing. The
        # sequential rule: at step j (upper_j = 0.1 2^j, j >= 1) stop when
        # gf_j is finite-and-not-better than the last accepted value, or
        # not finite; the accepted value is the previous gf while no stop
        # happened, i.e. gf_{j-1}. So the loop stops at the first j >= 1
        # with (gf_j < NOT_MET and gf_j >= gf_{j-1} * 0.999) or !finite,
        # and returns upper_j (or upper_100 when none stops).
        uppers = 0.1 * torch.pow(
            torch.full((MAX_STEPS + 1,), 2.0, dtype=dt, device=dev),
            torch.arange(MAX_STEPS + 1, dtype=dt, device=dev))
        g = gf(uppers)
        stop = ((g[1:] < GF_NOT_MET) & (g[1:] >= g[:-1] * 0.999)) \
            | ~torch.isfinite(g[1:])
        # the first stop, or the last upper limit when none stops
        j = torch.where(stop.any(), torch.argmax(stop.to(torch.int32)),
                        torch.full_like(torch.argmax(stop.to(torch.int32)),
                                        MAX_STEPS - 1)) + 1
        upper = uppers.index_select(0, j)[0]

        # ---- ternary search for the minimum of gf on [0, upper]
        lo, hi = torch.zeros_like(upper), upper
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for it in range(MAX_STEPS):
            mid1 = lo + (hi - lo) / 3.0
            mid2 = lo + 2.0 * (hi - lo) / 3.0
            v = gf(torch.stack([mid1, mid2]))
            v1, v2 = v[0], v[1]
            both_one = (torch.abs(v1 - 1.0) < EPS_NUM * torch.clamp(
                torch.abs(v1), min=1.0)) & (torch.abs(v2 - 1.0) < EPS_NUM
                                            * torch.clamp(torch.abs(v2),
                                                          min=1.0))
            go_up = (v1 < v2) | ~torch.isfinite(v2)
            lo_n = torch.where(both_one, mid2, torch.where(go_up, lo, mid1))
            hi_n = torch.where(both_one, hi, torch.where(go_up, mid2, hi))
            lo = torch.where(done, lo, lo_n)
            hi = torch.where(done, hi, hi_n)
            done = done | (torch.abs(hi_n - lo_n) <= 1e-3 * torch.abs(lo_n))
            if (it + 1) % TERNARY_CHECK == 0:
                host_reads += 1
                if bool(done):
                    break
        delta = ((lo + hi) / 2.0).reshape(1, 1)
    ll = ll_shift(torch.cat([torch.zeros_like(delta), delta, -delta]))
    return _curv(nd, delta[0, 0], ll[0] - ll[1], ll[0] - ll[2])
