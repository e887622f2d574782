"""What the Gaussian engines (dense, Woodbury, Vecchia) share: the host-facing
wrappers around each engine's differentiable torch objective, and the
parameter transforms (re_model.cpp:306 TransformCovPars).

Internal parameterization, as in the reference: u = log([sigma2, v_1/sigma2,
alpha_1..., v_2/sigma2, ...]) with alpha the transformed ranges. theta =
u[1:] sets the scaled covariance Psi~(theta), and

    nll = 0.5 (y' Psi~^-1 y / sigma2 + log|Psi~| + n log sigma2 + n log 2 pi).

A subclass provides, on its device and in its dtype:

    _nll_parts(theta, sigma2, y)   -> (nll, quad = y' Psi~^-1 y)
    _nll_profiled(theta, y)        -> (nll at sigma2 = quad / n, quad)
    _orig_to_internal(pars_orig)   -> (theta, sigma2), differentiable
    _wls(theta, y, X), _coef_grad(theta, sigma2, resid, X)   (with X)

where y is a tensor in the engine's ordering (`prep_y`). Parameters enter
the wrappers as float64 numpy on the host; every wrapper reads its result
back once (one host sync). Gradients and Hessians come from
torch.autograd where the reference used jax.grad / jax.hessian.
"""

import numpy as np
import torch


class GaussianEngineBase:
    """Host wrappers and transforms over a subclass's torch objective."""

    components = ()
    par_offsets = ()

    # ------------------------------------------------------------------
    def _t(self, a):
        """Host array or scalar -> engine dtype on the engine's device. To
        a card it goes through pinned memory without blocking: a copy from
        pageable memory would wait for the device (a host sync), and the
        host loops upload parameters at every evaluation."""
        t = torch.as_tensor(np.asarray(a, dtype=np.float64))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t.to(device=self.device, dtype=self.dtype)

    def prep_y(self, y):
        """y in data order (numpy or tensor) -> the engine's ordering, dtype
        and device."""
        return torch.as_tensor(y, device=self.device).to(self.dtype)

    @staticmethod
    def _host(*tensors):
        """One read of every tensor as float64 numpy (one host sync)."""
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                          for t in tensors]).cpu().numpy()
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return out

    # ------------------------------------------------------------------
    def nll_parts(self, theta_log, sigma2, y):
        """(nll, quad) as host floats."""
        with torch.no_grad():
            nll, quad = self._nll_parts(self._t(theta_log), self._t(sigma2), y)
            nll, quad = torch.stack([nll, quad]).tolist()
        return nll, quad

    def grad_profiled(self, theta_log, sigma2, y):
        """(nll, gradient wrt theta at fixed sigma2)."""
        th = self._t(theta_log).requires_grad_(True)
        nll, _ = self._nll_parts(th, self._t(sigma2), y)
        (g,) = torch.autograd.grad(nll, th)
        v, g = self._host(nll, g)
        return float(v), g

    def nll_grad(self, theta_log, sigma2, y):
        """Gradient of the NLL at fixed sigma2 wrt theta, float64 numpy."""
        return self.grad_profiled(theta_log, sigma2, y)[1]

    def _nll_full(self, u, y):
        return self._nll_parts(u[1:], torch.exp(u[0]), y)[0]

    def vag_full(self, u, y):
        """(nll, gradient wrt u = log [sigma2, theta])."""
        ut = self._t(u).requires_grad_(True)
        nll = self._nll_full(ut, y)
        (g,) = torch.autograd.grad(nll, ut)
        v, g = self._host(nll, g)
        return float(v), g

    def hess_full(self, u, y):
        """Hessian of the NLL wrt u (Newton's method)."""
        H = torch.autograd.functional.hessian(
            lambda ut: self._nll_full(ut, y), self._t(u))
        return self._host(H)[0]

    def nll_profiled_vag(self, theta_log, y):
        """((nll, quad), gradient) of the nugget-profiled NLL wrt theta."""
        th = self._t(theta_log).requires_grad_(True)
        nll, quad = self._nll_profiled(th, y)
        (g,) = torch.autograd.grad(nll, th)
        v, q, g = self._host(nll, quad, g)
        return (float(v), float(q)), g

    def nll_orig_vag(self, log_pars_orig, y):
        """(nll, gradient) wrt log original-scale parameters."""
        lp = self._t(log_pars_orig).requires_grad_(True)
        theta_log, sigma2 = self._orig_to_internal(torch.exp(lp))
        nll, _ = self._nll_parts(theta_log, sigma2, y)
        (g,) = torch.autograd.grad(nll, lp)
        v, g = self._host(nll, g)
        return float(v), g

    def wls_coef(self, theta_log, y, X):
        """Closed-form GLS coefficients (re_model_template.h:9942
        UpdateCoefGLS), float64 numpy."""
        with torch.no_grad():
            return self._host(self._wls(self._t(theta_log), y, X))[0]

    def coef_grad(self, theta_log, sigma2, resid, X):
        """-X' Psi^-1 resid (re_model_template.h:2016), float64 numpy."""
        with torch.no_grad():
            return self._host(self._coef_grad(
                self._t(theta_log), self._t(sigma2), resid, X))[0]

    def neg_log_likelihood(self, pars_orig, y):
        """NLL at original-scale parameters for y in data order."""
        t = self.transform_pars(pars_orig)
        return self.nll_parts(np.log(t[1:]), t[0], self.prep_y(y))[0]

    # ------------------------------------------------------------------
    # parameter transforms (host numpy), as in the reference
    def transform_pars(self, pars_orig):
        """Original [sigma2, v_1, rho_1.., ...] -> internal transformed."""
        pars_orig = np.asarray(pars_orig, dtype=np.float64)
        sigma2 = pars_orig[0]
        out = [sigma2]
        for comp, off in zip(self.components, self.par_offsets):
            v = pars_orig[1 + off]
            out.append(v / sigma2)
            if comp.num_range_par > 0:
                rho = pars_orig[2 + off: 1 + off + comp.num_cov_par]
                out.extend(np.atleast_1d(
                    comp.cov_fn.range_to_transformed(rho, var=v)))
        return np.asarray(out)

    def back_transform_pars(self, pars_internal):
        """Internal transformed vector -> original scale."""
        t = np.asarray(pars_internal, dtype=np.float64)
        sigma2 = t[0]
        out = [sigma2]
        for comp, off in zip(self.components, self.par_offsets):
            v_orig = t[1 + off] * sigma2
            out.append(v_orig)
            if comp.num_range_par > 0:
                alphas = t[2 + off: 1 + off + comp.num_cov_par]
                out.extend(np.atleast_1d(
                    comp.cov_fn.range_from_transformed(alphas, var=v_orig)))
        return np.asarray(out)

    def _orig_to_internal(self, pars_orig):
        """Differentiable original -> (theta, sigma2)."""
        sigma2 = pars_orig[0]
        parts = []
        for comp, off in zip(self.components, self.par_offsets):
            v = pars_orig[1 + off]
            parts.append(torch.log(v / sigma2)[None])
            if comp.num_range_par > 0:
                rho = pars_orig[2 + off: 1 + off + comp.num_cov_par]
                parts.append(torch.log(
                    comp.cov_fn.range_to_transformed_torch(rho, var=v)))
        return torch.cat(parts), sigma2

    def total_re_variance_original(self, pars_orig):
        return float(sum(pars_orig[1 + off] for off in self.par_offsets))

    def apply_nugget_lower_bound(self, pars_internal):
        """nugget >= r / (1 - r) * total random-effect variance, r = 1e-10
        (re_model_template.h:7804 ApplyGaussianNuggetLowerBound)."""
        r = 1e-10
        orig = self.back_transform_pars(pars_internal)
        other_var = self.total_re_variance_original(orig)
        if not np.isfinite(other_var) or other_var <= 0:
            return pars_internal
        nugget_min = r / (1.0 - r) * other_var
        if np.isfinite(nugget_min) and orig[0] < nugget_min:
            orig[0] = nugget_min
            return self.transform_pars(orig)
        return pars_internal


def chol(M):
    """Lower Cholesky factor of the SPD matrix M without a host sync:
    `cholesky_ex` and NaN where the factorization failed (as a failed
    jnp.linalg.cholesky gives NaN in the reference)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where(info != 0, torch.full_like(L, float("nan")), L)
