"""Gradient-based maximum-likelihood estimation.

A capability tier the CUDA reference could never reach: under JAX the
extended-ML NLL (sxmc_jax.ops.nll, reference semantics at
src/nll_kernels.cpp:89-188) is differentiable in the source rates, so
the best fit comes from a jitted BFGS solve instead of a random walk —
milliseconds instead of minutes — with

  * Hessian (inverse-curvature) covariance and symmetric errors,
  * profile-likelihood scans vmapped over the grid (every profile point
    is an independent BFGS solve batched through one compiled kernel),
  * MINOS-style asymmetric intervals from the profile crossings, and
  * one-sided profile-likelihood upper limits.

Source rates are optimized in log space (r = exp(q)), which enforces the
physical boundary r >= 0 exactly where the reference relies on a 1e18
NLL barrier (nll_kernels.cpp:173-177).  Systematic coefficients enter
the NLL through the re-histogrammed PDFs, which are piecewise-constant
in theta (the bin assignment is a floor), so their event-term gradient
is zero almost everywhere; floating systematics are therefore profiled
with a device-batched coordinate-grid descent (every candidate a full
rate-profiled solve, one lax.map'd device call per coefficient sweep;
their Gaussian constraint keeps the outer problem tame).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import erfinv

from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.ops.nll import binned_nll, nll as nll_fn
from sxmc_jax.stats.intervals import Interval, chi2_quantile_1dof

_LOG_CLAMP = 30.0


@dataclasses.dataclass
class FitResult:
    """Point estimate + curvature errors from a gradient MLE fit."""

    names: List[str]
    params: np.ndarray          # full parameter vector at the optimum
    nll: float                  # NLL at the optimum
    free: np.ndarray            # bool mask of optimized parameters
    covariance: np.ndarray      # (nfree, nfree) inverse Hessian
    converged: bool

    @property
    def free_names(self) -> List[str]:
        return [n for n, f in zip(self.names, self.free) if f]

    def value(self, name: str) -> float:
        return float(self.params[self.names.index(name)])

    def error(self, name: str) -> float:
        """Symmetric (Hessian) error; NaN for fixed parameters."""
        i = self.names.index(name)
        if not self.free[i]:
            return float("nan")
        j = int(np.sum(self.free[:i]))
        return float(np.sqrt(max(self.covariance[j, j], 0.0)))

    def to_intervals(self, cl: float = 0.683) -> Dict[str, Interval]:
        """Symmetric intervals, drop-in for LikelihoodSpace.get_best_fit."""
        z = np.sqrt(chi2_quantile_1dof(cl))
        out = {}
        for name in self.names:
            v = self.value(name)
            e = self.error(name)
            e = 0.0 if not np.isfinite(e) else e * z
            out[name] = Interval(one_sided=False, point_estimate=v,
                                 lower=v - e, upper=v + e, cl=cl)
        return out

    def __str__(self) -> str:
        lines = ["-- MLE best fit --"]
        for name in self.names:
            v = self.value(name)
            e = self.error(name)
            tag = "" if np.isfinite(e) else " (fixed)"
            etxt = f" +- {e:g}" if np.isfinite(e) else ""
            lines.append(f" {name}: {v:g}{etxt}{tag}")
        lines.append(f" NLL: {self.nll}")
        if not self.converged:
            lines.append(" WARNING: optimizer did not report convergence")
        return "\n".join(lines)


class MLE(MCMC):
    """Maximum-likelihood fit driver with the MCMC's model contract.

    Reuses the parameter flattening, PDF stack, and NLL statics of
    :class:`sxmc_jax.mcmc.metropolis.MCMC` (reference: mcmc.cpp:47-98)
    but replaces the random walk with deterministic optimization.
    """

    def __init__(self, *args, maxiter: int = 400, **kwargs):
        super().__init__(*args, **kwargs)
        self.maxiter = maxiter
        rate_idx = np.arange(self.nsources)
        self._free_rates = tuple(
            int(i) for i in rate_idx[~self.parameter_fixed[:self.nsources]])
        syst_idx = np.arange(self.nsources, self.nparameters)
        self._float_systs = tuple(
            int(i) for i in syst_idx
            if not self.parameter_fixed[i])

    # ------------------------------------------------------------------

    def fit(self, data: np.ndarray,
            weights: Optional[np.ndarray] = None) -> FitResult:
        """Run the fit: rates by jitted BFGS; floating systematics by a
        device-batched coordinate-grid descent.

        The event term is piecewise-constant in the systematic
        coefficients (bin assignment is a floor), so gradient descent
        stalls; instead each coefficient is scanned on a shrinking grid
        around the constraint scale, every grid point a full
        rate-profiled solve, and the whole grid is ONE device call
        (_profile_syst_grid) — replacing the serial host Nelder-Mead
        loop of round 1 (~1 device round-trip per simplex move).

        ``weights`` are optional per-event weights on the log term (a
        weight of k is exactly k identical events) — the mechanism that
        makes Asimov datasets (stats.asimov) fittable."""
        self.stack.set_data(np.asarray(data, np.float32))
        read_bins = self.stack._read_bins
        device_data = self.stack.device_data
        w = (jnp.asarray(weights, jnp.float32)
             if weights is not None else None)

        theta_full = np.asarray(self.parameter_means[self.nsources:],
                                np.float32)
        q0 = self._initial_q()

        if self._float_systs:
            theta_full = self._fit_systematics(
                theta_full, q0, read_bins, device_data, w)
        theta_hat = theta_full

        qhat, fmin, ok = self._solve(theta_hat, q0, read_bins,
                                     device_data, w)
        params = self._assemble(np.asarray(qhat), theta_hat)

        cov = self._hessian_covariance(params, read_bins, device_data, w)
        result = FitResult(
            names=list(self.parameter_names), params=params,
            nll=float(fmin), free=~self.parameter_fixed.copy(),
            covariance=cov, converged=bool(ok))
        self._last = (result, read_bins, device_data, w)
        return result

    # ------------------------------------------------------------------

    def _fit_systematics(self, theta: np.ndarray, q0: np.ndarray,
                         read_bins, device_data, weights=None,
                         npasses: int = 4, ngrid: int = 9) -> np.ndarray:
        """Coordinate-grid descent over the floating systematics.

        Per pass and coefficient: scan ``ngrid`` candidates around the
        current value (range 2 sigma, shrinking 3x per pass, final
        resolution ~0.02 sigma), profiled over the rates — each scan is
        one vmapped/lax.map'd device call.  The Gaussian constraint on
        the coefficient itself is inside the NLL, so the search is the
        profile optimum, not the prior mode.
        """
        theta = theta.copy()
        fidx = np.asarray(self._float_systs) - self.nsources
        widths = np.asarray([
            self.parameter_sigma[i] if self.parameter_sigma[i] > 0
            else 0.1 * max(abs(self.parameter_means[i]), 1.0)
            for i in self._float_systs], np.float32)
        for p in range(npasses):
            scale = 2.0 / (3.0 ** p)
            for jj, j in enumerate(fidx):
                grid = (theta[j] + np.linspace(-scale, scale, ngrid,
                                               dtype=np.float32)
                        * widths[jj])
                pnll = np.asarray(_profile_syst_grid(
                    self, jnp.asarray(grid), int(j),
                    tuple(self._free_rates), jnp.asarray(q0),
                    jnp.asarray(theta), read_bins, device_data,
                    self.maxiter, weights))
                theta[j] = grid[int(np.argmin(pnll))]
        return theta

    def profile(self, name: str, values: Sequence[float],
                result: Optional[FitResult] = None) -> np.ndarray:
        """Profiled NLL over a grid: rates re-optimized per point
        (vmapped BFGS — the whole scan is one batched device call).

        Floating systematics other than ``name`` are held at their
        global-fit optimum (a standard profile approximation; pass the
        grid through :meth:`fit` per point for the exact curve).
        """
        result, read_bins, device_data, weights = self._ensure_fit(result)
        values = np.asarray(values, np.float32)
        k = self.parameter_names.index(name)
        theta_hat = np.asarray(result.params[self.nsources:], np.float32)
        q_init = self._q_from_params(result.params)

        if k < self.nsources:
            free = [i for i in self._free_rates if i != k]
            pnll = _profile_rate_grid(
                self, jnp.asarray(values), k, tuple(free),
                jnp.asarray(q_init), jnp.asarray(theta_hat),
                read_bins, device_data, self.maxiter, weights)
            return np.asarray(pnll)

        # Systematic coefficient: re-histogram per grid point (the PDF
        # itself changes), then solve the rates.  lax.map keeps the
        # histogram memory footprint to one grid point at a time.
        j = k - self.nsources
        pnll = _profile_syst_grid(
            self, jnp.asarray(values), j, tuple(self._free_rates),
            jnp.asarray(q_init), jnp.asarray(theta_hat),
            read_bins, device_data, self.maxiter, weights)
        return np.asarray(pnll)

    def profile2d(self, name1: str, name2: str,
                  values1: Sequence[float], values2: Sequence[float],
                  result: Optional[FitResult] = None) -> np.ndarray:
        """Profiled NLL over a 2-D grid of two rate parameters.

        Both parameters are pinned at every (v1, v2) grid node and the
        remaining free rates re-optimized — the whole (n1 x n2) map is
        ONE vmapped BFGS batch.  dNLL = map - map.min() cut at the
        2-dof chi-square quantile (-ln(1-cl) in NLL units) gives joint
        confidence contours; see :func:`profile2d_contour_levels`.

        The reference can only approximate this by scatter-plotting
        MCMC samples (likelihood.cpp:75-101); here it is exact and
        deterministic.  One of the two parameters may be a systematic
        coefficient (the PDFs are then rebuilt once per value of it,
        lax.map'd, with the whole rate axis vmapped inside); OTHER
        floating systematics are held at the global-fit optimum (same
        profile approximation as :meth:`profile`).
        """
        result, read_bins, device_data, weights = self._ensure_fit(result)
        k1 = self.parameter_names.index(name1)
        k2 = self.parameter_names.index(name2)
        if k1 == k2:
            raise ValueError("profile2d needs two distinct parameters")
        if k1 >= self.nsources and k2 >= self.nsources:
            raise ValueError("profile2d supports two rates or one rate "
                             "+ one systematic coefficient; profile "
                             "two systematics one at a time")
        values1 = np.asarray(values1, np.float32)
        values2 = np.asarray(values2, np.float32)
        theta_hat = np.asarray(result.params[self.nsources:], np.float32)
        q_init = self._q_from_params(result.params)

        if k1 >= self.nsources or k2 >= self.nsources:
            # (rate, systematic): rebuild PDFs per systematic value
            # (outer lax.map), vmapped rate solves inside.
            transpose = k1 >= self.nsources
            k_rate, k_syst = (k2, k1) if transpose else (k1, k2)
            v_rate, v_syst = ((values2, values1) if transpose
                              else (values1, values2))
            free = tuple(i for i in self._free_rates if i != k_rate)
            pnll = _profile_rate_syst_grid(
                self, jnp.asarray(v_rate), jnp.asarray(v_syst),
                k_rate, k_syst - self.nsources, free,
                jnp.asarray(q_init), jnp.asarray(theta_hat),
                read_bins, device_data, self.maxiter, weights)
            pnll = np.asarray(pnll)          # (nsyst, nrate)
            return pnll if transpose else pnll.T

        g1, g2 = np.meshgrid(values1, values2, indexing="ij")
        free = tuple(i for i in self._free_rates if i not in (k1, k2))
        pnll = _profile_rate_pair_grid(
            self, jnp.asarray(g1.ravel()), jnp.asarray(g2.ravel()),
            k1, k2, free, jnp.asarray(q_init), jnp.asarray(theta_hat),
            read_bins, device_data, self.maxiter, weights)
        return np.asarray(pnll).reshape(len(values1), len(values2))

    def conditional_fit(self, name: str, value: float,
                        result: Optional[FitResult] = None) -> np.ndarray:
        """Conditional ("hat-hat") fit: re-optimize the other free rates
        with ``name`` pinned at ``value``.

        Returns the full parameter vector of the conditional optimum —
        the standard CLs/q0 prescription generates each hypothesis'
        toys at this point (nuisances refit with r pinned), not at the
        unconditional best fit.  Floating systematics are held at the
        global-fit optimum (profile approximation).
        """
        result, read_bins, device_data, weights = self._ensure_fit(result)
        k = self.parameter_names.index(name)
        free = tuple(i for i in self._free_rates if i != k)
        theta_hat = np.asarray(result.params[self.nsources:], np.float32)
        q_init = self._q_from_params(result.params)
        qhat, _, _ = _solve_rates_pinned(
            self, jnp.float32(value), k, free, jnp.asarray(q_init),
            jnp.asarray(theta_hat), read_bins, device_data, self.maxiter,
            weights)
        params = self._assemble(np.asarray(qhat), theta_hat)
        params[k] = value
        return params

    def profile_interval(self, name: str, cl: float = 0.683,
                         result: Optional[FitResult] = None,
                         ngrid: int = 41) -> Interval:
        """MINOS-style asymmetric interval from profile crossings of
        dNLL = chi2_quantile(cl, 1) / 2."""
        result, _, _, _ = self._ensure_fit(result)
        k = self.parameter_names.index(name)
        vhat = result.value(name)
        sig = result.error(name)
        if not np.isfinite(sig) or sig <= 0:
            sig = max(abs(vhat), 1.0) * 0.1
        lo = vhat - 6.0 * sig
        if k < self.nsources:
            lo = max(lo, 0.0)
        grid = np.linspace(lo, vhat + 6.0 * sig, ngrid, dtype=np.float32)
        pnll = self.profile(name, grid, result)
        target = 0.5 * chi2_quantile_1dof(cl)
        return _interval_from_profile(grid, pnll, vhat, target, cl)

    def upper_limit(self, name: str, cl: float = 0.9,
                    result: Optional[FitResult] = None,
                    ngrid: int = 61) -> float:
        """One-sided profile-likelihood upper limit:
        dNLL crossing at z(cl)^2/2 with z the one-sided normal quantile."""
        result, _, _, _ = self._ensure_fit(result)
        vhat = max(result.value(name), 0.0)
        sig = result.error(name)
        if not np.isfinite(sig) or sig <= 0:
            sig = max(abs(vhat), 1.0) * 0.1
        hi = vhat + 8.0 * sig
        grid = np.linspace(0.0, hi, ngrid, dtype=np.float32)
        pnll = self.profile(name, grid, result)
        z = np.sqrt(2.0) * erfinv(2.0 * cl - 1.0)
        target = 0.5 * z * z
        dn = pnll - pnll.min()
        # Walk outward from the minimum to the first upward crossing.
        imin = int(np.argmin(pnll))
        for i in range(imin, len(grid) - 1):
            if dn[i] <= target <= dn[i + 1]:
                f = (target - dn[i]) / max(dn[i + 1] - dn[i], 1e-12)
                return float(grid[i] + f * (grid[i + 1] - grid[i]))
        return float(grid[-1])

    # ------------------------------------------------------------------
    # internals

    def _initial_q(self) -> np.ndarray:
        r0 = np.maximum(self.parameter_means[:self.nsources], 1e-4)
        return np.log(r0).astype(np.float32)

    def _q_from_params(self, params: np.ndarray) -> np.ndarray:
        r = np.maximum(np.asarray(params[:self.nsources]), 1e-8)
        return np.log(r).astype(np.float32)

    def _assemble(self, qhat: np.ndarray, theta: np.ndarray) -> np.ndarray:
        params = np.concatenate([
            np.asarray(self.parameter_means[:self.nsources], np.float32),
            np.asarray(theta, np.float32)])
        for i in self._free_rates:
            params[i] = np.exp(np.clip(qhat[i], -_LOG_CLAMP, _LOG_CLAMP))
        return params

    def _solve(self, theta, q0, read_bins, device_data, weights=None):
        """Optimize the free rates at fixed systematics."""
        qhat, fun, ok = _solve_rates(
            self, jnp.asarray(theta, jnp.float32),
            jnp.asarray(q0, jnp.float32), tuple(self._free_rates),
            read_bins, device_data, self.maxiter, weights)
        return qhat, float(fun), bool(ok)

    def _hessian_covariance(self, params, read_bins, device_data,
                            weights=None):
        free = ~self.parameter_fixed
        free_idx = np.where(free)[0]
        h = _free_hessian(self, jnp.asarray(params, jnp.float32),
                          tuple(int(i) for i in free_idx),
                          read_bins, device_data, weights)
        h = np.asarray(h, np.float64)
        # A floating systematic with no Gaussian constraint (sigma = 0)
        # has zero curvature everywhere (its event term is
        # piecewise-constant by design), leaving a zero row/column.
        # pinv would silently report zero variance; surface NaN instead.
        degenerate = np.all(h == 0.0, axis=1)
        if degenerate.any():
            import warnings

            names = [self.parameter_names[free_idx[i]]
                     for i in np.where(degenerate)[0]]
            warnings.warn(
                "Hessian is singular: parameter(s) "
                f"{names} have no curvature (unconstrained floating "
                "systematic?); their errors are NaN.")
            keep = ~degenerate
            cov = np.full_like(h, np.nan)
            sub = h[np.ix_(keep, keep)]
            try:
                cov_sub = np.linalg.inv(sub)
            except np.linalg.LinAlgError:
                cov_sub = np.linalg.pinv(sub)
            cov[np.ix_(keep, keep)] = cov_sub
            return cov
        try:
            cov = np.linalg.inv(h)
        except np.linalg.LinAlgError:
            cov = np.linalg.pinv(h)
        return cov

    def _ensure_fit(self, result: Optional[FitResult]):
        if not hasattr(self, "_last"):
            raise RuntimeError("call fit() first")
        if result is None:
            return self._last
        return (result,) + self._last[1:]


def _interval_from_profile(grid: np.ndarray, pnll: np.ndarray,
                           vhat: float, target: float,
                           cl: float) -> Interval:
    """Linear-interpolated dNLL crossings around the profile minimum."""
    dn = np.asarray(pnll, np.float64)
    dn = dn - dn.min()
    imin = int(np.argmin(dn))
    # The unconstrained MLE is the point estimate; the grid argmin only
    # anchors the crossing search.
    point = float(vhat)

    lower = float(grid[0])
    found_lower = False
    for i in range(imin, 0, -1):
        if dn[i] <= target <= dn[i - 1]:
            f = (target - dn[i]) / max(dn[i - 1] - dn[i], 1e-12)
            lower = float(grid[i] + f * (grid[i - 1] - grid[i]))
            found_lower = True
            break
    upper = float(grid[-1])
    for i in range(imin, len(grid) - 1):
        if dn[i] <= target <= dn[i + 1]:
            f = (target - dn[i]) / max(dn[i + 1] - dn[i], 1e-12)
            upper = float(grid[i] + f * (grid[i + 1] - grid[i]))
            break

    one_sided = not found_lower and grid[0] <= 0.0 <= grid[-1]
    return Interval(one_sided=one_sided, point_estimate=point,
                    lower=lower, upper=upper, cl=cl)


# ----------------------------------------------------------------------
# jitted kernels


def _mle_eval(mle: MLE, theta, read_bins, device_data):
    """theta -> (lutlike, norms) in the active likelihood mode: the
    per-event LUT, or the raw histograms when ``mle.binned``."""
    if getattr(mle, "binned", False):
        return mle.stack.histograms(theta, device_data)
    return mle.stack.evaluate(theta, read_bins, device_data)


def _mle_nllf(mle: MLE, read_bins, weights=None):
    """(params, lutlike, norms) -> scalar NLL in the active mode.

    Binned mode regroups the unbinned NLL exactly by (dataset, bin)
    (ops/nll.binned_nll_pair); per-event ``weights`` fold into the
    data bin counts, which is the identical regrouping of the weighted
    log term (a weight of k is exactly k identical events)."""
    if not getattr(mle, "binned", False):
        def f(params, lut, norms):
            return nll_fn(params, lut, norms, mle.static, weights)

        return f

    counts = mle.stack.counts_from_read_bins(read_bins, weights)
    mask = mle.stack.dataset_mask
    bv = mle.stack.bin_volume

    def f(params, hists, norms):
        return binned_nll(params, hists, norms, mle.static, counts,
                          mask, bv)

    return f


def _rate_objective(mle: MLE, theta, lut, norms, free_idx, nllf):
    """q_free -> NLL with rates r = exp(q) scattered at free_idx."""
    base = jnp.concatenate([
        jnp.asarray(mle.parameter_means[:mle.nsources], jnp.float32),
        theta])
    idx = jnp.asarray(free_idx, jnp.int32)

    def fun(qf):
        r = jnp.exp(jnp.clip(qf, -_LOG_CLAMP, _LOG_CLAMP))
        params = base.at[idx].set(r) if len(free_idx) else base
        return nllf(params, lut, norms)

    return fun


def _bfgs(fun, x0, maxiter):
    """BFGS + damped-Newton polish, convergence judged by Minuit's EDM.

    In f32 the objective is rounded at ~eps*|NLL|, which stalls BFGS's
    Wolfe line search well before the gradient is zero.  The polish
    steps use AD gradients/Hessians directly (no objective comparisons,
    so rounding cannot stall them) and drive the remaining estimated
    distance to minimum EDM = g H^-1 g / 2 to ~0.
    """
    from jax.scipy.optimize import minimize

    res = minimize(fun, x0, method="BFGS",
                   options={"maxiter": maxiter, "gtol": 1e-4})
    grad = jax.grad(fun)
    hess = jax.hessian(fun)
    eye = jnp.eye(x0.shape[0], dtype=x0.dtype)

    def newton(x, _):
        g = grad(x)
        h = hess(x) + 1e-4 * eye
        step = jnp.linalg.solve(h, g)
        # Trust region: cap the step; reject non-finite moves (e.g. a
        # singular Hessian at the r -> 0 boundary).
        x_new = x - jnp.clip(step, -1.0, 1.0)
        ok = jnp.all(jnp.isfinite(x_new)) & jnp.isfinite(fun(x_new))
        return jnp.where(ok, x_new, x), None

    x, _ = jax.lax.scan(newton, res.x, None, length=6)
    f = fun(x)
    # Keep whichever point is better (Newton can wander if H is not
    # positive definite far from the optimum).
    better = f <= res.fun
    x = jnp.where(better, x, res.x)
    f = jnp.where(better, f, res.fun)

    g = grad(x)
    h = hess(x) + 1e-4 * eye
    edm = 0.5 * jnp.dot(g, jnp.linalg.solve(h, g))
    # EDM < 0.01: the NLL improvement still available is negligible
    # against the dNLL = 0.5 interval scale (Minuit's criterion).
    return x, f, res.success | (jnp.abs(edm) < 0.01)


@functools.partial(
    jax.jit, static_argnames=("mle", "free_idx", "maxiter"))
def _solve_rates(mle: MLE, theta, q0, free_idx, read_bins, device_data,
                 maxiter: int, weights=None):
    lut, norms = _mle_eval(mle, theta, read_bins, device_data)
    fun = _rate_objective(mle, theta, lut, norms, free_idx,
                          _mle_nllf(mle, read_bins, weights))
    if not free_idx:
        return q0, fun(jnp.zeros((0,), jnp.float32)), jnp.bool_(True)
    x0 = q0[jnp.asarray(free_idx, jnp.int32)]
    x, f, ok = _bfgs(fun, x0, maxiter)
    qhat = q0.at[jnp.asarray(free_idx, jnp.int32)].set(x)
    return qhat, f, ok


@functools.partial(
    jax.jit, static_argnames=("mle", "k", "free_idx", "maxiter"))
def _solve_rates_pinned(mle: MLE, v, k: int, free_idx, q0, theta,
                        read_bins, device_data, maxiter: int,
                        weights=None):
    """Optimize the free rates with rate ``k`` pinned at ``v``."""
    lut, norms = _mle_eval(mle, theta, read_bins, device_data)
    nllf = _mle_nllf(mle, read_bins, weights)
    base = jnp.concatenate([
        jnp.asarray(mle.parameter_means[:mle.nsources], jnp.float32),
        theta]).at[k].set(v)
    idx = jnp.asarray(free_idx, jnp.int32)

    def fun(qf):
        r = jnp.exp(jnp.clip(qf, -_LOG_CLAMP, _LOG_CLAMP))
        params = base.at[idx].set(r) if free_idx else base
        return nllf(params, lut, norms)

    if not free_idx:
        return q0, fun(jnp.zeros((0,), jnp.float32)), jnp.bool_(True)
    x0 = q0[idx]
    x, f, ok = _bfgs(fun, x0, maxiter)
    qhat = q0.at[idx].set(x)
    return qhat, f, ok


@functools.partial(
    jax.jit, static_argnames=("mle", "k", "free_idx", "maxiter"))
def _profile_rate_grid(mle: MLE, values, k: int, free_idx, q_init, theta,
                       read_bins, device_data, maxiter: int,
                       weights=None):
    """Profiled NLL over a grid of one rate: vmapped BFGS solves."""
    lut, norms = _mle_eval(mle, theta, read_bins, device_data)
    nllf = _mle_nllf(mle, read_bins, weights)
    base = jnp.concatenate([
        jnp.asarray(mle.parameter_means[:mle.nsources], jnp.float32),
        theta])

    def one(v):
        pinned = base.at[k].set(v)

        def fun(qf):
            r = jnp.exp(jnp.clip(qf, -_LOG_CLAMP, _LOG_CLAMP))
            params = (pinned.at[jnp.asarray(free_idx, jnp.int32)].set(r)
                      if free_idx else pinned)
            return nllf(params, lut, norms)

        if not free_idx:
            return fun(jnp.zeros((0,), jnp.float32))
        x0 = q_init[jnp.asarray(free_idx, jnp.int32)]
        _, f, _ = _bfgs(fun, x0, maxiter)
        return f

    return jax.vmap(one)(values)


def profile2d_contour_levels(cl_list=(0.683, 0.95)) -> list:
    """dNLL contour levels for JOINT 2-dof confidence regions:
    dNLL = -ln(1 - cl) (chi2 quantile with 2 dof, halved)."""
    return [-np.log(1.0 - cl) for cl in cl_list]


@functools.partial(
    jax.jit,
    static_argnames=("mle", "k1", "k2", "free_idx", "maxiter"))
def _profile_rate_pair_grid(mle: MLE, v1, v2, k1: int, k2: int, free_idx,
                            q_init, theta, read_bins, device_data,
                            maxiter: int, weights=None):
    """Profiled NLL with two rates pinned: vmapped over the flat grid."""
    lut, norms = _mle_eval(mle, theta, read_bins, device_data)
    nllf = _mle_nllf(mle, read_bins, weights)
    base = jnp.concatenate([
        jnp.asarray(mle.parameter_means[:mle.nsources], jnp.float32),
        theta])

    def one(a, b):
        pinned = base.at[k1].set(a).at[k2].set(b)

        def fun(qf):
            r = jnp.exp(jnp.clip(qf, -_LOG_CLAMP, _LOG_CLAMP))
            params = (pinned.at[jnp.asarray(free_idx, jnp.int32)].set(r)
                      if free_idx else pinned)
            return nllf(params, lut, norms)

        if not free_idx:
            return fun(jnp.zeros((0,), jnp.float32))
        x0 = q_init[jnp.asarray(free_idx, jnp.int32)]
        _, f, _ = _bfgs(fun, x0, maxiter)
        return f

    return jax.vmap(one)(v1, v2)


@functools.partial(
    jax.jit,
    static_argnames=("mle", "k_rate", "j_syst", "free_idx", "maxiter"))
def _profile_rate_syst_grid(mle: MLE, v_rate, v_syst, k_rate: int,
                            j_syst: int, free_idx, q_init, theta,
                            read_bins, device_data, maxiter: int,
                            weights=None):
    """Profiled NLL over a (rate x systematic) grid.

    Outer lax.map over the systematic values (each re-histograms every
    PDF once); inner vmap over the pinned-rate solves sharing that
    rebuild.  Returns (nsyst, nrate)."""
    base = jnp.concatenate([
        jnp.asarray(mle.parameter_means[:mle.nsources], jnp.float32),
        theta])
    idx = jnp.asarray(free_idx, jnp.int32)
    x0 = (q_init[idx] if free_idx
          else jnp.zeros((0,), jnp.float32))

    nllf = _mle_nllf(mle, read_bins, weights)

    def one_syst(sv):
        th = theta.at[j_syst].set(sv)
        lut, norms = _mle_eval(mle, th, read_bins, device_data)

        def one_rate(rv):
            pinned = base.at[k_rate].set(rv).at[
                mle.nsources + j_syst].set(sv)

            def fun(qf):
                r = jnp.exp(jnp.clip(qf, -_LOG_CLAMP, _LOG_CLAMP))
                params = pinned.at[idx].set(r) if free_idx else pinned
                return nllf(params, lut, norms)

            if not free_idx:
                return fun(x0)
            _, f, _ = _bfgs(fun, x0, maxiter)
            return f

        return jax.vmap(one_rate)(v_rate)

    return jax.lax.map(one_syst, v_syst)


@functools.partial(
    jax.jit, static_argnames=("mle", "j", "free_idx", "maxiter"))
def _profile_syst_grid(mle: MLE, values, j: int, free_idx, q_init, theta,
                       read_bins, device_data, maxiter: int,
                       weights=None):
    """Profiled NLL over a systematic-coefficient grid.

    Each point re-histograms every PDF (the hot operation,
    mcmc.cpp:264-271); lax.map holds one grid point in memory at a time.
    """

    nllf = _mle_nllf(mle, read_bins, weights)

    def one(v):
        th = theta.at[j].set(v)
        lut, norms = _mle_eval(mle, th, read_bins, device_data)
        fun = _rate_objective(mle, th, lut, norms, free_idx, nllf)
        if not free_idx:
            return fun(jnp.zeros((0,), jnp.float32))
        x0 = q_init[jnp.asarray(free_idx, jnp.int32)]
        _, f, _ = _bfgs(fun, x0, maxiter)
        return f

    return jax.lax.map(one, values)


@functools.partial(jax.jit, static_argnames=("mle", "free_idx"))
def _free_hessian(mle: MLE, params, free_idx, read_bins, device_data,
                  weights=None):
    """Hessian of the NLL over the free parameters, in natural units.

    Rates contribute their smooth event-term curvature; floating
    systematic coefficients are piecewise-constant in the event term so
    only their Gaussian-constraint curvature 1/sigma^2 appears — the
    conditional (constraint-dominated) error, consistent with how the
    reference's random walk explores them.
    """
    idx = jnp.asarray(free_idx, jnp.int32)
    # Histograms evaluated once at the optimum: exact for the rates, and
    # the almost-everywhere-correct choice for systematic coefficients
    # (their event term is locally flat in theta).
    lut0, norms0 = _mle_eval(mle, params[mle.nsources:], read_bins,
                             device_data)
    nllf = _mle_nllf(mle, read_bins, weights)

    def fun(x):
        p = params.at[idx].set(x)
        return nllf(p, lut0, norms0)

    return jax.hessian(fun)(params[idx])
