"""Hypothesis tests: discovery significance and CLs upper limits.

The profile-likelihood-ratio test statistics of Cowan, Cranmer, Gross &
Vitells (arXiv:1007.1727) on top of the gradient MLE:

  * q0   — discovery: q0 = 2 [NLL(r=0) - NLL(r-hat)], 0 if r-hat = 0;
           Z = sqrt(q0) asymptotically (half-chi2 null), or toy-exact.
  * q~r  — upper limits: q_r = 2 [NLL(r) - NLL(r-hat)], 0 if r-hat > r
           (upward fluctuations don't count against a limit);
           CLs(r) = P(q >= q_obs | s+b) / P(q >= q_obs | b-only),
           limit at CLs = 1 - cl (the LHC-standard construction).

Every toy dataset is generated by one batched draw and fit (global +
pinned) inside one vmapped BFGS batch — the same engine as the
Feldman-Cousins belts (stats.feldman_cousins._toy_dnll_batch).

The reference has no hypothesis-testing machinery at all; its nearest
analog is the median-of-upper-limits sensitivity loop (sxmc.cpp:44-148).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import erf, erfinv

from sxmc_jax.generator import make_fake_dataset_batch
from sxmc_jax.stats.asimov import asimov_dataset
from sxmc_jax.stats.feldman_cousins import _toy_dnll_batch
from sxmc_jax.stats.mle import MLE, FitResult


def _norm_cdf(x):
    return 0.5 * (1.0 + erf(np.asarray(x, np.float64) / np.sqrt(2.0)))


@contextlib.contextmanager
def _preserved_fit_state(mle: MLE):
    """Run a side fit (e.g. on an Asimov dataset) without clobbering the
    driver's current dataset state: restores the stack's read bins /
    exact-KDE snapshot and the MLE's last-fit cache on exit."""
    stack = mle.stack
    saved = (stack._read_bins, stack._data_points,
             stack._kde_exact_static_rows, stack._kde_exact_static_norms,
             getattr(mle, "_last", None))
    try:
        yield
    finally:
        (stack._read_bins, stack._data_points,
         stack._kde_exact_static_rows,
         stack._kde_exact_static_norms, last) = saved
        if last is not None:
            mle._last = last
        elif hasattr(mle, "_last"):
            del mle._last


def _norm_sf(x):
    return 0.5 * (1.0 - erf(x / np.sqrt(2.0)))


def _norm_isf(p):
    return np.sqrt(2.0) * erfinv(1.0 - 2.0 * p)


def _cross_alpha(r_grid, vals, alpha):
    """First downward crossing of vals through alpha, linearly
    interpolated.  If the curve starts below alpha the limit lies at or
    below the scan minimum — return r_grid[0] (and warn); only a curve
    that never drops below alpha falls back to the last grid point
    (limit beyond the grid)."""
    if len(r_grid) and vals[0] < alpha:
        import warnings

        warnings.warn(
            f"CLs/q curve already below alpha={alpha:g} at the first "
            f"grid point r={r_grid[0]:g}; the limit lies at or below "
            "the scan minimum — extend the grid downward.")
        return float(r_grid[0])
    for i in range(len(r_grid) - 1):
        if vals[i] >= alpha >= vals[i + 1]:
            f = (vals[i] - alpha) / max(vals[i] - vals[i + 1], 1e-12)
            return float(r_grid[i] + f * (r_grid[i + 1] - r_grid[i]))
    return float(r_grid[-1])


@dataclasses.dataclass
class DiscoveryResult:
    q0: float                 # observed test statistic
    z_asymptotic: float       # sqrt(q0)
    p_asymptotic: float
    z_toys: Optional[float] = None   # from the b-only toy ensemble
    p_toys: Optional[float] = None
    ntoys: int = 0

    def __str__(self):
        s = (f"q0 = {self.q0:.3f}, Z = {self.z_asymptotic:.2f} sigma "
             f"(p = {self.p_asymptotic:.2e}, asymptotic)")
        if self.z_toys is not None:
            s += (f"; Z = {self.z_toys:.2f} sigma "
                  f"(p = {self.p_toys:.2e}, {self.ntoys} toys)")
        return s


@dataclasses.dataclass
class AsymptoticLimit:
    """Observed + expected CLs limits from the Asimov construction."""

    limit: float                       # observed upper limit
    expected: Dict[int, float]         # N sigma -> expected limit
    r_grid: np.ndarray
    cls_obs: np.ndarray
    cl: float

    def __str__(self):
        bands = ", ".join(
            f"{n:+d}s: {v:.4g}" for n, v in sorted(self.expected.items()))
        return (f"r < {self.limit:.4g} ({100 * self.cl:g}% CL, "
                f"asymptotic CLs); expected median "
                f"{self.expected.get(0, float('nan')):.4g} [{bands}]")


class HypoTest:
    """Discovery / CLs tests for one signal rate around a gradient MLE.

    ``fluctuate_systematics=True`` draws each toy's constrained
    systematic coefficients from their Gaussian priors at generation
    (the per-toy fits keep the plug-in theta), propagating systematic
    uncertainty into the toy p-values/limits.
    """

    def __init__(self, mle: MLE, signal_name: str,
                 fluctuate_systematics: bool = False):
        self.mle = mle
        self.signal_name = signal_name
        self.fluctuate_systematics = fluctuate_systematics
        self.k = mle.parameter_names.index(signal_name)
        if self.k >= mle.nsources:
            raise ValueError("Hypothesis tests apply to rate parameters")
        if float(mle.parameter_sigma[self.k]) > 0:
            import warnings

            warnings.warn(
                f"signal rate '{signal_name}' carries a Gaussian "
                "constraint; q0/CLs constructions assume an "
                "UNCONSTRAINED parameter of interest — the constraint "
                "term will pull every test statistic (and collapse "
                "expected bands).  Set the source's sigma to 0 for "
                "standard discovery/limit semantics.")

    # ------------------------------------------------------------------

    def discovery(self, data: np.ndarray, ntoys: int = 0,
                  key=None) -> DiscoveryResult:
        """Discovery significance of the signal (background-only null)."""
        mle = self.mle
        result = mle.fit(np.asarray(data, np.float32))
        pnll0 = float(mle.profile(self.signal_name, [0.0], result)[0])
        rhat = result.value(self.signal_name)
        q0 = max(2.0 * (pnll0 - result.nll), 0.0) if rhat > 0 else 0.0
        z = float(np.sqrt(q0))
        out = DiscoveryResult(q0=q0, z_asymptotic=z,
                              p_asymptotic=float(_norm_sf(z)))

        if ntoys > 0:
            if key is None:
                key = jax.random.PRNGKey(0)
            q_toys, _ = self._toy_stats(
                key, gen_rate=0.0, test_rate=0.0, ntoys=ntoys,
                background_fit=result)
            # Half of b-only toys have r-hat = 0 exactly (q0 = 0); the
            # p-value counts q >= q0_obs among all toys.
            p = float(np.mean(q_toys >= max(q0, 1e-12)))
            p = max(p, 1.0 / (ntoys + 1))
            out.p_toys = p
            out.z_toys = float(_norm_isf(p))
            out.ntoys = ntoys
        return out

    def _cls_at(self, keys, r_grid, q_obs, ntoys, result, verbose):
        """CLs(r) at each grid point from per-point toy ensembles."""
        cls_vals = np.empty(len(r_grid))
        for i, r in enumerate(r_grid):
            q_sb, q_b = self._toy_qs(keys[i], float(r), ntoys,
                                     background_fit=result)
            p_sb = np.mean(q_sb >= q_obs[i] - 1e-9)
            p_b = np.mean(q_b >= q_obs[i] - 1e-9)
            cls_vals[i] = p_sb / max(p_b, 1.0 / ntoys)
            if verbose:
                print(f"CLs: r={r:g} q_obs={q_obs[i]:.3f} "
                      f"p_sb={p_sb:.3f} p_b={p_b:.3f} "
                      f"CLs={cls_vals[i]:.3f}")
        return cls_vals

    def cls_upper_limit(self, key, data: np.ndarray,
                        r_grid: Sequence[float], ntoys: int = 200,
                        cl: float = 0.95, verbose: bool = False,
                        refine: int = 4):
        """CLs upper limit on the signal rate.

        For each r on the grid: observed one-sided q_r, plus s+b and
        b-only toy ensembles of q_r; CLs(r) = p_sb / (1 - p_b); the
        limit interpolates CLs(r) = 1 - cl.  With ``refine > 0``, the
        coarse scan is followed by one refinement pass: that many
        extra grid points inside the bracketing interval of the
        CLs = 1 - cl crossing (same batched toy engine per point), so
        the quoted limit's grid-resolution error is controlled by the
        refined spacing, not the coarse grid.  Returns
        (limit, r_grid, cls_values) with the refined points merged in.
        """
        mle = self.mle
        result = mle.fit(np.asarray(data, np.float32))
        rhat = max(result.value(self.signal_name), 0.0)
        r_grid = np.asarray(r_grid, np.float64)
        alpha = 1.0 - cl

        def observed_q(grid):
            pnll = mle.profile(self.signal_name,
                               grid.astype(np.float32), result)
            q = np.maximum(2.0 * (pnll - result.nll), 0.0)
            return np.where(grid < rhat, 0.0, q)  # one-sided (q~_r)

        key, k_ref = jax.random.split(key)
        q_obs = observed_q(r_grid)
        keys = jax.random.split(key, len(r_grid))
        cls_vals = self._cls_at(keys, r_grid, q_obs, ntoys, result,
                                verbose)

        # Refinement: locate the coarse crossing bracket and rescan
        # inside it.
        bracket = None
        for i in range(len(r_grid) - 1):
            if cls_vals[i] >= alpha >= cls_vals[i + 1]:
                bracket = i
                break
        if refine > 0 and bracket is not None:
            sub = np.linspace(r_grid[bracket], r_grid[bracket + 1],
                              refine + 2)[1:-1]
            q_sub = observed_q(sub)
            sub_keys = jax.random.split(k_ref, len(sub))
            cls_sub = self._cls_at(sub_keys, sub, q_sub, ntoys, result,
                                   verbose)
            r_all = np.concatenate([r_grid, sub])
            order = np.argsort(r_all)
            r_grid = r_all[order]
            cls_vals = np.concatenate([cls_vals, cls_sub])[order]

        return (_cross_alpha(r_grid, cls_vals, 1.0 - cl), r_grid,
                cls_vals)

    # ------------------------------------------------------------------

    def cls_expected_band(self, key, r_grid: Sequence[float],
                          ntoys: int = 200, cl: float = 0.95,
                          background_fit: Optional[FitResult] = None,
                          quantiles=(0.025, 0.16, 0.5, 0.84, 0.975)):
        """Expected CLs limits (the "Brazil band") from b-only toys.

        ``quantiles`` are quantiles of the LIMIT distribution: kappa =
        0.5 is the median expected limit, 0.16/0.84 the +-1 sigma band.
        A kappa-quantile limit corresponds to the (1-kappa)-quantile of
        the b-only q~_r distribution (a background deficit -> large q ->
        low limit), so CLs_exp(r) = P(q_sb >= q_b^(1-kappa)) / kappa and
        the crossing at 1 - cl is that band edge.  Pass no
        background_fit to use the nominal (pre-data) background rates.

        Tail quantiles need statistics: the CLs_exp resolution at
        quantile kappa is 1/(ntoys*kappa), so resolving the crossing at
        alpha = 1-cl requires ntoys >> 1/(kappa*alpha) (e.g. the -1
        sigma edge at 95% CL wants ntoys ≳ 1000); with too few toys a
        band edge falls back to the last grid point.

        Returns {kappa: expected_limit}.
        """
        r_grid = np.asarray(r_grid, np.float64)
        cls_exp = {q: np.empty(len(r_grid)) for q in quantiles}
        keys = jax.random.split(key, len(r_grid))
        for i, r in enumerate(r_grid):
            q_sb, q_b = self._toy_qs(keys[i], float(r), ntoys,
                                     background_fit=background_fit)
            for kq in quantiles:
                qcut = np.quantile(q_b, 1.0 - kq)
                p_sb = np.mean(q_sb >= qcut - 1e-9)
                cls_exp[kq][i] = p_sb / max(kq, 1e-6)

        return {kq: _cross_alpha(r_grid, cls_exp[kq], 1.0 - cl)
                for kq in quantiles}

    # ------------------------------------------------------------------
    # Asymptotic (Asimov) variants: deterministic, no toys.

    def asymptotic_significance(self, rate: float,
                                params: Optional[np.ndarray] = None
                                ) -> DiscoveryResult:
        """Median expected discovery significance for a true signal rate,
        from the Asimov dataset (arXiv:1007.1727 sec. 3.3): Z_med =
        sqrt(q0_A) — no toy ensemble needed.

        ``params`` optionally sets the generation point for the OTHER
        parameters (defaults to the nominal means)."""
        mle = self.mle
        with _preserved_fit_state(mle):
            a_data, a_w = asimov_dataset(
                mle, params=params,
                overrides={self.signal_name: float(rate)})
            a_res = mle.fit(a_data, weights=a_w)
            pnll0 = float(mle.profile(self.signal_name, [0.0], a_res)[0])
            q0 = max(2.0 * (pnll0 - a_res.nll), 0.0)
        z = float(np.sqrt(q0))
        return DiscoveryResult(q0=q0, z_asymptotic=z,
                               p_asymptotic=float(_norm_sf(z)))

    def asymptotic_upper_limit(self, data: np.ndarray,
                               r_grid: Sequence[float],
                               cl: float = 0.95) -> AsymptoticLimit:
        """Observed CLs upper limit + expected (Brazil) band, asymptotic.

        The q~_r distributions under s+b and b-only are replaced by
        their asymptotic forms with the scale sigma^2 = r^2 / q_r,A
        taken from a background-only Asimov fit (generated at the
        conditional r=0 "hat-hat" background point, then profiled over
        the same grid — one deterministic fit instead of
        len(r_grid) * ntoys toy fits):

            CLs+b = 1 - Phi(sqrt(q))                (q <= q_A)
                    1 - Phi((q + q_A) / (2 sqrt(q_A)))   (q > q_A)
            CLb   = 1 - Phi(sqrt(q) - sqrt(q_A))    (q <= q_A)
                    1 - Phi((q - q_A) / (2 sqrt(q_A)))   (q > q_A)

        and the N-sigma expected band solves
        (1 - Phi(sqrt(q_A) - N)) / Phi(N) = 1 - cl
        (arXiv:1007.1727 eqs. 62-66, arXiv:1307.1427 eq. 38).
        """
        mle = self.mle
        result = mle.fit(np.asarray(data, np.float32))
        rhat = max(result.value(self.signal_name), 0.0)
        r_grid = np.asarray(r_grid, np.float64)

        pnll = mle.profile(self.signal_name,
                           r_grid.astype(np.float32), result)
        q_obs = np.maximum(2.0 * (np.asarray(pnll, np.float64)
                                  - result.nll), 0.0)
        q_obs = np.where(r_grid < rhat, 0.0, q_obs)

        cond = mle.conditional_fit(self.signal_name, 0.0, result)
        q_a = self._asimov_q(cond, r_grid)

        sqrt_q = np.sqrt(q_obs)
        sqrt_qa = np.sqrt(q_a)
        cls_obs = np.ones(len(r_grid))
        for i in range(len(r_grid)):
            if sqrt_qa[i] <= 0.0:
                continue
            if sqrt_q[i] <= sqrt_qa[i]:
                clsb = _norm_sf(sqrt_q[i])
                clb = _norm_sf(sqrt_q[i] - sqrt_qa[i])
            else:
                clsb = _norm_sf((q_obs[i] + q_a[i]) / (2.0 * sqrt_qa[i]))
                clb = _norm_sf((q_obs[i] - q_a[i]) / (2.0 * sqrt_qa[i]))
            cls_obs[i] = clsb / max(clb, 1e-12)

        limit = _cross_alpha(r_grid, cls_obs, 1.0 - cl)

        expected = {}
        for n in (-2, -1, 0, 1, 2):
            cls_exp = _norm_sf(sqrt_qa - n) / max(_norm_cdf(n), 1e-12)
            expected[n] = _cross_alpha(r_grid, cls_exp, 1.0 - cl)

        return AsymptoticLimit(limit=limit, expected=expected,
                               r_grid=r_grid, cls_obs=cls_obs, cl=cl)

    def _asimov_q(self, params_bkg: np.ndarray,
                  r_grid: np.ndarray) -> np.ndarray:
        """q_r,A over the grid from one background-only Asimov fit."""
        mle = self.mle
        with _preserved_fit_state(mle):
            a_data, a_w = asimov_dataset(
                mle, params=params_bkg,
                overrides={self.signal_name: 0.0})
            a_res = mle.fit(a_data, weights=a_w)
            grid0 = np.concatenate(
                [[0.0], r_grid]).astype(np.float32)
            a_pnll = np.asarray(
                mle.profile(self.signal_name, grid0, a_res), np.float64)
        # r-hat of the b-only Asimov is exactly 0, so its profile at 0
        # is the unconditional minimum (robust against the log-rate
        # boundary clamp in the unconditional solve).
        return np.maximum(2.0 * (a_pnll[1:] - a_pnll[0]), 0.0)

    # ------------------------------------------------------------------

    def _toy_qs(self, key, r: float, ntoys: int,
                background_fit: Optional[FitResult] = None):
        """One-sided q~_r toy ensembles at rate r: (s+b toys, b-only
        toys), with upward fluctuations (r_hat > r) zeroed."""
        k_sb, k_b = jax.random.split(key)
        q_sb, rhat_sb = self._toy_stats(
            k_sb, gen_rate=r, test_rate=r, ntoys=ntoys,
            background_fit=background_fit)
        q_b, rhat_b = self._toy_stats(
            k_b, gen_rate=0.0, test_rate=r, ntoys=ntoys,
            background_fit=background_fit)
        return (np.where(rhat_sb > r, 0.0, q_sb),
                np.where(rhat_b > r, 0.0, q_b))

    def _toy_stats(self, key, gen_rate: float, test_rate: float,
                   ntoys: int,
                   background_fit: Optional[FitResult] = None):
        """Generate toys at gen_rate and return (q = 2 dNLL at
        test_rate, r_hat) per toy.

        With a ``background_fit``, the other rates come from the
        CONDITIONAL fit with the signal pinned at gen_rate (the
        standard CLs/q0 "hat-hat" prescription — b-only toys use the
        r=0 refit backgrounds, s+b toys the r=r refit).  Without one
        (pre-data expected bands) the nominal means are plugged in."""
        mle = self.mle
        if background_fit is not None:
            if hasattr(mle, "_last"):
                cond = mle.conditional_fit(self.signal_name, gen_rate,
                                           background_fit)
            else:
                # No dataset attached (pre-data band with an external
                # fit result): fall back to its unconditional values.
                cond = np.asarray(background_fit.params)
        else:
            cond = None
        rates = {}
        for sig in mle.signals:
            if cond is not None:
                base = cond[sig.source.index]
            else:
                base = mle.parameter_means[sig.source.index]
            rates[sig.name] = max(float(base), 0.0)
            if sig.source.index == self.k:
                rates[sig.name] = gen_rate
        batch = make_fake_dataset_batch(
            key, mle.signals, mle.systematics, mle.observables, ntoys,
            poisson=True, stack=mle.stack, rates=rates,
            fluctuate_systematics=self.fluctuate_systematics)
        rb = jnp.asarray(np.asarray(mle.stack.compute_read_bins(batch)))
        dnll, rhat = _toy_dnll_batch(
            mle, jnp.full((ntoys,), test_rate, jnp.float32), rb,
            mle.stack.device_data, self.k, tuple(mle._free_rates),
            mle.maxiter)
        return 2.0 * np.asarray(dnll), np.asarray(rhat)
