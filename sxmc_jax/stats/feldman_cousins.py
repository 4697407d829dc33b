"""Feldman-Cousins confidence intervals via batched toy fits.

A frequentist construction the reference could not afford: the unified
(likelihood-ratio-ordered) intervals of Feldman & Cousins (1998) require
fitting thousands of pseudo-experiments, which here run as ONE vmapped
device call — every toy's global fit and pinned fit are BFGS solves
batched through a single compiled kernel (sxmc_jax.stats.mle).

Construction (profile-likelihood variant, nuisances plugged in at their
nominal values for toy generation):

  for each r_true on a grid:
      generate N toy datasets with the signal injected at r_true
      for each toy: d(r_true) = NLL(r_true, rates-hat-hat) - NLL(r-hat)
      critical value c(r_true) = cl-quantile of d
  interval for the observed data = { r : d_obs(r) <= c(r) }

which unifies upper limits and two-sided intervals with exact frequentist
coverage — no flip-flopping between estimators (the reference's contour /
projection switch, error_estimator.h:46).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sxmc_jax.generator import make_fake_dataset_batch
from sxmc_jax.stats.intervals import Interval
from sxmc_jax.stats.mle import (MLE, _bfgs, _LOG_CLAMP, _mle_eval, _mle_nllf)


@dataclasses.dataclass
class Belt:
    """A Feldman-Cousins confidence belt for one parameter."""

    name: str
    cl: float
    r_grid: np.ndarray        # (G,) true-value grid
    crit: np.ndarray          # (G,) critical dNLL per grid point
    dnll_toys: np.ndarray     # (G, ntoys) the full toy dNLL distributions


class FeldmanCousins:
    """FC interval construction around a gradient MLE fit."""

    def __init__(self, mle: MLE, signal_name: str):
        self.mle = mle
        self.signal_name = signal_name
        self.k = mle.parameter_names.index(signal_name)
        if self.k >= mle.nsources:
            raise ValueError("Feldman-Cousins applies to rate parameters")

    # ------------------------------------------------------------------

    def build_belt(self, key, r_grid: Sequence[float], ntoys: int = 200,
                   cl: float = 0.9, verbose: bool = False,
                   fluctuate_systematics: bool = False,
                   mesh=None) -> Belt:
        """Toy-MC the belt: (G * ntoys) datasets, one vmapped fit batch.

        ``fluctuate_systematics=True`` draws each toy's constrained
        systematic coefficients from their priors (generator-level
        propagation; the per-toy fits keep the plug-in theta), which
        widens the belt accordingly.

        ``mesh``: optional jax.sharding.Mesh — the (grid x toys) fit
        batch is sharded over every mesh axis (identical results,
        parallel.toys_sharded), so a pod-slice builds the belt in
        ntoys / ndevices fit-time.
        """
        mle = self.mle
        r_grid = np.asarray(r_grid, np.float32)

        # --- generate all toys, one batched call per grid point, padded
        # to a common length.  Padding rows carry dataset tag -1 ->
        # read-bin sentinel -2 -> provably invisible to the NLL
        # (pdf.stack.compute_read_bins).
        per_point = []
        keys = jax.random.split(key, len(r_grid))
        for gi, r in enumerate(r_grid):
            per_point.append(make_fake_dataset_batch(
                keys[gi], self._signals, self._systematics,
                self._observables, ntoys, poisson=True, stack=mle.stack,
                rates=self._toy_rates(float(r)),
                fluctuate_systematics=fluctuate_systematics))
        nev_max = max(max(p.shape[1] for p in per_point), 1)
        width = per_point[0].shape[2]
        batch = np.full((len(r_grid) * ntoys, nev_max, width), -1.0,
                        np.float32)
        batch[..., :-1] = 0.0
        for gi, p in enumerate(per_point):
            batch[gi * ntoys:(gi + 1) * ntoys, :p.shape[1]] = p

        rb = np.asarray(mle.stack.compute_read_bins(batch))
        r_values = np.repeat(r_grid, ntoys)

        if mesh is not None:
            from sxmc_jax.parallel.toys_sharded import sharded_toy_dnll

            dnll, _ = sharded_toy_dnll(
                mesh, mle, r_values, rb, self.k,
                tuple(mle._free_rates), mle.maxiter)
        else:
            dnll, _ = _toy_dnll_batch(
                mle, jnp.asarray(r_values), jnp.asarray(rb),
                mle.stack.device_data, self.k,
                tuple(mle._free_rates), mle.maxiter)
        dnll = np.asarray(dnll).reshape(len(r_grid), ntoys)

        crit = np.quantile(dnll, cl, axis=1)
        if verbose:
            for r, c in zip(r_grid, crit):
                print(f"FC belt: r_true={r:g} crit dNLL={c:.3f}")
        return Belt(name=self.signal_name, cl=cl, r_grid=r_grid,
                    crit=crit, dnll_toys=dnll)

    def interval(self, data: np.ndarray, belt: Belt,
                 result=None) -> Interval:
        """Observed FC interval: profile dNLL vs the belt's criticals."""
        mle = self.mle
        if result is None:
            result = mle.fit(np.asarray(data, np.float32))
        pnll = mle.profile(self.signal_name, belt.r_grid, result)
        dnll_obs = pnll - result.nll

        accepted = dnll_obs <= belt.crit
        if not accepted.any():
            # Pathological (undersampled belt); accept the closest point.
            accepted[int(np.argmin(dnll_obs - belt.crit))] = True
        idx = np.where(accepted)[0]
        lo = _refine(belt.r_grid, dnll_obs - belt.crit, idx[0], -1)
        hi = _refine(belt.r_grid, dnll_obs - belt.crit, idx[-1], +1)
        one_sided = idx[0] == 0 and belt.r_grid[0] <= 0.0
        return Interval(one_sided=bool(one_sided),
                        point_estimate=result.value(self.signal_name),
                        lower=float(lo), upper=float(hi), cl=belt.cl)

    def run(self, key, data: np.ndarray, r_grid: Sequence[float],
            ntoys: int = 200, cl: float = 0.9,
            verbose: bool = False) -> Interval:
        """Belt + observed interval in one call."""
        belt = self.build_belt(key, r_grid, ntoys, cl, verbose)
        self.last_belt = belt
        return self.interval(data, belt)

    # ------------------------------------------------------------------

    def _toy_rates(self, r: float) -> Dict[str, float]:
        """Injection rates for belt toys, keyed by SIGNAL name.

        ``signal_name`` is a parameter (source) name: every signal fed
        by that source is injected at ``r``; all other signals are
        generated at their sources' nominal means (plug-in values) —
        the same mapping HypoTest._toy_stats uses.
        """
        rates = {}
        for sig in self.mle.signals:
            if sig.source.index == self.k:
                rates[sig.name] = r
            else:
                base = self.mle.parameter_means[sig.source.index]
                rates[sig.name] = max(float(base), 0.0)
        return rates

    @property
    def _signals(self):
        return self.mle.signals

    @property
    def _systematics(self):
        return self.mle.systematics

    @property
    def _observables(self):
        return self.mle.observables


def _refine(grid, excess, i, direction):
    """Linear crossing of excess=0 between grid[i] and its neighbor."""
    j = i + direction
    if j < 0 or j >= len(grid) or excess[i] == excess[j]:
        return grid[i]
    f = excess[i] / (excess[i] - excess[j])
    f = min(max(f, 0.0), 1.0)
    return grid[i] + f * (grid[j] - grid[i])


@functools.partial(
    jax.jit, static_argnames=("mle", "k", "free_idx", "maxiter"))
def _toy_dnll_batch(mle: MLE, r_values, read_bins_batch, device_data,
                    k: int, free_idx, maxiter: int):
    """Per toy: (dNLL, r_hat) with
    dNLL = NLL(r pinned, others profiled) - NLL(global min)
    and r_hat the toy's unconstrained signal-rate MLE (needed by
    one-sided test statistics, stats.cls).

    Systematics are held at nominal (plug-in construction); both fits
    per toy are BFGS solves, vmapped over the whole (grid x toys) batch.
    """
    theta = jnp.asarray(mle.parameter_means[mle.nsources:], jnp.float32)
    means = jnp.asarray(mle.parameter_means[:mle.nsources], jnp.float32)
    base = jnp.concatenate([means, theta])
    q0_all = jnp.log(jnp.maximum(means, 1e-4))
    free_noK = tuple(i for i in free_idx if i != k)

    def solve(nllf, lut, norms, pinned, idxs):
        idx = jnp.asarray(idxs, jnp.int32)

        def fun(qf):
            r = jnp.exp(jnp.clip(qf, -_LOG_CLAMP, _LOG_CLAMP))
            return nllf(pinned.at[idx].set(r), lut, norms)

        if not idxs:
            return jnp.zeros((0,), jnp.float32), \
                fun(jnp.zeros((0,), jnp.float32))
        x, f, _ = _bfgs(fun, q0_all[idx], maxiter)
        return x, f

    k_in_free = free_idx.index(k) if k in free_idx else -1

    def one(rv, rb):
        lut, norms = _mle_eval(mle, theta, rb, device_data)
        nllf = _mle_nllf(mle, rb)
        x_hat, f_hat = solve(nllf, lut, norms, base, free_idx)
        _, f_pin = solve(nllf, lut, norms, base.at[k].set(rv), free_noK)
        rhat = jnp.exp(x_hat[k_in_free]) if k_in_free >= 0 else base[k]
        return jnp.maximum(f_pin - f_hat, 0.0), rhat

    return jax.vmap(one)(r_values, read_bins_batch)
