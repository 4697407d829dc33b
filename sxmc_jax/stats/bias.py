"""Ensemble bias / pull studies: fit-validation by batched toys.

A pull study validates the whole fit machinery: generate many toy
datasets at known true rates, fit each, and histogram the pulls

    g_j = (r_hat_j - r_true_j) / sigma_hat_j .

An unbiased fit with correct errors gives pull mean 0 and width 1 per
parameter; a biased estimator or mis-calibrated Hessian shows up
immediately.  This is the standard pre-unblinding validation for
rare-event fits — the reference has no such machinery (its ensemble
loop only medians the upper limits, sxmc.cpp:110-127, leaving bias
checks to the user's own scripts).

Batched design: all toys are generated as ONE padded batch
(generator.make_fake_dataset_batch) and fit as ONE vmapped BFGS batch
(the engine of stats.feldman_cousins); per-toy errors come from a
vmapped rate-space Hessian.  Thousands of full fits run in a single
device call.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sxmc_jax.generator import make_fake_dataset_batch
from sxmc_jax.stats.intervals import chi2_quantile_1dof
from sxmc_jax.stats.mle import (MLE, _bfgs, _LOG_CLAMP, _mle_eval, _mle_nllf)


@dataclasses.dataclass
class PullStudy:
    """Pull distributions of the free rate parameters over a toy
    ensemble."""

    names: List[str]          # free rate parameters, in order
    true_rates: np.ndarray    # (nfree,) generation values
    estimates: np.ndarray     # (ntoys, nfree) per-toy MLEs
    errors: np.ndarray        # (ntoys, nfree) per-toy Hessian errors
    cl: float                 # confidence level for the coverage column
    ntoys: int

    @property
    def pulls(self) -> np.ndarray:
        """(ntoys, nfree); NaN where a toy's error was unusable."""
        err = np.where(self.errors > 0, self.errors, np.nan)
        return (self.estimates - self.true_rates[None, :]) / err

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per parameter: pull mean/width, mean error, coverage of the
        +-z(cl) interval, and the count of usable toys."""
        z = float(np.sqrt(chi2_quantile_1dof(self.cl)))
        pulls = self.pulls
        out = {}
        for j, name in enumerate(self.names):
            p = pulls[:, j]
            ok = np.isfinite(p)
            n = int(ok.sum())
            pj = p[ok]
            out[name] = {
                "true": float(self.true_rates[j]),
                "pull_mean": float(pj.mean()) if n else float("nan"),
                "pull_std": float(pj.std(ddof=1)) if n > 1
                else float("nan"),
                "mean_error": float(self.errors[ok, j].mean()) if n
                else float("nan"),
                "coverage": float((np.abs(pj) <= z).mean()) if n
                else float("nan"),
                "n_used": n,
            }
        return out

    def __str__(self) -> str:
        lines = [f"-- Pull study ({self.ntoys} toys) --",
                 f" {'parameter':<12} {'true':>8} {'pull mean':>10} "
                 f"{'pull width':>10} {'coverage':>9}  (target "
                 f"{self.cl:.0%})"]
        for name, s in self.summary().items():
            lines.append(
                f" {name:<12} {s['true']:>8.4g} {s['pull_mean']:>10.3f} "
                f"{s['pull_std']:>10.3f} {s['coverage']:>9.3f}  "
                f"[{s['n_used']} toys]")
        return "\n".join(lines)


def pull_study(mle: MLE, ntoys: int, key,
               rates: Optional[Dict[str, float]] = None,
               cl: float = 0.683,
               fluctuate_systematics: bool = False,
               mesh=None) -> PullStudy:
    """Run a pull/bias study around a gradient MLE.

    Args:
        mle: the fit driver (stats.mle.MLE).
        ntoys: number of toy experiments (one vmapped fit batch).
        key: jax PRNG key.
        rates: optional true rates by PARAMETER name (defaults to the
            nominal means); e.g. ``{"signal": 0.0}`` for a
        background-only bias check.
        cl: confidence level scored by the coverage column.
        fluctuate_systematics: draw each toy's constrained systematic
            coefficients from their priors at generation.
        mesh: optional jax.sharding.Mesh — the toy-fit batch is
            sharded over every mesh axis (identical results,
            parallel.toys_sharded).

    Returns:
        PullStudy over the free (non-fixed) rate parameters.
    """
    truth = np.asarray(mle.parameter_means, np.float64).copy()
    if rates:
        for name, value in rates.items():
            truth[mle.parameter_names.index(name)] = value

    gen_rates = {}
    for sig in mle.signals:
        gen_rates[sig.name] = max(float(truth[sig.source.index]), 0.0)

    batch = make_fake_dataset_batch(
        key, mle.signals, mle.systematics, mle.observables, ntoys,
        poisson=True, stack=mle.stack, rates=gen_rates,
        fluctuate_systematics=fluctuate_systematics)
    rb = jnp.asarray(np.asarray(mle.stack.compute_read_bins(batch)))

    if mesh is not None:
        from sxmc_jax.parallel.toys_sharded import sharded_pull_batch

        rhat, err = sharded_pull_batch(
            mesh, mle, rb, tuple(mle._free_rates), mle.maxiter)
    else:
        rhat, err = _toy_fit_batch(
            mle, rb, mle.stack.device_data, tuple(mle._free_rates),
            mle.maxiter)
    rhat = np.asarray(rhat)
    err = np.asarray(err)

    free = list(mle._free_rates)
    names = [mle.parameter_names[i] for i in free]
    return PullStudy(names=names,
                     true_rates=truth[np.asarray(free, int)],
                     estimates=rhat, errors=err, cl=cl, ntoys=ntoys)


@functools.partial(
    jax.jit, static_argnames=("mle", "free_idx", "maxiter"))
def _toy_fit_batch(mle: MLE, read_bins_batch, device_data, free_idx,
                   maxiter: int):
    """Per toy: global fit of the free rates -> (r_hat, sigma_hat).

    The fit optimizes log-rates (BFGS, as stats.mle) but the errors are
    the RATE-space Hessian's inverse square-root diagonal, matching
    FitResult.error; a non-positive curvature reports sigma = -1 (the
    caller maps it to NaN pulls).  Systematics are held at nominal
    (plug-in), like the other toy ensembles.
    """
    theta = jnp.asarray(mle.parameter_means[mle.nsources:], jnp.float32)
    means = jnp.asarray(mle.parameter_means[:mle.nsources], jnp.float32)
    base = jnp.concatenate([means, theta])
    idx = jnp.asarray(free_idx, jnp.int32)
    q0 = jnp.log(jnp.maximum(means, 1e-4))[idx]

    def one(rb):
        lut, norms = _mle_eval(mle, theta, rb, device_data)
        nllf = _mle_nllf(mle, rb)

        def fun_q(qf):
            r = jnp.exp(jnp.clip(qf, -_LOG_CLAMP, _LOG_CLAMP))
            return nllf(base.at[idx].set(r), lut, norms)

        x, _, _ = _bfgs(fun_q, q0, maxiter)
        rhat = jnp.exp(jnp.clip(x, -_LOG_CLAMP, _LOG_CLAMP))

        def fun_r(rf):
            return nllf(base.at[idx].set(rf), lut, norms)

        h = jax.hessian(fun_r)(rhat)
        cov = jnp.linalg.inv(h)
        var = jnp.diagonal(cov)
        ok = jnp.isfinite(var) & (var > 0)
        err = jnp.where(ok, jnp.sqrt(jnp.where(ok, var, 1.0)), -1.0)
        return rhat, err

    return jax.vmap(one)(read_bins_batch)
