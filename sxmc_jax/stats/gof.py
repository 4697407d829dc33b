"""Goodness-of-fit: saturated-likelihood chi2 and posterior-predictive
p-values.

The reference offers no goodness-of-fit machinery at all (its closest
artifact is the visual data/total overlay in plots.cpp); this module
adds the two standard checks for extended-ML fits:

  * Baker-Cousins saturated chi2 (Baker & Cousins, NIM 221 (1984) 437):
    the data is binned on the fit's observable grid per dataset, the
    best-fit model's expected counts are assembled from the same
    histograms the NLL uses (mu_i = sum_j rate_j * nexpected_j *
    hists_j[i] / n_mc_j, the binned analog of
    reference nll_kernels.cpp:105-107), and

        chi2 = 2 * sum_i [ mu_i - n_i + n_i * ln(n_i / mu_i) ]

    which is asymptotically chi-square with (occupied bins - floating
    parameters) degrees of freedom.

  * An exact finite-sample p-value by posterior-predictive simulation:
    ``ntoys`` datasets are drawn from the best-fit model (rates AND
    systematics pinned at the fit, via the batched toy generator) and
    the p-value is the fraction of toys whose saturated chi2 exceeds
    the data's.  The toy chi2s are computed in one vectorized pass.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import jax
import numpy as np

from sxmc_jax.ops import histogram as hist_ops
from sxmc_jax.signal import Observable, Signal, Source, Systematic


@dataclasses.dataclass
class GofResult:
    """Goodness-of-fit summary.

    chi2: Baker-Cousins saturated likelihood-ratio statistic on the data.
    ndof: occupied-model bins minus floating parameters.
    p_asymptotic: chi-square survival probability (None without scipy).
    p_toys: exact posterior-predictive p-value (None when ntoys == 0).
    chi2_toys: the toy statistics (empty when ntoys == 0).
    """

    chi2: float
    ndof: int
    p_asymptotic: Optional[float]
    p_toys: Optional[float] = None
    chi2_toys: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))

    def __str__(self) -> str:
        s = f"chi2/ndof = {self.chi2:.2f}/{self.ndof}"
        if self.p_asymptotic is not None:
            s += f", p(asymptotic) = {self.p_asymptotic:.3f}"
        if self.p_toys is not None:
            s += f", p(toys) = {self.p_toys:.3f}"
        return s


def _observed_counts(data: np.ndarray, stack, datasets) -> np.ndarray:
    """Per-dataset binned counts of the observed events.

    Uses the same bin-id math as the NLL's read-bin precompute
    (pdf.stack.compute_read_bins), so data binning is consistent with
    the model's histograms.  Returns (ndatasets, total_nbins) float64.
    """
    data = np.asarray(data, np.float32)
    nobs = stack.nobservables
    ids, valid = hist_ops.compute_bin_ids(
        jax.numpy.asarray(data[:, :nobs]), stack.lower, stack.upper,
        stack.nbins)
    ids = np.asarray(ids)
    valid = np.asarray(valid)
    tags = data[:, nobs]
    out = np.zeros((len(datasets), stack.total_nbins), np.float64)
    for d, ds in enumerate(datasets):
        sel = valid & (tags == ds)
        out[d] = np.bincount(ids[sel], minlength=stack.total_nbins)
    return out


def _expected_counts(params, stack, signals, nsources,
                     datasets) -> np.ndarray:
    """Per-dataset expected counts on the bin grid at ``params``.

    mu_i(d) = sum_{j in d} rate_j * nexpected_j * hists_j[i] / n_mc_j
    — identical weighting to the NLL's expected-count term
    (ops/nll.signal_weights; reference nll_kernels.cpp:105-107,
    149-188), just left unsummed over bins.
    """
    params = np.asarray(params, np.float32)
    hists, _ = stack.histograms(
        jax.numpy.asarray(params[nsources:], jax.numpy.float32))
    hists = np.asarray(hists, np.float64)
    out = np.zeros((len(datasets), stack.total_nbins), np.float64)
    for j, sig in enumerate(signals):
        d = datasets.index(sig.dataset)
        rate = float(params[sig.source.index])
        out[d] += rate * sig.nexpected * hists[j] / sig.n_mc
    return out


def baker_cousins_chi2(observed: np.ndarray,
                       expected: np.ndarray) -> float:
    """2 * sum_i [mu_i - n_i + n_i ln(n_i / mu_i)] over occupied bins.

    Bins with mu == 0 and n == 0 contribute nothing; mu == 0 with
    n > 0 is clamped to a tiny floor (a model that forbids observed
    events shows up as a huge chi2, not an inf/NaN).
    """
    mu = np.asarray(expected, np.float64).reshape(-1)
    n = np.asarray(observed, np.float64).reshape(-1)
    mu_safe = np.maximum(mu, 1e-12)
    ratio = np.where(n > 0, n / mu_safe, 1.0)
    terms = mu - n + n * np.log(ratio)
    return float(2.0 * np.where((mu > 0) | (n > 0), terms, 0.0).sum())


def _refit_toy_rates(sources, signals, systematics, observables,
                     best_params, batch, stack, nsources):
    """Refit each toy's free rates (systematics pinned at the best-fit
    theta) — one vmapped BFGS batch, the Feldman-Cousins inner-loop
    machinery (stats.feldman_cousins._toy_dnll_batch pattern).

    Returns ``(ntoys, nsources)`` fitted rate vectors.
    """
    import jax.numpy as jnp

    from sxmc_jax.pdf.evalhist import eval_from_bins
    from sxmc_jax.stats.mle import _LOG_CLAMP, MLE, _bfgs
    from sxmc_jax.ops.nll import nll as nll_fn

    mle = MLE(sources, signals, systematics, observables)
    theta = jnp.asarray(best_params[nsources:], jnp.float32)
    pinned = jnp.asarray(best_params, jnp.float32)
    free_idx = tuple(mle._free_rates)

    rb_toys = jnp.asarray(np.asarray(stack.compute_read_bins(batch)))
    # Systematics are pinned, so the binned PDFs are toy-invariant:
    # build once, LUT per toy is a pure gather (no kernel rebuilds).
    hists, norms = stack.histograms(theta)

    q0 = jnp.log(jnp.maximum(pinned[jnp.asarray(free_idx)], 1e-4)) \
        if free_idx else jnp.zeros((0,), jnp.float32)
    idx = jnp.asarray(free_idx, jnp.int32)

    @jax.jit
    def fit_all(rb_toys, hists, norms):
        def one(rb1):
            lut = jax.vmap(eval_from_bins, in_axes=(0, 0, None, 0))(
                hists, norms, stack.bin_volume, rb1)

            def fun(qf):
                r = jnp.exp(jnp.clip(qf, -_LOG_CLAMP, _LOG_CLAMP))
                return nll_fn(pinned.at[idx].set(r), lut, norms,
                              mle.static)

            if not free_idx:
                return pinned[:nsources]
            x, _, _ = _bfgs(fun, q0, mle.maxiter)
            return pinned.at[idx].set(jnp.exp(x))[:nsources]

        return jax.vmap(one)(rb_toys)

    return np.asarray(fit_all(rb_toys, hists, norms))


def goodness_of_fit(
    sources: Sequence[Source],
    signals: Sequence[Signal],
    systematics: Sequence[Systematic],
    observables: Sequence[Observable],
    data: np.ndarray,
    best_params: np.ndarray,
    ntoys: int = 0,
    key=None,
    stack=None,
    refit: bool = False,
) -> GofResult:
    """Saturated-chi2 GOF of a fit result, optionally toy-calibrated.

    Args:
        best_params: the fitted parameter vector (rates then systematic
            coefficients, the MCMC/MLE layout).
        ntoys: when > 0, also simulate this many datasets from the
            best-fit model (batched) and report the exact p-value.
        refit: upgrade the plug-in toys to a FULL parametric bootstrap:
            each toy's free rates are refit (one vmapped BFGS batch,
            systematics pinned at the best-fit theta) and its chi2 is
            computed against its OWN fitted expectation — the correct
            null distribution of the data statistic, which is itself a
            post-fit quantity.  Plug-in (refit=False) errs
            conservative.
    """
    if stack is None:
        from sxmc_jax.pdf.stack import PdfStack

        stack = PdfStack(signals, observables, systematics)
    nsources = len(sources)
    best_params = np.asarray(best_params, np.float32)
    datasets = sorted({s.dataset for s in signals})

    observed = _observed_counts(data, stack, datasets)
    expected = _expected_counts(best_params, stack, signals, nsources,
                                datasets)
    chi2 = baker_cousins_chi2(observed, expected)

    nfloat = sum(1 for s in sources if not s.fixed) + sum(
        s.npars for s in systematics if not s.fixed)
    occupied = int(((expected > 0) | (observed > 0)).sum())
    ndof = max(occupied - nfloat, 1)

    try:
        from scipy.stats import chi2 as chi2_dist

        p_asym = float(chi2_dist.sf(chi2, ndof))
    except ImportError:  # pragma: no cover - scipy is baked in
        p_asym = None

    # Plug-in parametric bootstrap: toys are compared against the SAME
    # fixed best-fit expectation (no per-toy refit), which calibrates
    # the statistic's sampling distribution at the fitted model.  A
    # full bootstrap would refit each toy; the plug-in p-value is the
    # standard first-line check and errs conservative.
    p_toys = None
    chi2_toys = np.zeros(0)
    if ntoys > 0:
        from sxmc_jax.generator import make_fake_dataset_batch

        if key is None:
            key = jax.random.PRNGKey(20260819)
        rates = {sig.name: float(best_params[sig.source.index])
                 for sig in signals}
        batch = make_fake_dataset_batch(
            key, signals, systematics, observables, ntoys,
            poisson=True, stack=stack, rates=rates,
            theta=best_params[nsources:])
        # One batched bin-id pass for every toy event, then one
        # bincount per dataset over (toy, bin) composite keys.
        nobs = stack.nobservables
        nev = batch.shape[1]
        flat = batch.reshape(-1, batch.shape[2])
        ids, valid = hist_ops.compute_bin_ids(
            jax.numpy.asarray(flat[:, :nobs]), stack.lower, stack.upper,
            stack.nbins)
        ids = np.asarray(ids)
        valid = np.asarray(valid)
        tags = flat[:, nobs]
        toy_idx = np.repeat(np.arange(ntoys, dtype=np.int64), nev)
        total = stack.total_nbins
        obs_toys = np.zeros((len(datasets), ntoys, total), np.float64)
        for d, ds in enumerate(datasets):
            sel = valid & (tags == ds)
            obs_toys[d] = np.bincount(
                toy_idx[sel] * total + ids[sel],
                minlength=ntoys * total).reshape(ntoys, total)

        if refit:
            # Full bootstrap: each toy's chi2 against its own refitted
            # expectation.  W[d][s, i] collects the per-source bin
            # weights so mu_toys[d] = rates_hat @ W[d].
            rates_hat = _refit_toy_rates(
                sources, signals, systematics, observables,
                best_params, batch, stack, nsources)
            hists_b, _ = stack.histograms(
                jax.numpy.asarray(best_params[nsources:],
                                  jax.numpy.float32))
            hists_b = np.asarray(hists_b, np.float64)
            exp_toys = np.zeros((len(datasets), ntoys, total),
                                np.float64)
            for j, sig in enumerate(signals):
                d = datasets.index(sig.dataset)
                exp_toys[d] += (rates_hat[:, sig.source.index, None]
                                * sig.nexpected * hists_b[j][None, :]
                                / sig.n_mc)
        else:
            exp_toys = np.broadcast_to(
                expected[:, None, :],
                (len(datasets), ntoys, total))
        mu = np.maximum(exp_toys, 1e-12)
        n = obs_toys
        terms = exp_toys - n + n * np.log(np.where(n > 0, n / mu, 1.0))
        mask = (exp_toys > 0) | (n > 0)
        chi2_toys = 2.0 * np.where(mask, terms, 0.0).sum(axis=(0, 2))
        p_toys = float((chi2_toys >= chi2).mean())

    return GofResult(chi2=chi2, ndof=ndof, p_asymptotic=p_asym,
                     p_toys=p_toys, chi2_toys=chi2_toys)
