"""Asimov datasets: the expectation-valued dataset as weighted events.

An Asimov dataset replaces every statistical fluctuation with its
expectation: the representative dataset of Cowan, Cranmer, Gross &
Vitells (arXiv:1007.1727, sec. 3.2), for which the maximum-likelihood
estimators equal the generating parameters exactly.  Fitting it yields
the asymptotic test-statistic scale (sigma^2 = mu^2 / q_mu,A), which
turns expected significances, expected limits, and Brazil bands from
toy-MC ensembles into a handful of deterministic fits
(stats.hypotest.HypoTest.asymptotic_*).

Because this framework's PDFs are histograms (piecewise-constant,
reference: src/pdfz.cpp:349-408), the Asimov dataset is EXACT, not an
approximation: one event per (dataset, bin) at the bin center, weighted
by the expected count

    nu_b = sum_j rate_j * nexpected_j * counts_jb / n_mc_j

which the weighted-event NLL (ops.nll with ``weights``) scores as
``sum_b nu_b log s_b``; the gradient vanishes identically at the
generating rates.  The reference has no Asimov machinery at all — its
only expected-sensitivity tool is the median of toy upper limits
(sxmc.cpp:44-148, 217-226).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from sxmc_jax.ops import histogram as hist_ops


def bin_centers(stack) -> np.ndarray:
    """(total_nbins, nobservables) bin-center coordinates of a
    PdfStack's grid, in flat row-major bin order (pdfz.cpp:207-215)."""
    nbins = stack.nbins
    strides = hist_ops.bin_strides(nbins)
    total = stack.total_nbins
    flat = np.arange(total, dtype=np.int64)
    centers = np.empty((total, len(nbins)), np.float32)
    for i, (lo, up, n) in enumerate(
            zip(stack.lower_host, stack.upper_host, nbins)):
        axis = (flat // strides[i]) % n
        centers[:, i] = lo + (axis + 0.5) * (up - lo) / n
    return centers


def asimov_dataset(model, params: Optional[np.ndarray] = None,
                   overrides: Optional[Dict[str, float]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Build the Asimov dataset for a fit model.

    Args:
        model: an MCMC/MLE fit driver (provides ``stack``, ``static``,
            ``parameter_means``, ``parameter_names``, ``nsources``).
        params: full parameter vector to generate at (rates then
            systematic coefficients); defaults to the nominal means.
        overrides: per-parameter-name values layered on top (e.g.
            ``{"signal": 0.0}`` for the background-only Asimov).

    Returns:
        (data, weights): ``(n, nobservables + 1)`` events (dataset tag
        last, one per nonempty bin per dataset) and ``(n,)`` expected
        counts.  Feed both to ``MLE.fit(data, weights=weights)``.
    """
    if params is None:
        params = np.asarray(model.parameter_means, np.float64).copy()
    else:
        params = np.asarray(params, np.float64).copy()
    if overrides:
        for name, value in overrides.items():
            params[model.parameter_names.index(name)] = value

    stack = model.stack
    theta = jnp.asarray(params[model.nsources:], jnp.float32)
    hists, _ = stack.histograms(theta)
    hists = np.asarray(hists, np.float64)

    st = model.static
    rates = params[np.asarray(st.source_id)]
    scale = rates * np.asarray(st.nexpected, np.float64) \
        / np.asarray(st.n_mc, np.float64)
    nu = hists * scale[:, None]                 # (nsignals, total_nbins)

    centers = bin_centers(stack)
    events = []
    weights = []
    for ds in sorted({int(d) for d in stack.datasets}):
        sig_rows = [j for j, d in enumerate(stack.datasets)
                    if int(d) == ds]
        nu_d = nu[sig_rows].sum(axis=0)
        keep = nu_d > 0
        n_keep = int(keep.sum())
        if n_keep == 0:
            continue
        ev = np.concatenate(
            [centers[keep],
             np.full((n_keep, 1), float(ds), np.float32)], axis=1)
        events.append(ev)
        weights.append(nu_d[keep])

    if not events:
        nobs = stack.nobservables
        return (np.empty((0, nobs + 1), np.float32),
                np.empty((0,), np.float32))
    return (np.concatenate(events).astype(np.float32),
            np.concatenate(weights).astype(np.float32))
