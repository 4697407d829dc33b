"""Fake-experiment generation.

Re-implements reference src/generator.{h,cpp}: for each signal, the
expected count is ``nexpected * efficiency`` at the nominal systematics,
Poisson-fluctuated, and events are drawn from the signal's binned PDF
(bin-categorical + uniform-within-bin, the semantics of ROOT
``TH1::GetRandom``, pdfz.cpp:817-922) with rejection against the
observable bounds; events are tagged with the signal's dataset id.

All signals' histograms are built by ONE batched PdfStack evaluation —
per-signal kernel builds would pay one compile per distinct MC size.
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import numpy as np

from sxmc_jax.ops import histogram as hist_ops
from sxmc_jax.signal import Observable, Signal, Systematic, nominal_params


def sample_from_counts(
    key,
    counts: np.ndarray,
    nbins: Sequence[int],
    lower: Sequence[float],
    upper: Sequence[float],
    nexpected: float,
    uppers=None,
    lowers=None,
    poisson: bool = False,
    dataset: float = 0.0,
) -> np.ndarray:
    """Draw events from histogram counts (TH1::GetRandom semantics).

    Categorical over bins by content, uniform within a bin; bins outside
    the optional [lowers, uppers] bounds are excluded up front (the
    host-loop equivalent of the reference's rejection loop,
    pdfz.cpp:853-914).  Returns ``(n, nobs + 1)`` float32 with the
    dataset tag last.
    """
    nobs = len(nbins)
    counts = np.asarray(counts, np.float64).reshape(-1)
    strides = hist_ops.bin_strides(nbins)
    lower = np.asarray(lower, np.float64)
    upper = np.asarray(upper, np.float64)
    widths = (upper - lower) / np.asarray(nbins, np.float64)

    key_n, key_bin, key_pos = jax.random.split(jax.numpy.asarray(key), 3)
    if poisson:
        nobserved = int(jax.random.poisson(key_n, nexpected))
    else:
        nobserved = int(np.floor(nexpected + 0.5))  # nint (utils.h)
    if nobserved == 0:
        return np.zeros((0, nobs + 1), np.float32)

    probs = counts.copy()
    if uppers is not None and len(np.atleast_1d(uppers)):
        uppers = np.atleast_1d(np.asarray(uppers, np.float64))
        lowers = np.atleast_1d(np.asarray(lowers, np.float64))
        flat = np.arange(probs.shape[0])
        ok = np.ones(probs.shape[0], bool)
        for i, (st, nb) in enumerate(zip(strides, nbins)):
            axis_idx = (flat // st) % nb
            lo_edge = lower[i] + axis_idx * widths[i]
            hi_edge = lo_edge + widths[i]
            ok &= (hi_edge > lowers[i]) & (lo_edge < uppers[i])
        probs = np.where(ok, probs, 0.0)
    total = probs.sum()
    if total <= 0:
        return np.zeros((0, nobs + 1), np.float32)
    probs = probs / total

    bin_idx = np.asarray(jax.random.choice(
        key_bin, probs.shape[0], shape=(nobserved,),
        p=jax.numpy.asarray(probs)))
    u = np.asarray(jax.random.uniform(
        key_pos, (nobserved, nobs)), np.float64)

    events = np.empty((nobserved, nobs + 1), np.float32)
    for i, (st, nb) in enumerate(zip(strides, nbins)):
        axis_idx = (bin_idx // st) % nb
        events[:, i] = lower[i] + (axis_idx + u[:, i]) * widths[i]
    events[:, nobs] = float(dataset)
    return events


def _bounded_probs(counts, nbins, lower, upper, uppers, lowers):
    """Bin probabilities with out-of-bounds bins zeroed (the host-side
    equivalent of the reference's rejection loop, pdfz.cpp:853-914)."""
    probs = np.asarray(counts, np.float64).reshape(-1).copy()
    if uppers is not None and len(np.atleast_1d(uppers)):
        strides = hist_ops.bin_strides(nbins)
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        widths = (upper - lower) / np.asarray(nbins, np.float64)
        uppers = np.atleast_1d(np.asarray(uppers, np.float64))
        lowers = np.atleast_1d(np.asarray(lowers, np.float64))
        flat = np.arange(probs.shape[0])
        ok = np.ones(probs.shape[0], bool)
        for i, (st, nb) in enumerate(zip(strides, nbins)):
            axis_idx = (flat // st) % nb
            lo_edge = lower[i] + axis_idx * widths[i]
            hi_edge = lo_edge + widths[i]
            ok &= (hi_edge > lowers[i]) & (lo_edge < uppers[i])
        probs = np.where(ok, probs, 0.0)
    total = probs.sum()
    return probs / total if total > 0 else probs


def make_fake_dataset_batch(
    key,
    signals: Sequence[Signal],
    systematics: Sequence[Systematic],
    observables: Sequence[Observable],
    ntoys: int,
    poisson: bool = True,
    stack=None,
    rates=None,
    fluctuate_systematics: bool = False,
    theta=None,
) -> np.ndarray:
    """Generate ``ntoys`` fake datasets as one padded batch.

    The serial generator costs a few device dispatches PER TOY; here the
    Poisson draws, bin choices, and within-bin positions for all toys of
    a signal are single batched ``jax.random`` calls — the toy-MC
    front-end for belt constructions and vmapped ensembles.

    ``fluctuate_systematics=True`` draws each toy's systematic
    coefficients from their Gaussian constraints (theta ~ N(mean,
    sigma); fixed or unconstrained coefficients stay nominal) and
    generates that toy from the PDFs AND efficiencies at its own theta
    — one batched (ntoys x signals) histogram build.  This propagates
    constrained systematics into toy-MC limits (FC belts, CLs), which
    the plug-in prescription underestimates.

    ``theta`` pins the systematic coefficients the toys are generated
    at (default: nominal) — e.g. the best-fit vector for
    posterior-predictive checks or a profiled theta-hat for
    profile-construction belts.

    Returns ``(ntoys, nev_max, nobs + 1)`` float32 where padding rows
    carry dataset tag -1 (the unknown-dataset sentinel that is provably
    invisible to the NLL).
    """
    nobs = len(observables)
    if not signals:
        return np.zeros((ntoys, 0, nobs + 1), np.float32)

    if stack is None:
        from sxmc_jax.pdf.stack import PdfStack

        stack = PdfStack(signals, observables, systematics)

    theta = (nominal_params(systematics) if theta is None
             else np.asarray(theta, np.float32))
    key = jax.numpy.asarray(key)

    syst_sigmas = np.zeros_like(theta)
    for syst in systematics:
        if syst.fixed:
            continue
        for j, pidx in enumerate(syst.pidx):
            syst_sigmas[pidx] = syst.sigmas[j]
    fluctuate = fluctuate_systematics and (syst_sigmas > 0).any()

    if fluctuate:
        k_theta, key = jax.random.split(key)
        thetas = theta[None, :] + np.asarray(jax.random.normal(
            k_theta, (ntoys, theta.shape[0]))) * syst_sigmas[None, :]
        hists_b, norms_b = stack.histograms_batch(
            jax.numpy.asarray(thetas, jax.numpy.float32))
        hists_b = np.asarray(hists_b)     # (ntoys, nsig, nbins)
        norms_b = np.asarray(norms_b)     # (ntoys, nsig)
    else:
        hists, norms = stack.histograms(theta)
        hists = np.asarray(hists)
        norms = np.asarray(norms)

    uppers = [o.upper for o in observables]
    lowers = [o.lower for o in observables]
    strides = hist_ops.bin_strides(stack.nbins)
    lo = np.asarray(stack.lower_host, np.float64)
    hi = np.asarray(stack.upper_host, np.float64)
    widths = (hi - lo) / np.asarray(stack.nbins, np.float64)

    chunks = []
    keys = jax.random.split(key, len(signals))
    for i, (sig, k) in enumerate(zip(signals, keys)):
        rate = 1.0 if rates is None else float(rates.get(sig.name, 1.0))
        k_n, k_bin, k_pos = jax.random.split(jax.numpy.asarray(k), 3)
        if fluctuate:
            # Per-toy efficiency and PDF shape at that toy's theta.
            eff = norms_b[:, i] / sig.n_mc                 # (ntoys,)
            mu = rate * sig.nexpected * eff
            probs = np.stack([
                _bounded_probs(hists_b[t, i], stack.nbins, lo, hi,
                               uppers, lowers) for t in range(ntoys)])
            if probs.sum() <= 0:
                continue
            logits = jax.numpy.log(jax.numpy.asarray(
                np.maximum(probs, 1e-300)))[:, None, :]
        else:
            eff = float(norms[i]) / sig.n_mc
            mu = np.full(ntoys, rate * sig.nexpected * eff)
            probs = _bounded_probs(hists[i], stack.nbins, lo, hi,
                                   uppers, lowers)
            if probs.sum() <= 0:
                continue
            logits = jax.numpy.log(jax.numpy.asarray(
                np.maximum(probs, 1e-300)))
        if poisson:
            n = np.asarray(jax.random.poisson(
                k_n, jax.numpy.asarray(mu)))
        else:
            n = np.floor(mu + 0.5).astype(np.int64)
        nmax = max(int(n.max()), 1)
        bin_idx = np.asarray(jax.random.categorical(
            k_bin, logits, shape=(ntoys, nmax)))
        u = np.asarray(jax.random.uniform(k_pos, (ntoys, nmax, nobs)),
                       np.float64)
        ev = np.empty((ntoys, nmax, nobs + 1), np.float32)
        for a, (st, nb) in enumerate(zip(strides, stack.nbins)):
            axis_idx = (bin_idx // st) % nb
            ev[..., a] = lo[a] + (axis_idx + u[..., a]) * widths[a]
        valid = np.arange(nmax)[None, :] < n[:, None]
        ev[..., nobs] = np.where(valid, float(sig.dataset), -1.0)
        chunks.append(ev)

    return np.concatenate(chunks, axis=1) if chunks else \
        np.zeros((ntoys, 0, nobs + 1), np.float32)


def make_fake_dataset(
    key,
    signals: Sequence[Signal],
    systematics: Sequence[Systematic],
    observables: Sequence[Observable],
    poisson: bool = True,
    verbose: bool = False,
    stack=None,
    rates=None,
    theta=None,
) -> np.ndarray:
    """Generate one fake dataset (reference: generator.cpp:9-48).

    Returns ``(nevents, nobservables + 1)`` float32 with dataset tags.
    Pass the fit's PdfStack as ``stack`` to reuse its compiled kernels.
    ``rates`` optionally maps signal names to rate multipliers on the
    expected count (used by toy-MC constructions, e.g. Feldman-Cousins
    belts, to inject a chosen true signal rate).  ``theta`` pins the
    systematic coefficients (default nominal).
    """
    if not signals:
        return np.zeros((0, len(observables) + 1), np.float32)

    if stack is None:
        from sxmc_jax.pdf.stack import PdfStack

        stack = PdfStack(signals, observables, systematics)

    theta = (nominal_params(systematics) if theta is None
             else np.asarray(theta, np.float32))
    hists, norms = stack.histograms(theta)
    hists = np.asarray(hists)
    norms = np.asarray(norms)

    uppers = [o.upper for o in observables]
    lowers = [o.lower for o in observables]

    chunks: List[np.ndarray] = []
    keys = jax.random.split(key, len(signals))
    for i, (sig, k) in enumerate(zip(signals, keys)):
        eff = float(norms[i]) / sig.n_mc
        rate = 1.0 if rates is None else float(rates.get(sig.name, 1.0))
        nevents = rate * sig.nexpected * eff
        events = sample_from_counts(
            k, hists[i], stack.nbins, stack.lower_host, stack.upper_host,
            nevents, uppers=uppers, lowers=lowers, poisson=poisson,
            dataset=sig.dataset)
        if verbose:
            print(f"make_fake_dataset: {sig.name}: {events.shape[0]} "
                  f"events ({nevents} expected, efficiency = {eff})")
        chunks.append(events)

    return np.concatenate(chunks, axis=0)
