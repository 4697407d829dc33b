"""Histogramming: bin ids and a scatter-add bincount.

The plain-XLA form of the reference ``bin_samples`` CUDA kernel
(reference: src/pdfz.cpp:349-408): the systematic transform and the
bin-id math are elementwise, and the counts accumulate with one
scatter-add (the reference's ``atomicAdd``).  Counts accumulate in f32,
which is exact for sums of 0/1 weights up to 2**24 per bin.

Bin-index semantics match the reference exactly (pdfz.cpp:388-398):
an event is in-domain iff ``lower <= x < upper`` for every observable, and
the flat bin id is ``sum_i int((x_i - lower_i) * nbins_i / span_i) * stride_i``
with row-major strides (pdfz.cpp:207-215).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np


def bin_strides(nbins: Sequence[int]) -> Tuple[int, ...]:
    """Row-major bin strides (reference: pdfz.cpp:207-215)."""
    ndims = len(nbins)
    strides = [1] * ndims
    for i in range(ndims - 2, -1, -1):
        strides[i] = nbins[i + 1] * strides[i + 1]
    return tuple(strides)


def total_bins(nbins: Sequence[int]) -> int:
    t = 1
    for n in nbins:
        t *= n
    return t


def bin_volume(lower: Sequence[float], upper: Sequence[float],
               nbins: Sequence[int]) -> float:
    """Volume of one bin (reference: pdfz.cpp:201-204)."""
    v = 1.0
    for lo, up, n in zip(lower, upper, nbins):
        v *= (up - lo) / n
    return v


def compute_bin_ids(
    obs: jnp.ndarray,
    lower: jnp.ndarray,
    upper: jnp.ndarray,
    nbins: Tuple[int, ...],
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Flat bin ids + in-domain mask for points.

    Args:
        obs: ``(n, nobs)`` observable columns (already transformed).
        lower/upper: ``(nobs,)`` domain bounds, as host values (numpy
            arrays or sequences; they are fit configuration).
        nbins: static per-observable bin counts.

    Returns:
        (ids, valid): ``(n,)`` int32 flat bin ids (clipped into range for
        invalid points) and ``(n,)`` bool in-domain mask.
    """
    strides = bin_strides(nbins)
    lower = np.asarray(lower, np.float32)
    upper = np.asarray(upper, np.float32)
    # The f32 scale is divided on the host: XLA's f32 division on the
    # GPU is approximate (up to 2 ulp), and a scale one ulp off would
    # move samples that sit near a bin edge.
    scale = np.asarray(nbins, np.float32) / (upper - lower)

    # [lower, upper) convention, per observable (pdfz.cpp:388-394).
    valid = jnp.all((obs >= lower) & (obs < upper), axis=1)

    # Truncation toward zero == floor for non-negative arguments; clip so
    # out-of-domain points still produce an in-range (masked) id.
    per_axis = jnp.floor((obs - lower) * scale).astype(jnp.int32)
    per_axis = jnp.clip(per_axis, 0, jnp.asarray(nbins, jnp.int32) - 1)
    ids = per_axis @ jnp.asarray(strides, dtype=jnp.int32)
    return ids, valid


def fixed_bincount(
    ids: jnp.ndarray,
    weights: jnp.ndarray,
    num_bins: int,
) -> jnp.ndarray:
    """Weighted bincount with a static bin count: one scatter-add.

    The reference's ``atomicAdd`` scatter (pdfz.cpp:401-404), left to
    XLA, which fuses the bin-id math into it.  Unweighted counts are
    integers below 2**24 per bin, so their f32 sums are exact whatever
    order the atomics land in; weighted sums vary in the last bits.

    Args:
        ids: ``(n,)`` int32 bin ids in ``[0, num_bins)``.
        weights: ``(n,)`` per-sample weights (use the validity mask, or the
            mask times sample weights for weighted PDFs).
        num_bins: static number of bins.

    Returns:
        ``(num_bins,)`` f32 counts.
    """
    return jnp.zeros((num_bins,), jnp.float32).at[ids].add(
        weights.astype(jnp.float32))


def segmented_histogram(
    obs: jnp.ndarray,
    segment_ids: jnp.ndarray,
    mask: jnp.ndarray,
    lower: jnp.ndarray,
    upper: jnp.ndarray,
    nbins: Tuple[int, ...],
    num_segments: int,
    weights: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Histogram many PDFs that share one binning, in a single fused op.

    This replaces the reference's one-CUDA-stream-per-PDF concurrency
    (pdfz.h:17-22, mcmc.cpp:264-271): all signals' samples are concatenated
    with a segment id, and per-signal histograms become one batched
    bincount over ``num_segments * total_nbins`` bins.

    Args:
        obs: ``(n, nobs)`` concatenated (transformed) observable columns.
        segment_ids: ``(n,)`` int32 signal index per sample.
        mask: ``(n,)`` bool validity (e.g. padding mask).
        lower/upper: shared host domain bounds, ``(nobs,)``.
        nbins: static per-observable bin counts.
        num_segments: static number of PDFs.
        weights: optional per-sample weights.

    Returns:
        (hists, norms): ``(num_segments, total_nbins)`` f32 counts and
        ``(num_segments,)`` f32 in-domain sums (the per-PDF normalizations,
        reference pdfz.cpp:370-407).
    """
    tb = total_bins(nbins)
    ids, valid = compute_bin_ids(obs, lower, upper, nbins)
    w = (valid & mask).astype(jnp.float32)
    if weights is not None:
        w = w * weights
    flat_ids = segment_ids * tb + ids
    flat = fixed_bincount(flat_ids, w, num_segments * tb)
    hists = flat.reshape(num_segments, tb)
    norms = hists.sum(axis=1)
    return hists, norms
