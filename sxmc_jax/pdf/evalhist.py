"""Binned PDF evaluator — the JAX ``pdfz::EvalHist``.

Re-design of reference src/pdfz.{h,cpp}.  The reference registers device
buffers and launches three CUDA kernels per evaluation (zero_hist /
bin_samples / eval_pdf, pdfz.cpp:441-488); here evaluation is one pure
jitted function of ``(samples, params)`` returning ``(pdf_values, norm)``,
and the buffer-registration machinery disappears.

Semantics preserved exactly:
  * systematics transform the samples at every evaluation
    (pdfz.cpp:372-385);
  * events outside ``[lower, upper)`` in any observable are dropped from
    both histogram and normalization (pdfz.cpp:388-404);
  * eval points never move, so their bin ids are precomputed once per
    dataset (``SetEvalPoints``, pdfz.cpp:245-302): id >= 0 in-domain,
    -1 out-of-domain -> NaN, -2 dataset mismatch -> 0.0
    (pdfz.cpp:411-436);
  * PDF value = bins[id] / (norm * bin_volume).

Extensions over the reference: per-sample weights (planned-but-withdrawn
in the reference test fixtures, test_pdfz_fixtures.h:46-47) are supported
natively.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sxmc_jax.ops import histogram as hist_ops
from sxmc_jax.ops import transforms


class PdfError(ValueError):
    """Generic PDF-related error (reference: pdfz.h:93-102)."""


class EvalHist:
    """N-dimensional histogram PDF with on-the-fly systematics.

    Unlike the reference class, this object is immutable configuration +
    static data; all evaluation state flows through pure functions, so a
    single instance can be evaluated concurrently (vmap/pjit) without the
    buffer-aliasing hazards the reference documents (pdfz.h:354-369).
    """

    def __init__(
        self,
        samples,
        nfields: int,
        nobservables: int,
        lower: Sequence[float],
        upper: Sequence[float],
        nbins: Sequence[int],
        dataset: int = 0,
        weights=None,
    ):
        samples = np.asarray(samples, dtype=np.float32)
        if samples.ndim == 1:
            if nfields <= 0 or samples.size % nfields != 0:
                raise PdfError(
                    "Length of samples array is not divisible by number of "
                    "fields.")
            samples = samples.reshape(-1, nfields)
        if samples.shape[1] != nfields:
            raise PdfError("Sample array width does not match nfields.")
        if nobservables == 0:
            raise PdfError("Number of observables in PDF is zero.")
        if nobservables > nfields:
            raise PdfError(
                "Number of observables cannot be greater than number of "
                "fields.")
        if len(upper) != nobservables:
            raise PdfError(
                "Number of upper bounds must be same as number of "
                "observables.")
        if len(lower) != nobservables:
            raise PdfError(
                "Number of lower bounds must be same as number of "
                "observables.")
        if len(nbins) != nobservables:
            raise PdfError(
                "Size of nbins array must be same as number of observables.")
        if hist_ops.total_bins(nbins) == 0:
            raise PdfError("Cannot make histogram with zero bins.")

        # Host copies are kept alongside device arrays, so host-side
        # consumers (static histograms, sharded packing) never read the
        # device back.
        self.samples_host = samples
        self.lower_host = tuple(float(x) for x in lower)
        self.upper_host = tuple(float(x) for x in upper)
        self.samples = jnp.asarray(samples)
        self.weights_host = (None if weights is None
                             else np.asarray(weights, np.float32))
        self.weights = (None if weights is None
                        else jnp.asarray(weights, jnp.float32))
        self.nfields = nfields
        self.nobservables = nobservables
        self.lower = np.asarray(lower, np.float32)
        self.upper = np.asarray(upper, np.float32)
        self.nbins = tuple(int(b) for b in nbins)
        self.dataset = int(dataset)
        self.total_nbins = hist_ops.total_bins(self.nbins)
        self.bin_volume = hist_ops.bin_volume(lower, upper, self.nbins)
        self.systematics: Tuple[transforms.SystematicDesc, ...] = ()

    @property
    def n_mc(self) -> int:
        return self.samples.shape[0]

    def add_systematic(self, desc: transforms.SystematicDesc) -> None:
        """Attach a systematic (reference: Eval::AddSystematic)."""
        self.systematics = self.systematics + (desc,)

    # ---------------------------------------------------------------- eval

    def compute_read_bins(self, points) -> jnp.ndarray:
        """Precompute eval-point bin ids (reference: pdfz.cpp:245-302).

        ``points`` is ``(npoints, nobservables + 1)``; the final column is
        the dataset tag.  Returns int32 ids with the reference's sentinel
        encoding: -1 out-of-domain (NaN at eval), -2 dataset mismatch
        (0.0 at eval).
        """
        points = np.asarray(points, dtype=np.float32)
        if points.ndim == 1:
            width = self.nobservables + 1
            if points.size % width != 0:
                raise PdfError(
                    "Number of entries in evaluation points array not "
                    "divisible by number of observables.")
            points = points.reshape(-1, width)
        obs = jnp.asarray(points[:, :self.nobservables])
        ids, valid = hist_ops.compute_bin_ids(
            obs, self.lower, self.upper, self.nbins)
        ds_match = jnp.asarray(points[:, self.nobservables]) == self.dataset
        ids = jnp.where(ds_match, ids, -2)
        # Out-of-domain wins over dataset mismatch (pdfz.cpp:295-301).
        ids = jnp.where(valid, ids, -1)
        return ids

    def histogram(self, params=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Build (bins, norm) at the given systematic parameters."""
        if params is None:
            params = jnp.zeros((max((max(d.par_indices) + 1 for d in
                                     self.systematics), default=0),),
                               jnp.float32)
        params = jnp.asarray(params, jnp.float32)
        if params.ndim == 0:
            params = params[None]
        return _histogram(self.samples, params, self.weights,
                          self.lower_host, self.upper_host, self.nbins,
                          self.nobservables, self.systematics)

    def eval(self, read_bins: jnp.ndarray, params=None
             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Histogram + evaluate at precomputed read_bins.

        Returns:
            (pdf_values, norm): ``(npoints,)`` f32 densities (NaN/0
            sentinels applied) and the scalar in-domain norm.
        """
        bins, norm = self.histogram(params)
        values = eval_from_bins(bins, norm, self.bin_volume, read_bins)
        return values, norm

    def eval_points(self, points, params=None):
        """Convenience: compute read_bins then evaluate."""
        rb = self.compute_read_bins(points)
        return self.eval(rb, params)

    # ------------------------------------------------------------ sampling

    def density_histogram(self, params=None) -> np.ndarray:
        """Normalized density per bin, shaped ``self.nbins``.

        Reference: EvalHist::CreateHistogram (pdfz.cpp:498-594) —
        density = bins / bin_volume / norm.
        """
        bins, norm = self.histogram(params)
        norm = jnp.maximum(norm, 1.0)
        dens = bins / (norm * self.bin_volume)
        return np.asarray(dens).reshape(self.nbins)

    def density_projection(self, observable_index: int,
                           params=None) -> np.ndarray:
        """1-D projection of the density onto one observable.

        Reference: EvalHist::CreateHistogramProjection (pdfz.cpp:597-619)
        — declared there but left unimplemented ("Not implemented");
        this is the working version.  Returns a normalized 1-D density
        over the observable's domain.
        """
        if not 0 <= observable_index < self.nobservables:
            raise PdfError(
                "CreateHistogramProjection: Invalid observable index!")
        dens = self.density_histogram(params)
        axes = tuple(a for a in range(self.nobservables)
                     if a != observable_index)
        marg = dens.sum(axis=axes) if axes else dens
        # Convert bin densities to a normalized 1-D density.
        lo = float(np.asarray(self.lower)[observable_index])
        up = float(np.asarray(self.upper)[observable_index])
        width = (up - lo) / self.nbins[observable_index]
        total = marg.sum() * width
        return marg / total if total > 0 else marg

    def random_sample(
        self,
        key,
        nexpected: float,
        syst_vals=None,
        uppers=None,
        lowers=None,
        poisson: bool = False,
        dataset: Optional[int] = None,
    ) -> np.ndarray:
        """Draw events from the binned PDF (reference: pdfz.cpp:817-922).

        The reference samples via ROOT ``TH1::GetRandom``: categorical
        over bins by content, uniform within a bin, with rejection
        against the optional per-observable bounds.  Implemented by
        :func:`sxmc_jax.generator.sample_from_counts`, without the
        reference's <=3-D restriction.
        """
        from sxmc_jax.generator import sample_from_counts

        if dataset is None:
            dataset = self.dataset
        bins, _ = self.histogram(syst_vals)
        return sample_from_counts(
            key, np.asarray(bins), self.nbins, self.lower_host,
            self.upper_host, nexpected, uppers=uppers, lowers=lowers,
            poisson=poisson, dataset=dataset)

    def get_samples(self) -> np.ndarray:
        """Observable columns + dataset tag (reference: pdfz.h:542-556)."""
        obs = self.samples_host[:, :self.nobservables]
        tag = np.full((obs.shape[0], 1), float(self.dataset), np.float32)
        return np.concatenate([obs, tag], axis=1)


def eval_from_bins(bins: jnp.ndarray, norm: jnp.ndarray, bin_volume: float,
                   read_bins: jnp.ndarray) -> jnp.ndarray:
    """LUT gather with sentinel semantics (reference: pdfz.cpp:411-436)."""
    safe = jnp.clip(read_bins, 0, bins.shape[-1] - 1)
    vals = jnp.take(bins, safe, axis=-1) / (norm * bin_volume)
    vals = jnp.where(read_bins == -2, 0.0, vals)
    vals = jnp.where(read_bins == -1, jnp.nan, vals)
    return vals


@functools.partial(
    jax.jit, static_argnames=("lower", "upper", "nbins", "nobservables",
                              "systematics"))
def _histogram(samples, params, weights, lower, upper, nbins, nobservables,
               systematics):
    transformed = transforms.apply_systematics(samples, params, systematics)
    obs = transformed[:, :nobservables]
    ids, valid = hist_ops.compute_bin_ids(obs, lower, upper, nbins)
    w = valid.astype(jnp.float32)
    if weights is not None:
        w = w * weights
    bins = hist_ops.fixed_bincount(ids, w, hist_ops.total_bins(nbins))
    return bins, bins.sum()
