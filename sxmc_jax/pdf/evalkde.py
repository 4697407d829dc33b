"""Kernel-density PDF evaluator.

The reference *declares* ``pdfz::EvalKernel`` but never implements it
(reference: pdfz.h:590-625; pdfz.cpp:946 is an empty section).  This is
the working JAX version: a Gaussian product-kernel density with
per-dimension bandwidths (Scott's rule x user scale), truncated and
renormalized to the observable domain so the PDF integrates to 1 over
[lower, upper) like EvalHist.

Evaluation is one einsum-shaped pass over (samples x points), which XLA
maps onto the matrix units; systematics transform the samples at every
evaluation exactly as in EvalHist.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import numpy as np

from sxmc_jax.ops import transforms
from sxmc_jax.pdf.evalhist import EvalHist, PdfError

_SQRT2 = 1.4142135623730951
_INV_SQRT2PI = 0.3989422804014327


class EvalKDE(EvalHist):
    """KDE evaluator with the same interface as EvalHist.

    ``bandwidth_scale`` rescales the per-dimension bandwidths; pass 1.0
    to use the default Scott's-rule calculation (pdfz.h:583-589).
    """

    def __init__(self, samples, nfields, nobservables, lower, upper,
                 bandwidth_scale=None, dataset=0, weights=None,
                 nbins=None, exact_lut=False):
        # Internal binning used for random_sample()/density export and
        # for the grid representation that lets a KDE signal join a
        # binned fit (see histogram()).
        nbins = nbins or [64] * nobservables
        if weights is not None:
            raise PdfError("EvalKDE does not support weighted samples.")
        super().__init__(samples, nfields, nobservables, lower, upper,
                         nbins, dataset=dataset, weights=weights)
        # exact_lut=True: fits evaluate the KDE EXACTLY at the data
        # event coordinates (no grid discretization) — see
        # PdfStack.evaluate(use_exact_kde=True).  Toy-ensemble paths
        # (FC belts / CLs) keep the grid representation.
        self.exact_lut = bool(exact_lut)
        if bandwidth_scale is None:
            bandwidth_scale = [1.0] * nobservables
        if len(bandwidth_scale) != nobservables:
            raise PdfError(
                "bandwidth_scale size must equal number of observables.")
        self.bandwidth_scale = jnp.asarray(bandwidth_scale, jnp.float32)
        self._centers_pts = _bin_center_points(
            self.lower_host, self.upper_host, self.nbins, dataset)

    def histogram(self, params=None, samples=None):
        """KDE pseudo-counts on the bin grid + exact in-domain norm.

        Returns counts such that ``counts[b] / (norm * bin_volume)`` is
        the KDE density at bin b's center — the same contract as
        EvalHist.histogram, so a KDE signal drops into the binned LUT
        machinery (PdfStack, generator, plots) unchanged, with the
        KDE's smoothness baked into the bin contents.

        Approximation note: inside fits the KDE is evaluated at bin
        CENTERS and events read the piecewise-constant LUT, so the
        in-fit density carries an extra O(w^2/12 * f'') discretization
        bias on top of the KDE's own O(h^2) smoothing (w = bin width,
        h = bandwidth).  With the default 64-bins-per-axis grid,
        w << h for any reasonable bandwidth and the LUT bias is
        negligible against the KDE bias; raise ``nbins`` if a very
        narrow bandwidth_scale makes w ~ h.  Exact (ungridded)
        evaluation at arbitrary points is available standalone via
        :meth:`eval_points`.

        ``samples`` optionally supplies the MC array as an explicit jit
        argument (PdfStack threads it through device_data so it is
        never a closure constant).
        """
        if params is None:
            params = jnp.zeros((max((max(d.par_indices) + 1 for d in
                                     self.systematics), default=0),),
                               jnp.float32)
        params = jnp.asarray(params, jnp.float32)
        if params.ndim == 0:
            params = params[None]
        if samples is None:
            samples = self.samples
        dens, norm = _kde_eval(
            samples, jnp.asarray(self._centers_pts), params,
            self.lower, self.upper, self.bandwidth_scale,
            self.nobservables, self.systematics, self.dataset)
        return dens * (self.bin_volume * norm), norm

    def _bandwidths(self, obs: jnp.ndarray) -> jnp.ndarray:
        """Scott's rule: h_i = sigma_i * n^(-1/(d+4)) * scale."""
        n = obs.shape[0]
        d = self.nobservables
        sigma = jnp.std(obs, axis=0)
        sigma = jnp.maximum(sigma, 1e-6)
        return sigma * (n ** (-1.0 / (d + 4))) * self.bandwidth_scale

    def eval_points(self, points, params=None):
        points = np.asarray(points, np.float32)
        if points.ndim == 1:
            points = points.reshape(-1, self.nobservables + 1)
        return self.eval_at(jnp.asarray(points), params)

    def eval_at(self, points, params=None, samples=None):
        """Exact KDE density at device-resident ``points`` (traceable).

        ``points`` is ``(npoints, nobs + 1)`` with the dataset tag
        last; sentinels match EvalHist (out-of-domain -> NaN, dataset
        mismatch -> 0).  ``samples`` optionally supplies the MC array
        as an explicit jit argument (PdfStack threads it through
        device_data).  This is the in-fit exact path used when
        ``exact_lut`` is set.
        """
        if samples is None:
            samples = self.samples
        params = (jnp.zeros(0, jnp.float32) if params is None
                  else jnp.asarray(params, jnp.float32))
        return _kde_eval(
            samples, points, params,
            self.lower, self.upper, self.bandwidth_scale,
            self.nobservables, self.systematics, self.dataset)

    def eval(self, read_bins, params=None):
        raise NotImplementedError(
            "EvalKDE evaluates points directly; use eval_points() / "
            "eval_at().")


def _bin_center_points(lower, upper, nbins, dataset) -> np.ndarray:
    """Bin centers in flat row-major bin order, with a dataset tag
    column — the evaluation grid for histogram()."""
    from sxmc_jax.ops import histogram as hist_ops

    nobs = len(nbins)
    total = hist_ops.total_bins(nbins)
    strides = hist_ops.bin_strides(nbins)
    lower = np.asarray(lower, np.float64)
    upper = np.asarray(upper, np.float64)
    widths = (upper - lower) / np.asarray(nbins, np.float64)
    flat = np.arange(total)
    pts = np.empty((total, nobs + 1), np.float32)
    for i, (st, nb) in enumerate(zip(strides, nbins)):
        axis = (flat // st) % nb
        pts[:, i] = lower[i] + (axis + 0.5) * widths[i]
    pts[:, nobs] = float(dataset)
    return pts


@functools.partial(
    jax.jit, static_argnames=("nobs", "systematics", "dataset"))
def _kde_eval(samples, points, params, lower, upper, bw_scale, nobs,
              systematics, dataset):
    transformed = transforms.apply_systematics(samples, params,
                                               systematics)
    obs = transformed[:, :nobs]                      # (n, d)
    in_domain = jnp.all((obs >= lower) & (obs < upper), axis=1)
    norm_count = in_domain.sum().astype(jnp.float32)

    n = obs.shape[0]
    d = nobs
    sigma = jnp.maximum(jnp.std(obs, axis=0), 1e-6)
    h = sigma * (n ** (-1.0 / (d + 4))) * bw_scale    # (d,)

    x = points[:, :nobs]                              # (m, d)
    # Product Gaussian kernel: K(x) = prod_i phi((x_i - s_i) / h_i)/h_i
    # The (block, n, d) distance tensor is materialized one point-block
    # at a time (lax.map) so peak memory is O(block * n * d) instead of
    # O(m * n * d) — a 64x64-bin 2-D grid against 200k MC samples would
    # otherwise allocate ~6.5 GB per evaluation.
    m = x.shape[0]
    block = 512
    mpad = -(-m // block) * block
    xp = jnp.pad(x, ((0, mpad - m), (0, 0)))
    kscale = jnp.prod(_INV_SQRT2PI / h)

    def one_block(xb):                                # (block, d)
        z = (xb[:, None, :] - obs[None, :, :]) / h    # (block, n, d)
        logk = -0.5 * jnp.sum(z * z, axis=-1)         # (block, n)
        return jnp.exp(logk).mean(axis=1) * kscale    # (block,)

    density = jax.lax.map(
        one_block, xp.reshape(mpad // block, block, d)).reshape(-1)[:m]

    # Truncate-renormalize to the domain:
    # Z = (1/n) sum_s prod_i [Phi((u_i-s_i)/h_i) - Phi((l_i-s_i)/h_i)]
    cdf_hi = 0.5 * (1.0 + jax.lax.erf((upper - obs) / (h * _SQRT2)))
    cdf_lo = 0.5 * (1.0 + jax.lax.erf((lower - obs) / (h * _SQRT2)))
    z_mass = jnp.prod(cdf_hi - cdf_lo, axis=1).mean()
    density = density / jnp.maximum(z_mass, 1e-30)

    # Sentinels: NaN outside domain, 0 on dataset mismatch
    # (same contract as EvalHist, pdfz.cpp:411-436).
    pt_in = jnp.all((x >= lower) & (x < upper), axis=1)
    ds_ok = points[:, nobs] == dataset
    density = jnp.where(ds_ok, density, 0.0)
    density = jnp.where(pt_in, density, jnp.nan)
    return density, norm_count
