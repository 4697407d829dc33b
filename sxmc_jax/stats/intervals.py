"""Interval extraction: Contour and Projection error estimators.

Re-implements reference src/interval.{h,cpp}, src/error_estimator.h and
src/error_estimators/{contour,projection}.cpp over device-resident
sample arrays instead of ROOT ntuples.
"""

from __future__ import annotations

import dataclasses
import numpy as np
from scipy.special import erfinv
from scipy.optimize import curve_fit
from sxmc_jax.utils import FitError


@dataclasses.dataclass
class Interval:
    """Confidence/credible interval (reference: interval.h:11-28)."""

    one_sided: bool = False
    point_estimate: float = -999.0
    lower: float = -999.0
    upper: float = -999.0
    cl: float = 0.683
    coverage: float = -999.0

    def __str__(self) -> str:
        # interval.cpp:6-20
        if self.one_sided:
            return (f"{self.point_estimate:g} <{self.upper:g} "
                    f"({100 * self.cl:g}% CL)")
        return (f"{self.point_estimate:g} "
                f"-{self.point_estimate - self.lower:g} "
                f"+{self.upper - self.point_estimate:g}")


def chi2_quantile_1dof(cl: float) -> float:
    """Inverse CDF of chi^2 with 1 dof: x = 2 * erfinv(cl)^2."""
    return float(2.0 * erfinv(cl) ** 2)


class ErrorEstimator:
    """Base error estimator (reference: error_estimator.h:24-52)."""

    def __init__(self, lspace, cl: float):
        self.lspace = lspace
        self.cl = cl

    def get_interval(self, name: str) -> Interval:
        raise NotImplementedError


class Contour(ErrorEstimator):
    """Likelihood-contour extents (reference: contour.cpp).

    Keeps samples with NLL - NLL_min < 0.5 * chi2_quantile(cl, 1) and
    reports each parameter's [min, max] within the contour; the point
    estimate is the midpoint of the extents within an adaptively-grown
    dNLL ~= 0.13 core (contour.cpp:42-57).
    """

    def __init__(self, lspace, cl: float):
        super().__init__(lspace, cl)
        delta = 0.5 * chi2_quantile_1dof(cl)
        nll = lspace.nll_values
        lmin = nll.min()
        self._mask = (nll - lmin) < delta
        if self._mask.sum() == 0:
            raise FitError(
                f"no likelihood samples within dNLL < {delta:.3g} of "
                "the minimum — cannot form a contour interval (raise "
                "nsteps or check chain mixing)")
        self._nll = nll

    def get_interval(self, name: str) -> Interval:
        interval = Interval(cl=self.cl, one_sided=False)
        col = self.lspace.column(name)[self._mask]
        nll = self._nll[self._mask]
        lmin = nll.min()

        # Adaptive core for the point estimate (contour.cpp:42-57).
        dnll = 0.13
        while True:
            core = (nll - lmin) < dnll
            if core.sum() >= 1:
                break
            dnll *= 5
        interval.point_estimate = float(
            (col[core].min() + col[core].max()) / 2)
        interval.lower = float(col.min())
        interval.upper = float(col.max())
        return interval


def _gaus(x, a, mu, sigma):
    return a * np.exp(-0.5 * ((x - mu) / sigma) ** 2)


def fit_gaussian_mode(centers: np.ndarray, counts: np.ndarray) -> float:
    """Chi^2 Gaussian fit for the mode (ROOT Fit("gaus") analog)."""
    total = counts.sum()
    if total <= 0:
        return float(centers[0])
    mu0 = float((centers * counts).sum() / total)
    var0 = float((counts * (centers - mu0) ** 2).sum() / total)
    sig0 = max(np.sqrt(var0), 1e-12)
    try:
        popt, _ = curve_fit(
            _gaus, centers, counts, p0=[counts.max(), mu0, sig0],
            maxfev=2000)
        return float(popt[1])
    except Exception:
        return mu0


class Projection(ErrorEstimator):
    """Marginal-posterior percentiles (reference: projection.cpp).

    Histograms the 1-D projection, Gaussian-fits the mode, then walks
    central (1-cl)/2 tails outward from the mode — or switches to a
    one-sided upper limit when there is insufficient probability below
    the mode (projection.cpp:38-68).  Records the achieved coverage.
    """

    nbins = 100  # ROOT TNtuple::Draw default binning

    def get_interval(self, name: str) -> Interval:
        interval = Interval(cl=self.cl)
        col = self.lspace.column(name)
        lo, hi = float(col.min()), float(col.max())
        if hi <= lo:
            hi = lo + max(abs(lo), 1.0) * 1e-6
        counts, edges = np.histogram(col, bins=self.nbins, range=(lo, hi))
        counts = counts.astype(np.float64)
        centers = 0.5 * (edges[:-1] + edges[1:])
        widths = np.diff(edges)
        total = counts.sum()

        mu = fit_gaussian_mode(centers, counts)
        imax = int(np.clip(np.searchsorted(edges, mu) - 1, 0, self.nbins - 1))
        interval.point_estimate = mu
        if mu < edges[0]:
            imax = 0
            interval.point_estimate = float(edges[0])

        cum = np.concatenate([[0.0], np.cumsum(counts)])  # cum[i]=sum(<i)
        ilo, ihi = 0, -1

        # Integral(0, imax) in ROOT includes bins 1..imax (+underflow=0).
        if cum[imax + 1] / total < self.cl / 2:
            interval.one_sided = True
            for i in range(self.nbins):
                if cum[i + 1] / total >= self.cl:
                    ihi = i
                    break
        else:
            interval.one_sided = False
            for i in range(imax, -1, -1):
                if (cum[imax + 1] - cum[i]) / total >= self.cl / 2:
                    ilo = i
                    break
            for i in range(imax + 1, self.nbins):
                if (cum[i + 1] - cum[imax + 1]) / total >= self.cl / 2:
                    ihi = i
                    break
        if ihi < 0:
            ihi = self.nbins - 1

        interval.coverage = float((cum[ihi + 1] - cum[ilo]) / total)
        interval.lower = float(edges[ilo])
        interval.upper = float(edges[ihi] + widths[ihi])
        return interval


def make_error_estimator(kind: str, lspace, cl: float) -> ErrorEstimator:
    if kind == "contour":
        return Contour(lspace, cl)
    if kind == "projection":
        return Projection(lspace, cl)
    raise ValueError(f"Unknown error type {kind!r}")
