"""Fit model objects: Observable, Systematic, Source, Signal.

Re-implements reference src/observable.{h,cpp}, src/systematic.{h,cpp},
src/source.{h,cpp}, src/signal.{h,cpp} as plain dataclasses over the
batched PDF engine.  A ``Signal`` loads an MC ntuple, applies cuts,
maps columns into the fit's sample-field layout, and owns an
:class:`~sxmc_jax.pdf.evalhist.EvalHist` with its systematics attached
(reference: signal.cpp:11-169).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from sxmc_jax.io import loaders
from sxmc_jax.ops import transforms
from sxmc_jax.pdf.evalhist import EvalHist


@dataclasses.dataclass
class Observable:
    """Axis metadata (reference: observable.h:22-42)."""

    name: str
    title: str = ""
    field: str = ""
    bins: int = 1
    lower: float = 0.0
    upper: float = 1.0
    units: str = ""
    logscale: bool = False
    yrange: List[float] = dataclasses.field(default_factory=lambda: [-1, -1])
    field_index: int = -1

    @classmethod
    def from_dict(cls, name: str, config: dict) -> "Observable":
        return cls(
            name=name,
            title=config["title"],
            field=config["field"],
            bins=int(config["bins"]),
            lower=float(config["min"]),
            upper=float(config["max"]),
            units=config.get("units", ""),
            logscale=bool(config.get("logscale", False)),
            yrange=list(config.get("yrange", [-1, -1])),
        )


@dataclasses.dataclass
class Systematic:
    """Nuisance-parameter metadata (reference: systematic.h:23-49).

    ``means``/``sigmas`` are the power-series coefficients' expectations
    and Gaussian constraints (systematic.cpp:41-66); ``pidx`` holds the
    global parameter indices assigned by FitConfig (config.cpp:114-121).
    """

    name: str
    title: str = ""
    type: int = transforms.SHIFT
    observable_field: str = ""
    truth_field: str = ""
    means: List[float] = dataclasses.field(default_factory=list)
    sigmas: List[float] = dataclasses.field(default_factory=list)
    fixed: bool = False
    observable_field_index: int = -1
    truth_field_index: int = -1
    pidx: List[int] = dataclasses.field(default_factory=list)

    @property
    def npars(self) -> int:
        return len(self.means)

    @classmethod
    def from_dict(cls, name: str, config: dict) -> "Systematic":
        type_id = transforms.systematic_type_from_name(config["type"])
        means = [float(x) for x in config["mean"]]
        if "sigma" in config:
            sigmas = [float(x) for x in config["sigma"]]
            assert len(sigmas) == len(means)
        else:
            sigmas = [0.0] * len(means)
        truth_field = ""
        if type_id == transforms.RESOLUTION_SCALE:
            # The reference's code asserts "truth_field"
            # (systematic.cpp:32) but its shipped config/example.json
            # uses "true_field" (example.json:46) — accept both so the
            # reference's own example parses unmodified.
            if "truth_field" in config:
                truth_field = config["truth_field"]
            else:
                truth_field = config["true_field"]
        return cls(
            name=name, title=config["title"], type=type_id,
            observable_field=config["observable_field"],
            truth_field=truth_field, means=means, sigmas=sigmas,
            fixed=bool(config.get("fixed", False)))


@dataclasses.dataclass
class Source:
    """Named rate parameter shared by >=1 signals (source.h:21-58)."""

    name: str
    index: int = -1
    mean: float = 1.0
    sigma: float = 0.0
    fixed: bool = False

    @classmethod
    def from_dict(cls, name: str, config: dict) -> "Source":
        return cls(
            name=name,
            mean=float(config.get("mean", 1.0)),
            sigma=float(config.get("sigma", 0.0)),
            fixed=bool(config.get("fixed", False)))


@dataclasses.dataclass
class Signal:
    """A signal: PDF + expectation metadata (reference: signal.h:26-105)."""

    name: str
    title: str
    filename: str
    dataset: int
    source: Source
    nexpected: float
    n_mc: int
    histogram: EvalHist
    systematic_names: List[str] = dataclasses.field(default_factory=list)

    @classmethod
    def from_file(
        cls,
        name: str,
        title: str,
        filename: str,
        dataset: int,
        source: Source,
        nexpected: float,
        sample_fields: Sequence[str],
        observables: Sequence[Observable],
        cuts: Sequence[Observable],
        systematics: Sequence[Systematic],
        kde: bool = False,
        bandwidth_scale=None,
        kde_exact: bool = False,
    ) -> "Signal":
        if kde:
            # KDE signals take the generic table path (no native
            # fast-path needed; the KDE grid build dominates anyway).
            data, fields = loaders.read_float_table(filename)
            return cls.from_table(
                name, title, data, fields, dataset, source, nexpected,
                sample_fields, observables, cuts, systematics,
                filename=filename, kde=True,
                bandwidth_scale=bandwidth_scale, kde_exact=kde_exact)
        if filename.endswith((".sxnt", ".sxt")):
            # Native ingest: cuts + column mapping + DATASET tag run in
            # the C++ event store (sxmc_jax/io/native), no Python loop.
            from sxmc_jax.io import native

            if native.available():
                store = native.EventStore(filename)
                try:
                    n_mc = store.nrows
                    samples = store.select(
                        list(sample_fields[:-1]),
                        cuts=[(c.field, c.lower, c.upper) for c in cuts],
                        dataset_tag=float(dataset))
                finally:
                    store.close()
                if nexpected < 0:
                    nexpected = -nexpected * n_mc
                hist = build_pdf(samples, sample_fields, observables,
                                 systematics, dataset)
                return cls(
                    name=name, title=title, filename=filename,
                    dataset=dataset, source=source,
                    nexpected=float(nexpected), n_mc=int(n_mc),
                    histogram=hist,
                    systematic_names=[s.name for s in systematics])
        data, fields = loaders.read_float_table(filename)
        return cls.from_table(
            name, title, data, fields, dataset, source, nexpected,
            sample_fields, observables, cuts, systematics,
            filename=filename)

    @classmethod
    def from_table(
        cls,
        name: str,
        title: str,
        data: np.ndarray,
        fields: List[str],
        dataset: int,
        source: Source,
        nexpected: float,
        sample_fields: Sequence[str],
        observables: Sequence[Observable],
        cuts: Sequence[Observable],
        systematics: Sequence[Systematic],
        filename: str = "<memory>",
        kde: bool = False,
        bandwidth_scale=None,
        kde_exact: bool = False,
    ) -> "Signal":
        n_mc = data.shape[0]
        # Negative nexpected is the scale sentinel: scale S was stored as
        # -1/S, so nexpected = n_mc / S (signal.cpp:32-35).
        if nexpected < 0:
            nexpected = -nexpected * n_mc

        samples = read_dataset_to_samples(
            data, fields, dataset, sample_fields, cuts)
        hist = build_pdf(samples, sample_fields, observables, systematics,
                         dataset, kde=kde, bandwidth_scale=bandwidth_scale,
                         kde_exact=kde_exact)
        return cls(
            name=name, title=title, filename=filename, dataset=dataset,
            source=source, nexpected=float(nexpected), n_mc=int(n_mc),
            histogram=hist,
            systematic_names=[s.name for s in systematics])

    def get_efficiency(self, systematics: Sequence[Systematic]) -> float:
        """norm / n_mc at nominal systematics (signal.cpp:172-199)."""
        params = nominal_params(systematics)
        _, norm = self.histogram.histogram(params)
        return float(norm) / float(self.n_mc)


def nominal_params(systematics: Sequence[Systematic]) -> np.ndarray:
    """Global systematic-parameter vector at the means."""
    npars = sum(s.npars for s in systematics)
    params = np.zeros(npars, np.float32)
    for s in systematics:
        for j, pidx in enumerate(s.pidx):
            params[pidx] = s.means[j]
    return params


def read_dataset_to_samples(
    data: np.ndarray,
    data_fields: List[str],
    dataset_id: int,
    sample_fields: Sequence[str],
    cuts: Sequence[Observable],
) -> np.ndarray:
    """Cuts + column mapping + DATASET tag (reference: signal.cpp:50-109).

    Vectorized over events instead of the reference's per-event loop.
    Cut semantics match the reference exactly: keep events with
    ``lower <= x <= upper`` in every cut field (signal.cpp:88-95 rejects
    ``data < lower || data > upper``).
    """
    keep = np.ones(data.shape[0], bool)
    for cut in cuts:
        if cut.field not in data_fields:
            raise ValueError(
                f"Cut field {cut.field!r} not in data fields {data_fields}")
        col = data[:, data_fields.index(cut.field)]
        keep &= (col >= cut.lower) & (col <= cut.upper)
    data = data[keep]

    ncols = len(sample_fields)
    samples = np.empty((data.shape[0], ncols), np.float32)
    for j, field in enumerate(sample_fields[:-1]):
        if field not in data_fields:
            raise ValueError(
                f"Sample field {field!r} not in data fields {data_fields}")
        samples[:, j] = data[:, data_fields.index(field)]
    samples[:, ncols - 1] = float(dataset_id)  # DATASET column
    return samples


def build_pdf(
    samples: np.ndarray,
    sample_fields: Sequence[str],
    observables: Sequence[Observable],
    systematics: Sequence[Systematic],
    dataset: int,
    kde: bool = False,
    bandwidth_scale=None,
    kde_exact: bool = False,
) -> EvalHist:
    """Construct the EvalHist + attach systematics (signal.cpp:112-169).

    Observables' bounds/bins are laid out by field_index, which by the
    FitConfig layout contract occupy the first len(observables) sample
    columns.  ``kde=True`` builds a kernel-density evaluator instead
    (the feature the reference declared but never implemented,
    pdfz.h:590-625); its density is represented on the same bin grid so
    it drops into the batched fit machinery.
    """
    nobs = len(observables)
    lower = [0.0] * nobs
    upper = [1.0] * nobs
    nbins = [1] * nobs
    for obs in observables:
        i = obs.field_index
        if not 0 <= i < nobs:
            raise ValueError(
                f"Observable {obs.name} has field_index {i} outside the "
                f"observable block [0, {nobs})")
        lower[i] = obs.lower
        upper[i] = obs.upper
        nbins[i] = obs.bins

    if kde:
        from sxmc_jax.pdf.evalkde import EvalKDE

        hist = EvalKDE(samples, len(sample_fields), nobs, lower, upper,
                       bandwidth_scale=bandwidth_scale, dataset=dataset,
                       nbins=nbins, exact_lut=kde_exact)
    else:
        hist = EvalHist(samples, len(sample_fields), nobs, lower, upper,
                        nbins, dataset=dataset)
    for syst in systematics:
        hist.add_systematic(transforms.SystematicDesc(
            type=syst.type,
            obs=syst.observable_field_index,
            par_indices=tuple(syst.pidx),
            extra_field=max(syst.truth_field_index, 0)))
    return hist
