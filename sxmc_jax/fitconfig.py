"""Fit configuration: the JSON DSL.

Re-implements the reference FitConfig semantics (reference:
src/config.cpp:19-297) over the same JSON schema, including:

  * ``fit`` section defaults: burnin_fraction 0.1, error_type "contour",
    confidence 0.683, output_prefix "lspace", seed 0 (config.cpp:43-72);
  * observables/cuts resolved by name from ``pdfs.observables``
    (config.cpp:75-91);
  * union of systematics over signals with global parameter-index
    assignment in first-seen order (config.cpp:94-123);
  * explicit sources from ``sources`` or implicit self-sources with
    signal-level mean/sigma/fixed (config.cpp:126-151);
  * sample-field layout: observables, then systematic truth fields, then
    the DATASET tag column (config.cpp:153-194);
  * rate-vs-scale: ``rate`` gives nexpected directly, ``scale`` S means
    nexpected = n_mc / S via the negative sentinel (config.cpp:211-221,
    signal.cpp:32-35);
  * ``data`` section mapping dataset ids to per-experiment real datasets
    (config.cpp:261-296).

JSON is parsed with C-style comment stripping (the reference vendors
jsoncpp with comment support, README.md:64-65).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import re
from typing import Dict, List, Optional

from sxmc_jax.ops import transforms
from sxmc_jax.signal import Observable, Signal, Source, Systematic
from sxmc_jax.utils import ConfigError

ERROR_CONTOUR = "contour"
ERROR_PROJECTION = "projection"
_ERROR_TYPES = (ERROR_CONTOUR, ERROR_PROJECTION)


def strip_json_comments(text: str) -> str:
    """Remove // and /* */ comments outside of strings."""
    pattern = re.compile(
        r'("(?:\\.|[^"\\])*")|(/\*.*?\*/)|(//[^\n]*)', re.DOTALL)
    return pattern.sub(lambda m: m.group(1) or "", text)


def load_json(filename: str) -> dict:
    with open(filename) as f:
        return json.loads(strip_json_comments(f.read()))


@dataclasses.dataclass
class FitConfig:
    """Typed fit configuration (reference: src/config.h:27-61)."""

    nexperiments: int
    nsteps: int
    burnin_fraction: float = 0.1
    error_type: str = ERROR_CONTOUR
    confidence: float = 0.683
    debug_mode: bool = False
    output_prefix: str = "lspace"
    plots: bool = True
    seed: int = 0
    signal_name: str = ""
    samples: str = ""
    nchains: int = 1
    # Blocked Metropolis-within-Gibbs: extra rate-block updates per
    # systematic-block update (each reuses the carried LUT, skipping
    # the PDF rebuild that dominates step cost).  0 = joint updates
    # (reference semantics, mcmc.cpp:264-271).
    rate_substeps: int = 0
    # Metropolis proposal geometry: "diagonal" (per-parameter widths,
    # reference semantics) or "full_cov" (Haario full-covariance
    # adaptation — walks along anticorrelated rate ridges).
    proposal: str = "diagonal"
    # Plot export formats (the reference saves .pdf/.png/.tex/.C/.root,
    # plots.cpp:130-140; matplotlib covers png/pdf/svg/eps).
    plot_formats: tuple = ("png",)
    # Likelihood-space output format: "npz" (default), "csv", "hdf5"
    # (needs h5py) or "root" (needs uproot; matches the reference's
    # lspace_<i>.root).
    output_format: str = "npz"
    # Binned likelihood: with histogram PDFs the unbinned extended NLL
    # regroups EXACTLY by (dataset, bin), so this is a pure speedup —
    # per-step event cost O(ndatasets * nbins) instead of
    # O(nevents * nsignals) — not an approximation.  (The reference's
    # LUT walk is always per-event, pdfz.cpp:411-436.)
    binned: bool = False

    observables: List[Observable] = dataclasses.field(default_factory=list)
    cuts: List[Observable] = dataclasses.field(default_factory=list)
    systematics: List[Systematic] = dataclasses.field(default_factory=list)
    sources: List[Source] = dataclasses.field(default_factory=list)
    signals: List[Signal] = dataclasses.field(default_factory=list)
    sample_fields: List[str] = dataclasses.field(default_factory=list)
    datasets: List[int] = dataclasses.field(default_factory=list)
    # dataset id -> list of per-experiment data Signals
    data: Dict[int, List[Signal]] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_json_file(cls, filename: str,
                       data_root: Optional[str] = None) -> "FitConfig":
        return cls.from_dict(load_json(filename), data_root=data_root)

    @classmethod
    def from_dict(cls, root: dict,
                  data_root: Optional[str] = None) -> "FitConfig":
        fit = root["fit"]
        obs_params = root.get("pdfs", {}).get("observables", {})
        sys_params = root.get("pdfs", {}).get("systematics", {})
        sig_params = root.get("signals", {})
        src_params = root.get("sources", {})

        if not fit.get("nexperiments", 0) > 0:
            raise ConfigError(
                "fit.nexperiments must be a positive integer "
                f"(got {fit.get('nexperiments')!r})")
        if not fit.get("nsteps", 0) > 0:
            raise ConfigError(
                "fit.nsteps must be a positive integer "
                f"(got {fit.get('nsteps')!r})")

        error_type = fit.get("error_type", ERROR_CONTOUR)
        if error_type not in _ERROR_TYPES:
            raise ValueError(f"Unknown error type {error_type!r}")

        output_format = str(fit.get("output_format", "npz"))
        _check_output_format(output_format)

        fc = cls(
            nexperiments=int(fit["nexperiments"]),
            nsteps=int(fit["nsteps"]),
            burnin_fraction=float(fit.get("burnin_fraction", 0.1)),
            error_type=error_type,
            confidence=float(fit.get("confidence", 0.683)),
            debug_mode=bool(fit.get("debug_mode", False)),
            # The reference's own example.json says "output_file" while
            # config.cpp:67 reads "output_prefix" (and silently falls
            # back to "lspace"); accept both.
            output_prefix=str(fit.get("output_prefix",
                                      fit.get("output_file", "lspace"))),
            plots=bool(fit.get("plots", True)),
            seed=int(fit.get("seed", 0)),
            signal_name=str(fit.get("signal_name", "")),
            samples=str(fit.get("samples", "")),
            nchains=int(fit.get("nchains", 1)),
            rate_substeps=int(fit.get("rate_substeps", 0)),
            proposal=str(fit.get("proposal", "diagonal")),
            plot_formats=tuple(fit.get("plot_formats", ["png"])),
            output_format=output_format,
            binned=bool(fit.get("binned", False)),
        )

        # Observables and cuts (config.cpp:75-91).
        for name in fit.get("observables", []):
            fc.observables.append(Observable.from_dict(name, obs_params[name]))
        for name in fit.get("cuts", []):
            if any(o.name == name for o in fc.observables):
                raise ConfigError(
                    f"cut {name!r} is already a fit observable; a "
                    "field may appear in fit.observables or fit.cuts, "
                    "not both")
            fc.cuts.append(Observable.from_dict(name, obs_params[name]))

        # Union of systematics and sources over all declared signals, with
        # global parameter indices assigned in first-seen order
        # (config.cpp:94-151).  NOTE: like the reference, the union is over
        # every signal in the ``signals`` section, not just active ones.
        sidx = 0
        pidx = 0
        for signal_name, sconf in sig_params.items():
            for sys_name in sconf.get("systematics", []):
                if any(s.name == sys_name for s in fc.systematics):
                    continue
                syst = Systematic.from_dict(sys_name, sys_params[sys_name])
                syst.pidx = list(range(pidx, pidx + syst.npars))
                pidx += syst.npars
                fc.systematics.append(syst)

            if "source" in sconf:
                src_name = sconf["source"]
                if not any(s.name == src_name for s in fc.sources):
                    src = Source.from_dict(src_name, src_params[src_name])
                    src.index = sidx
                    sidx += 1
                    fc.sources.append(src)
            else:
                # The signal is a source for itself (config.cpp:142-150).
                fc.sources.append(Source(
                    name=signal_name, index=sidx,
                    mean=float(sconf.get("mean", 1.0)),
                    sigma=float(sconf.get("sigma", 0.0)),
                    fixed=bool(sconf.get("fixed", False))))
                sidx += 1

        # Sample-field layout (config.cpp:153-194).  Cut fields stay out
        # of sample_fields, as in the reference: cuts are applied at
        # load time, not carried through the fit.
        for obs in fc.observables:
            obs.field_index = _index_with_append(fc.sample_fields, obs.field)
        for syst in fc.systematics:
            try:
                syst.observable_field_index = \
                    fc.sample_fields.index(syst.observable_field)
            except ValueError:
                raise ValueError(
                    f"Systematic {syst.name}: observable_field "
                    f"{syst.observable_field!r} is not an active observable")
            if syst.type == transforms.RESOLUTION_SCALE:
                syst.truth_field_index = _index_with_append(
                    fc.sample_fields, syst.truth_field)
        fc.sample_fields.append("DATASET")

        # Load active signals (config.cpp:197-258).
        datasets = set()
        for name in fit.get("signals", []):
            conf = sig_params[name]
            dataset = int(conf["dataset"])
            datasets.add(dataset)

            if ("rate" in conf) == ("scale" in conf):
                raise ConfigError(
                    f"signal {name!r} must set exactly one of 'rate' "
                    "(expected events) or 'scale' (sample scaling), "
                    f"got {sorted(k for k in conf if k in ('rate', 'scale'))}")
            if "rate" in conf:
                nexpected = float(conf["rate"])
            else:
                nexpected = -1.0 / float(conf["scale"])

            systs = [s for s in fc.systematics
                     if s.name in conf.get("systematics", [])]
            source_name = conf.get("source", name)
            source = next(s for s in fc.sources if s.name == source_name)

            fc.signals.append(Signal.from_file(
                name=name, title=conf.get("title", name),
                filename=_resolve(conf["filename"], data_root),
                dataset=dataset, source=source, nexpected=nexpected,
                sample_fields=fc.sample_fields,
                observables=fc.observables, cuts=fc.cuts,
                systematics=systs,
                kde=bool(conf.get("kde", False)),
                bandwidth_scale=conf.get("bandwidth_scale"),
                kde_exact=bool(conf.get("kde_exact", False))))

        fc.datasets = sorted(datasets)

        # Data section (config.cpp:261-296).
        for ds_name, rows in root.get("data", {}).items():
            dataset = int(ds_name)
            fc.data.setdefault(dataset, [])
            for row in rows:
                # All active observables are treated as cuts to clip the
                # data to the PDF boundaries (config.cpp:280-287).
                cc = list(fc.observables) + list(fc.cuts)
                fc.data[dataset].append(Signal.from_file(
                    name=row["title"], title=row["title"],
                    filename=_resolve(row["filename"], data_root),
                    dataset=dataset, source=Source(name="", index=-1),
                    nexpected=-1.0, sample_fields=fc.sample_fields,
                    observables=fc.observables, cuts=cc,
                    systematics=[]))

        return fc

    @property
    def nsources(self) -> int:
        return len(self.sources)

    @property
    def nparameters(self) -> int:
        return self.nsources + sum(s.npars for s in self.systematics)

    def parameter_names(self) -> List[str]:
        """Rate params then per-systematic coefficients (mcmc.cpp:100-114)."""
        names = [s.name for s in self.sources]
        for syst in self.systematics:
            for j in range(syst.npars):
                names.append(f"{syst.name}_{j}")
        return names

    def print(self) -> str:
        lines = ["Fit:",
                 f"  Number of experiments: {self.nexperiments}",
                 f"  MCMC steps: {self.nsteps}",
                 f"  Burn-in fraction: {self.burnin_fraction}",
                 f"  Random seed (0=random): {self.seed}",
                 f"  Confidence level: {self.confidence}"]
        if self.nchains > 1:
            lines.append(f"  Chains per experiment: {self.nchains}")
        if self.rate_substeps > 0:
            lines.append(f"  Rate substeps (blocked within-Gibbs): "
                         f"{self.rate_substeps}")
        lines.append("Signals:")
        for s in self.signals:
            lines.append(f"  {s.name}: nexpected={s.nexpected} "
                         f"n_mc={s.n_mc} dataset={s.dataset} "
                         f"source={s.source.name}")
        lines.append("Sources:")
        for s in self.sources:
            lines.append(f"  {s.name} (index {s.index}) mean={s.mean} "
                         f"sigma={s.sigma} fixed={s.fixed}")
        lines.append("Observables:")
        for o in self.observables:
            lines.append(f"  {o.name}: field={o.field} bins={o.bins} "
                         f"[{o.lower}, {o.upper})")
        if self.systematics:
            lines.append("Systematics:")
            for s in self.systematics:
                lines.append(f"  {s.name}: type={s.type} "
                             f"obs={s.observable_field} pidx={s.pidx} "
                             f"fixed={s.fixed}")
        return "\n".join(lines)


def _index_with_append(lst: List[str], item: str) -> int:
    """utils.h:56-63 — index of item, appending if absent."""
    if item in lst:
        return lst.index(item)
    lst.append(item)
    return len(lst) - 1


# Output formats that need an optional package.
_FORMAT_PACKAGES = {"hdf5": "h5py", "root": "uproot"}


def _check_output_format(output_format: str) -> None:
    """Fail at config load, not after the fit, when the chosen output
    format needs a package that is not installed."""
    package = _FORMAT_PACKAGES.get(output_format)
    if package is None:
        return
    try:
        importlib.import_module(package)
    except ImportError as e:
        raise ConfigError(
            f"fit.output_format={output_format!r} needs the optional "
            f"package {package!r}, which is not installed; use \"npz\" "
            f"(the default) or \"csv\"") from e


def _resolve(filename: str, data_root: Optional[str]) -> str:
    if data_root is None:
        return filename
    import os
    if os.path.isabs(filename):
        return filename
    return os.path.join(data_root, filename)
