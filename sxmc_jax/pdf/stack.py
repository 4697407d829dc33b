"""PdfStack: all of a fit's PDFs as one batched, fused evaluation.

The reference evaluates each signal's PDF on its own CUDA stream and
synchronizes (pdfz.h:17-22, mcmc.cpp:264-271).  Here inter-PDF
concurrency is replaced by *batching*: every signal's MC samples are
concatenated into one array with a segment id, systematics are applied
with per-signal masks, and all histograms are built by a single
segmented bincount (one scatter-add).  The per-step PDF
re-evaluation — the throughput-dominating operation when systematics
float (mcmc.cpp:207-209) — is then one jitted function

    (theta_syst,) -> (lut, norms)

with ``lut`` the (nsignals, nevents) PDF-value table the NLL consumes
(mcmc.cpp:230-242) and ``norms`` the in-domain counts.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sxmc_jax.ops import histogram as hist_ops
from sxmc_jax.ops import transforms
from sxmc_jax.pdf import evalhist
from sxmc_jax.signal import Observable, Signal, Systematic


@dataclasses.dataclass(frozen=True)
class MaskedSystematic:
    """A systematic + which signals it applies to (static)."""

    desc: transforms.SystematicDesc
    signal_mask: Tuple[bool, ...]


def _host_histogram(samples, lower, upper, nbins, weights=None):
    """Host (numpy) histogram bit-matching the device bin-id math.

    Used to precompute the theta-invariant histograms of *static*
    signals (signals no systematic applies to) once at stack build.
    The f32 scale ``nbins / span`` is computed exactly as
    ops/histogram.py compute_bin_ids does, so every sample lands in the
    same bin.  Unweighted counts are integers (exact); weighted sums
    accumulate here in f64, at least as accurate as the device path.
    """
    samples = np.asarray(samples, np.float32)
    nobs = len(nbins)
    strides = hist_ops.bin_strides(nbins)
    n = samples.shape[0]
    valid = np.ones(n, bool)
    ids = np.zeros(n, np.int64)
    for i in range(nobs):
        lo = np.float32(lower[i])
        up = np.float32(upper[i])
        col = samples[:, i]
        valid &= (col >= lo) & (col < up)
        scale = np.float32(np.float32(nbins[i]) / (up - lo))
        axis = np.floor((col - lo) * scale).astype(np.int32)
        np.clip(axis, 0, nbins[i] - 1, out=axis)
        ids += axis.astype(np.int64) * strides[i]
    total = hist_ops.total_bins(nbins)
    if weights is None:
        h = np.bincount(ids[valid], minlength=total)
    else:
        h = np.bincount(ids[valid],
                        weights=np.asarray(weights, np.float64)[valid],
                        minlength=total)
    return h.astype(np.float32)


class PdfStack:
    """Batched evaluator for all PDFs in a fit."""

    def __init__(
        self,
        signals: Sequence[Signal],
        observables: Sequence[Observable],
        systematics: Sequence[Systematic],
    ):
        self.nsignals = len(signals)
        self.nobservables = len(observables)

        nobs = self.nobservables
        lower = [0.0] * nobs
        upper = [1.0] * nobs
        nbins = [1] * nobs
        for obs in observables:
            lower[obs.field_index] = obs.lower
            upper[obs.field_index] = obs.upper
            nbins[obs.field_index] = obs.bins
        self.lower_host = tuple(float(x) for x in lower)
        self.upper_host = tuple(float(x) for x in upper)
        self.lower = np.asarray(lower, np.float32)
        self.upper = np.asarray(upper, np.float32)
        self.nbins = tuple(nbins)
        self.total_nbins = hist_ops.total_bins(self.nbins)
        self.bin_volume = hist_ops.bin_volume(lower, upper, self.nbins)

        # KDE-backed signals (pdf.evalkde) are excluded from the fused
        # binned build; their rows are overridden with grid-evaluated
        # pseudo-counts in histograms().
        from sxmc_jax.pdf.evalkde import EvalKDE

        self._kde = tuple(
            (i, s.histogram) for i, s in enumerate(signals)
            if isinstance(s.histogram, EvalKDE))
        kde_idx = {i for i, _ in self._kde}
        self.has_kde = bool(self._kde)
        # Exact-LUT KDE signals: fits evaluate the KDE exactly at the
        # data event coordinates (no grid discretization).  The event
        # points (and precomputed rows for systematics-free KDEs) ride
        # at the tail of device_data after set_data().
        self._kde_exact = tuple(
            (i, kde) for i, kde in self._kde
            if getattr(kde, "exact_lut", False))
        self._data_points = None
        self._kde_exact_static_rows = None
        self._kde_exact_static_norms = None

        # Concatenate all binned signals' MC samples with a segment id,
        # from the host copies (never read device arrays back to host).
        sample_arrays = [
            s.histogram.samples_host if i not in kde_idx else
            np.empty((0, s.histogram.samples_host.shape[1]), np.float32)
            for i, s in enumerate(signals)]
        self.nfields = max(a.shape[1] for a in sample_arrays)
        # Full concatenation (all binned signals) — kept for the
        # event-sharded chain path (parallel/chain_sharded.py) and the
        # static-histogram precompute below.
        self.samples_host = (
            np.concatenate(sample_arrays, axis=0)
            if sum(a.shape[0] for a in sample_arrays) else
            np.empty((0, self.nfields), np.float32))
        seg = np.concatenate([
            np.full(a.shape[0], i, np.int32)
            for i, a in enumerate(sample_arrays)]) if len(sample_arrays) \
            else np.empty((0,), np.int32)
        self.segment_ids_host = seg
        self.n_mc = jnp.asarray([s.n_mc for s in signals], jnp.float32)
        self.datasets = [s.dataset for s in signals]
        # Unique dataset tags + (ndatasets, nsignals) membership mask —
        # the binned-likelihood analog of the per-event -2 dataset
        # sentinel (compute_read_bins).
        self.unique_datasets = tuple(sorted(set(self.datasets)))
        self.dataset_mask = np.asarray(
            [[1.0 if s == d else 0.0 for s in self.datasets]
             for d in self.unique_datasets], np.float32)

        # Weighted MC samples (an extension over the reference, whose
        # weights were planned-but-withdrawn).
        self.has_weights = any(s.histogram.weights is not None
                               for s in signals)
        if self.has_weights:
            w = np.concatenate([
                np.asarray(s.histogram.weights) if
                s.histogram.weights is not None
                else np.ones(a.shape[0], np.float32)
                for s, a in zip(signals, sample_arrays)])
            self.sample_weights_host = np.asarray(w, np.float32)
        else:
            self.sample_weights_host = None

        # Global systematics with per-signal application masks: signal j
        # applies systematic s iff s was attached to its PDF
        # (signal.cpp:144-165).
        self.systematics: Tuple[MaskedSystematic, ...] = tuple(
            MaskedSystematic(
                desc=transforms.SystematicDesc(
                    type=s.type,
                    obs=s.observable_field_index,
                    par_indices=tuple(s.pidx),
                    extra_field=max(s.truth_field_index, 0)),
                signal_mask=tuple(s.name in sig.systematic_names
                                  for sig in signals))
            for s in systematics)
        self.nsyst_params = sum(s.npars for s in systematics)

        # --- static/dynamic partition -----------------------------------
        # A binned signal no systematic applies to has a theta-INVARIANT
        # histogram: build it once on the host and skip it in every
        # per-step rebuild.  (The reference rebuilds every PDF per
        # step, mcmc.cpp:207-209 — skipping the static ones is free: the
        # per-step build is one batched bincount over only the dynamic
        # segments.)
        touched = np.zeros(self.nsignals, bool)
        for ms in self.systematics:
            touched |= np.asarray(ms.signal_mask, bool)
        self._dyn_idx = tuple(
            i for i in range(self.nsignals)
            if i not in kde_idx and touched[i])
        self._static_idx = tuple(
            i for i in range(self.nsignals)
            if i not in kde_idx and not touched[i])
        self._ndyn = len(self._dyn_idx)

        if self._static_idx:
            stat_h = []
            stat_n = []
            for i in self._static_idx:
                w_i = (np.asarray(signals[i].histogram.weights,
                                  np.float32)
                       if signals[i].histogram.weights is not None
                       else None)
                h = _host_histogram(
                    sample_arrays[i][:, :nobs], lower, upper,
                    self.nbins, weights=w_i)
                stat_h.append(h)
                stat_n.append(h.sum(dtype=np.float64))
            self._static_hists_np = np.stack(stat_h).astype(np.float32)
            self._static_norms_np = np.asarray(stat_n, np.float32)
        else:
            self._static_hists_np = None
            self._static_norms_np = None

        # Dynamic-only arrays feed the per-step rebuild.
        dyn_arrays = [sample_arrays[i] for i in self._dyn_idx]
        if self._ndyn == 0:
            # No dynamic signal: one out-of-domain dummy row keeps the
            # shapes legal; the rebuild never runs.
            dyn_arrays = [np.full((1, self.nfields), lower[0] - 1e9,
                                  np.float32)]
        dyn_samples = np.concatenate(dyn_arrays, axis=0)
        dyn_seg = np.concatenate([
            np.full(a.shape[0], j, np.int32)
            for j, a in enumerate(dyn_arrays)])
        self._dyn_has_weights = self.has_weights and any(
            signals[i].histogram.weights is not None
            for i in self._dyn_idx)
        if self._dyn_has_weights:
            dyn_weights = np.concatenate([
                np.asarray(signals[i].histogram.weights, np.float32)
                if signals[i].histogram.weights is not None
                else np.ones(sample_arrays[i].shape[0], np.float32)
                for i in self._dyn_idx])
        else:
            dyn_weights = None

        # Per-signal masks restricted to the dynamic segments (static
        # entries are all-False by construction).  Systematics touching
        # no dynamic segment (KDE-only) drop out of the rebuild.
        dyn_systs = []
        for ms in self.systematics:
            m = tuple(ms.signal_mask[i] for i in self._dyn_idx)
            if any(m):
                dyn_systs.append(MaskedSystematic(ms.desc, m))
        self._systematics_dyn = tuple(dyn_systs)

        self.samples = jnp.asarray(dyn_samples)
        self.segment_ids = jnp.asarray(dyn_seg)
        self.sample_weights = (jnp.asarray(dyn_weights)
                               if dyn_weights is not None else None)

        self._read_bins = None  # (nsignals, nevents) after set_data

    def set_data(self, data: np.ndarray) -> None:
        """Precompute per-signal read bins for the dataset.

        ``data`` is ``(nevents, nobservables + 1)`` with the dataset tag
        last.  Data points never move under systematics, so this runs
        once per dataset (reference: pdfz.cpp:245-302, mcmc.cpp:231-242).

        With exact-LUT KDE signals the event coordinates are also kept
        on device, and the exact density rows of systematics-free KDE
        signals (theta-invariant) are computed here ONCE.
        """
        data = np.asarray(data, np.float32)
        self._read_bins = self.compute_read_bins(data)
        if self._kde_exact:
            self._data_points = jnp.asarray(data)
            nev = data.shape[0]
            rows = []
            nrms = []
            for i, kde in self._kde_exact:
                if not kde.systematics:
                    row, nrm = kde.eval_at(self._data_points)
                    rows.append(row)
                    nrms.append(nrm)
            self._kde_exact_static_rows = (
                jnp.stack(rows) if rows
                else jnp.zeros((0, nev), jnp.float32))
            self._kde_exact_static_norms = (
                jnp.stack(nrms) if nrms else jnp.zeros((0,), jnp.float32))

    @property
    def nevents(self) -> int:
        if self._read_bins is None:
            raise RuntimeError("set_data() must be called first")
        return self._read_bins.shape[1]

    def data_bin_counts(self, data: np.ndarray,
                        weights: Optional[np.ndarray] = None
                        ) -> jnp.ndarray:
        """Histogram the DATA events once, per dataset: the binned
        likelihood's sufficient statistic.

        Uses the identical bin-id math as :meth:`compute_read_bins`
        (hist_ops.compute_bin_ids), so the binned NLL regroups the
        unbinned one exactly: out-of-domain events are excluded (the
        -1 sentinel) and events whose tag matches no signal's dataset
        fall in no row (the -2 sentinel).  Supports weighted / Asimov
        events.  Batch leading axes are allowed:
        ``(..., nevents, nobs + 1) -> (..., ndatasets, total_nbins)``.
        """
        data = jnp.asarray(data, jnp.float32)
        obs = data[..., :self.nobservables]
        flat = obs.reshape(-1, self.nobservables)
        ids, valid = hist_ops.compute_bin_ids(
            flat, self.lower, self.upper, self.nbins)
        ids = ids.reshape(obs.shape[:-1])
        valid = valid.reshape(obs.shape[:-1])
        tags = data[..., self.nobservables]
        w = (jnp.ones(data.shape[:-1], jnp.float32) if weights is None
             else jnp.asarray(weights, jnp.float32))

        def one(ids1, valid1, tags1, w1):
            rows = []
            for ds in self.unique_datasets:
                sel = valid1 & (tags1 == ds)
                rows.append(hist_ops.fixed_bincount(
                    ids1, jnp.where(sel, w1, 0.0), self.total_nbins))
            return jnp.stack(rows)

        if data.ndim == 2:
            return one(ids, valid, tags, w)
        batch = ids.reshape((-1,) + ids.shape[-1:])
        out = jax.vmap(one)(batch,
                            valid.reshape(batch.shape),
                            tags.reshape(batch.shape),
                            jnp.broadcast_to(w, tags.shape).reshape(
                                batch.shape))
        return out.reshape(data.shape[:-2] +
                           (len(self.unique_datasets), self.total_nbins))

    def counts_from_read_bins(self, read_bins: jnp.ndarray,
                              weights: Optional[jnp.ndarray] = None
                              ) -> jnp.ndarray:
        """Per-dataset data bin counts derived from per-signal read
        bins INSIDE jit: ``(nsignals, nevents) -> (ndatasets,
        total_nbins)``.

        Row j of ``read_bins`` is >= 0 exactly for in-domain events
        carrying signal j's dataset tag (compute_read_bins sentinels),
        so one representative row per unique dataset recovers the
        binned sufficient statistic without a second pass over the raw
        events — and the bin ids are identical to
        :meth:`data_bin_counts` by construction.  This is what lets
        the samplers switch to the binned likelihood while still
        threading only ``read_bins`` through the jit boundary.
        """
        rep = [self.datasets.index(d) for d in self.unique_datasets]
        w = (jnp.ones(read_bins.shape[-1], jnp.float32)
             if weights is None else jnp.asarray(weights, jnp.float32))
        rows = []
        for j in rep:
            rb = read_bins[..., j, :]
            sel = rb >= 0
            rows.append(hist_ops.fixed_bincount(
                jnp.where(sel, rb, 0).astype(jnp.int32),
                jnp.where(sel, w, 0.0), self.total_nbins))
        return jnp.stack(rows, axis=-2)

    # ------------------------------------------------------------------

    @property
    def device_data(self):
        """The MC-sample device arrays, to be passed as jit ARGUMENTS.

        Capturing these as closure constants inside jit would embed
        them in the executable as constants (copied into every compile);
        every jitted entry point threads them explicitly instead.

        After set_data(), exact-LUT KDE fits append three more arrays:
        the event coordinates and the precomputed (rows, norms) of
        systematics-free KDE signals.
        """
        kde_arrays = tuple(kde.samples for _, kde in self._kde)
        if self.sample_weights is not None:
            dd = (self.samples, self.segment_ids,
                  self.sample_weights) + kde_arrays
        else:
            dd = (self.samples, self.segment_ids) + kde_arrays
        if self._kde_exact and self._data_points is not None:
            dd = dd + (self._data_points, self._kde_exact_static_rows,
                       self._kde_exact_static_norms)
        return dd

    def _dynamic_histograms(self, theta_syst, device_data):
        """(ndyn, total_nbins) counts for the dynamic segments only."""
        nseg = max(self._ndyn, 1)
        samples, segment_ids = device_data[0], device_data[1]
        weights = device_data[2] if len(device_data) > 2 else None
        hists, _ = _stack_histograms(
            samples, segment_ids, theta_syst,
            self.lower_host, self.upper_host, self.nbins, nseg,
            self._systematics_dyn, weights)
        return hists

    def _assemble(self, dyn_hists, theta_syst, kde_arrays):
        """Scatter dynamic + cached static (+ KDE) rows into the full
        (nsignals, total_nbins) table."""
        if (self._ndyn == self.nsignals and not self._kde):
            hists = dyn_hists
        else:
            hists = jnp.zeros((self.nsignals, self.total_nbins),
                              jnp.float32)
            if self._ndyn:
                hists = hists.at[np.asarray(self._dyn_idx)].set(
                    dyn_hists[:self._ndyn])
            if self._static_idx:
                hists = hists.at[np.asarray(self._static_idx)].set(
                    self._static_hists_np)
        norms = hists.sum(axis=1)
        # KDE-backed rows: grid-evaluated pseudo-counts replace the
        # (empty) binned rows, same counts/norm contract.
        for (i, kde), arr in zip(self._kde, kde_arrays):
            cnt, nrm = kde.histogram(theta_syst, samples=arr)
            hists = hists.at[i].set(cnt)
            norms = norms.at[i].set(nrm)
        return hists, norms

    def _split_device_data(self, device_data):
        """-> (binned arrays, kde sample arrays, exact-kde extras).

        ``extras`` is None, or ``(points, static_rows, static_norms)``
        when the snapshot was taken after set_data() on an exact-KDE
        stack.
        """
        nbase = 3 if self.sample_weights is not None else 2
        extras = None
        if len(device_data) == nbase + len(self._kde) + 3:
            extras = device_data[-3:]
            device_data = device_data[:-3]
        nkde = len(self._kde)
        kde_arrays = device_data[len(device_data) - nkde:] if nkde else ()
        binned = device_data[:len(device_data) - nkde] if nkde \
            else device_data
        return binned, kde_arrays, extras

    def histograms(self, theta_syst: jnp.ndarray, device_data=None
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(nsignals, total_nbins) counts + (nsignals,) norms at theta."""
        theta_syst = jnp.asarray(theta_syst, jnp.float32)
        if device_data is None:
            device_data = self.device_data
        # KDE sample arrays ride at the tail of device_data (explicit
        # jit arguments, never closure constants).
        binned_data, kde_arrays, _ = self._split_device_data(device_data)
        if self._ndyn:
            dyn_hists = self._dynamic_histograms(theta_syst, binned_data)
        else:
            dyn_hists = None
        return self._assemble(dyn_hists, theta_syst, kde_arrays)

    def compute_read_bins(self, data: np.ndarray) -> jnp.ndarray:
        """Per-signal read bins for a dataset, as an explicit array.

        Events with an unknown dataset tag get the -2 sentinel and
        contribute zero density — padding rows (tag e.g. -1) are thus
        free, which is how ragged experiment batches are vmapped.
        """
        data = jnp.asarray(data)
        obs = data[..., :self.nobservables]
        ids, valid = hist_ops.compute_bin_ids(
            obs.reshape(-1, self.nobservables), self.lower, self.upper,
            self.nbins)
        ids = ids.reshape(obs.shape[:-1])
        valid = valid.reshape(obs.shape[:-1])
        tags = data[..., self.nobservables]
        rb = []
        for ds in self.datasets:
            sig_ids = jnp.where(tags == ds, ids, -2)
            rb.append(jnp.where(valid, sig_ids, -1))
        return jnp.stack(rb, axis=-2)  # (..., nsignals, nevents)

    def _exact_kde_override(self, lut, norms, theta_syst, device_data):
        """Replace exact-LUT KDE rows of (lut, norms) with the KDE
        density evaluated at the event coordinates (no grid bias).

        Systematics-free KDE rows come precomputed from set_data();
        theta-dependent ones re-evaluate exactly each call.
        """
        _, kde_arrays, extras = self._split_device_data(device_data)
        if extras is None:
            raise RuntimeError(
                "use_exact_kde requires a device_data snapshot taken "
                "after set_data() (exact rows are per-dataset)")
        points, static_rows, static_norms = extras
        kde_map = {i: arr for (i, _), arr in zip(self._kde, kde_arrays)}
        slot = 0
        for i, kde in self._kde_exact:
            if kde.systematics:
                row, nrm = kde.eval_at(points, theta_syst,
                                       samples=kde_map[i])
            else:
                row, nrm = static_rows[slot], static_norms[slot]
                slot += 1
            lut = lut.at[..., i, :].set(row)
            norms = norms.at[..., i].set(nrm)
        return lut, norms

    def evaluate(self, theta_syst: jnp.ndarray, read_bins=None,
                 device_data=None, use_exact_kde: bool = False
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Fused re-histogram + LUT build: theta -> (lut, norms).

        This is the inner loop of the MCMC when systematics float.
        ``use_exact_kde=True`` (sampler fit paths only: read_bins must
        correspond to the set_data() dataset) evaluates exact-LUT KDE
        signals at the true event coordinates instead of the bin grid.
        """
        if read_bins is None:
            if self._read_bins is None:
                raise RuntimeError("set_data() must be called first")
            read_bins = self._read_bins
        if device_data is None:
            device_data = self.device_data
        hists, norms = self.histograms(theta_syst, device_data)
        lut = jax.vmap(evalhist.eval_from_bins, in_axes=(0, 0, None, 0))(
            hists, norms, self.bin_volume, read_bins)
        if use_exact_kde and self._kde_exact:
            lut, norms = self._exact_kde_override(
                lut, norms, theta_syst, device_data)
        return lut, norms

    def efficiencies(self, theta_syst) -> jnp.ndarray:
        """Per-signal norm/n_mc at the given systematics."""
        _, norms = self.histograms(jnp.asarray(theta_syst, jnp.float32))
        return norms / self.n_mc

    # ------------------------------------------------------------------
    # Batched multi-chain evaluation: the nchains thetas of a lock-step
    # sampler step, vmapped into one batched rebuild.

    def histograms_batch(self, thetas: jnp.ndarray, device_data=None
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(nchains, nsignals, total_nbins) counts + norms at thetas."""
        thetas = jnp.asarray(thetas, jnp.float32)
        if device_data is None:
            device_data = self.device_data
        return jax.vmap(lambda t: self.histograms(t, device_data))(thetas)

    def evaluate_batch(self, thetas: jnp.ndarray, read_bins=None,
                       device_data=None, use_exact_kde: bool = False
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Batched (lut, norms): thetas (nchains, nsyst) ->
        ((nchains, nsignals, nevents), (nchains, nsignals))."""
        if read_bins is None:
            if self._read_bins is None:
                raise RuntimeError("set_data() must be called first")
            read_bins = self._read_bins
        if device_data is None:
            device_data = self.device_data
        thetas = jnp.asarray(thetas, jnp.float32)
        hists, norms = self.histograms_batch(thetas, device_data)
        nchains = thetas.shape[0]
        lut = jax.vmap(
            lambda h, n: jax.vmap(
                evalhist.eval_from_bins, in_axes=(0, 0, None, 0))(
                    h, n, self.bin_volume, read_bins))(hists, norms)
        if use_exact_kde and self._kde_exact:
            nev = lut.shape[-1]
            _, kde_arrays, extras = self._split_device_data(device_data)
            if extras is None:
                raise RuntimeError(
                    "use_exact_kde requires a device_data snapshot "
                    "taken after set_data()")
            points, static_rows, static_norms = extras
            kde_map = {i: arr
                       for (i, _), arr in zip(self._kde, kde_arrays)}
            slot = 0
            for i, kde in self._kde_exact:
                if kde.systematics:
                    rows, nrms = jax.vmap(
                        lambda t, _i=i, _k=kde: _k.eval_at(
                            points, t, samples=kde_map[_i]))(thetas)
                else:
                    rows = jnp.broadcast_to(
                        static_rows[slot][None], (nchains, nev))
                    nrms = jnp.broadcast_to(static_norms[slot][None],
                                            (nchains,))
                    slot += 1
                lut = lut.at[:, i].set(rows)
                norms = norms.at[:, i].set(nrms)
        return lut, norms


def _apply_masked_systematics(samples, segment_ids, theta, systematics,
                              nsignals):
    """Apply each systematic only to samples of signals that carry it."""
    if not systematics:
        return samples
    cols = [samples[:, i] for i in range(samples.shape[1])]
    for ms in systematics:
        desc = ms.desc
        x = cols[desc.obs]
        if all(ms.signal_mask):
            mask = None
        else:
            mask_per_signal = jnp.asarray(ms.signal_mask)
            mask = mask_per_signal[segment_ids]
        p = jnp.zeros_like(x)
        xi = jnp.ones_like(x)
        for i, pidx in enumerate(desc.par_indices):
            if i > 0:
                xi = xi * x
            p = p + theta[pidx].astype(x.dtype) * xi
        if desc.type == transforms.SHIFT:
            new = x + p
        elif desc.type == transforms.SCALE:
            new = x * (1.0 + p)
        elif desc.type == transforms.CTSCALE:
            new = 1.0 + (x - 1.0) * (1.0 + p)
        elif desc.type == transforms.RESOLUTION_SCALE:
            new = x + p * (x - cols[desc.extra_field])
        else:
            raise ValueError(f"Unknown systematic type id {desc.type}")
        cols[desc.obs] = new if mask is None else jnp.where(mask, new, x)
    return jnp.stack(cols, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("lower", "upper", "nbins", "nsignals", "systematics"))
def _stack_histograms(samples, segment_ids, theta, lower, upper, nbins,
                      nsignals, systematics, weights=None):
    transformed = _apply_masked_systematics(
        samples, segment_ids, theta, systematics, nsignals)
    nobs = len(nbins)
    return hist_ops.segmented_histogram(
        transformed[:, :nobs], segment_ids,
        jnp.ones(samples.shape[0], bool), lower, upper, nbins, nsignals,
        weights=weights)
