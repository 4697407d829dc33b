#!/usr/bin/env python3
"""On-card smoke test: the main path on NVIDIA GPUs at real size.

    python chip_smoke.py          # one card: every single-card phase
    python chip_smoke.py --four   # four cards of one host: only the
                                  # multi-card phases

Phases, in order.  Any failure exits non-zero; no phase catches its own
error and goes on.

1. device: JAX must run on a GPU.  Prints the card's name and power
   limit (nvidia-smi) and JAX's device kind.
2. layers, at real widths, each against a host numpy reference:
   histograms at the pdfz shape (10M samples, 1000 bins, a shift
   systematic at theta != 0), weighted histograms, the LUT at 100k
   eval points, nll_pair at 10 and 40 signals on 10M events, and the
   Asimov data counts.
3. main path: ``sxmc_jax.cli.main`` on a generated 0vbb-shaped config
   (10 signals x 1M MC samples, a floating resolution_scale shared by
   all, 100 energy bins): unbinned at 1M data events, ``--binned`` at
   10M, then the sharded ensemble (4 experiments x 2 chains) on one
   card.
4. ``--four``: the sharded ensemble on a 4-card experiment mesh against
   the same ensemble on one card, and the event-sharded NLL at 10M
   events on 4 cards against the single-card nll_pair.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# Weighted sums accumulate with f32 atomics in an order that changes
# from run to run, so they differ from the float64 host sum in the last
# bits; a bin with >= 100 entries must agree to this relative error.
WEIGHTED_RTOL = 1e-5
WEIGHTED_MIN_ENTRIES = 100
# XLA lowers f32 division on the GPU to an approximate instruction (up
# to 2 ulp from the correctly rounded quotient), and a LUT density is
# count / (norm * bin_volume).
LUT_MAX_ULPS = 2
# A Metropolis accept compares the NLL at two nearby points and resolves
# dNLL ~ 0.5; that difference must match float64 an order of magnitude
# better.  Two device evaluations of one NLL must agree as closely.
NLL_ATOL = 0.05
# The absolute NLL also carries the mean rounding bias of the f32 log,
# a fraction of an ulp per event and the same at nearby points, so it
# cancels in every difference the samplers and interval estimators
# use; at 10^7 events on the GPU it is a few parts in 10^9 of |NLL|.
NLL_RTOL = 1e-8
# Per-experiment limits of two runs of one ensemble agree exactly when
# the chains take the same path.  Across device layouts XLA may sum in
# another order, and a chain that parts at a borderline accept is an
# independent draw of the same posterior: its contour-interval endpoint
# then scatters by a fraction of the interval width (up to 0.56 of the
# median width measured at 500 steps).  One median 68% interval width
# bounds that Monte-Carlo scatter.
LIMIT_TOL_WIDTHS = 1.0
# Best-fit signal rate against the generating rate (1.0).
TRUTH_WIDTHS = 3.0

PDFZ_SAMPLES = 10_000_000
PDFZ_BINS = 1000
EVAL_POINTS = 100_000
NLL_EVENTS = 10_000_000
ONBB_SIGNALS = 10
ONBB_MC = 1_000_000
ONBB_BINS = 100
ONBB_EVENTS = 1_000_000
ONBB_EVENTS_BINNED = 10_000_000
ONBB_STEPS = 3000


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- phase 1

def require_gpu():
    """The device phase: a GPU or a non-zero exit, with no result."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu" or not jax.devices():
        print(f"chip_smoke: needs a GPU, JAX runs on {backend!r}",
              file=sys.stderr)
        sys.exit(1)
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}")
    log(f"device_kind: {dev.device_kind} ({len(jax.devices())} devices)")
    return dev


# ------------------------------------------------------ reference compares

def check_exact(name: str, got, want) -> None:
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    if not same.all():
        i = int(np.flatnonzero(~same.reshape(-1))[0])
        raise AssertionError(
            f"{name}: {int((~same).sum())} of {same.size} differ; first "
            f"at {i}: {got.reshape(-1)[i]!r} != {want.reshape(-1)[i]!r}")
    log(f"{name}: exactly equal ({same.size} values)")


def check_ulps(name: str, got, want, max_ulps: int) -> int:
    """Equal up to ``max_ulps`` units in the last place (f32); NaNs must
    match."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    nan = np.isnan(want)
    if got.shape != want.shape or not np.array_equal(np.isnan(got), nan):
        raise AssertionError(f"{name}: shape or NaN sentinels differ")
    gi = got[~nan].view(np.int32).astype(np.int64)
    wi = want[~nan].view(np.int32).astype(np.int64)
    ulps = np.abs(gi - wi)
    worst = int(ulps.max()) if ulps.size else 0
    if worst > max_ulps:
        raise AssertionError(f"{name}: {worst} ulp > {max_ulps}")
    log(f"{name}: max {worst} ulp; {int((ulps == 0).sum())} of "
        f"{ulps.size} non-NaN values exactly equal (limit {max_ulps} ulp)")
    return worst


def check_weighted(name: str, got, want, entries) -> float:
    """Per-bin relative error on bins with enough entries."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    sel = np.asarray(entries) >= WEIGHTED_MIN_ENTRIES
    if not sel.any():
        raise AssertionError(f"{name}: no bin has "
                             f"{WEIGHTED_MIN_ENTRIES} entries")
    rel = np.abs(got[sel] - want[sel]) / np.abs(want[sel])
    worst = float(rel.max())
    if worst > WEIGHTED_RTOL:
        raise AssertionError(
            f"{name}: max relative error {worst:.3g} > {WEIGHTED_RTOL}")
    log(f"{name}: max relative error {worst:.3g} over {int(sel.sum())} "
        f"bins (limit {WEIGHTED_RTOL})")
    return worst


def host_lut(hist, norm, bin_volume: float, read_bins) -> np.ndarray:
    """Host LUT with the EvalHist sentinels, in the device's f32 ops:
    hist[rb] / (norm * bin_volume); -1 -> NaN, -2 -> 0."""
    hist = np.asarray(hist, np.float32)
    rb = np.asarray(read_bins)
    denom = np.float32(norm) * np.float32(bin_volume)
    vals = hist[np.clip(rb, 0, hist.shape[-1] - 1)] / denom
    vals = np.where(rb == -2, np.float32(0.0), vals)
    return np.where(rb == -1, np.float32(np.nan), vals).astype(np.float32)


def host_nll(pars, w, lut, st, chunk: int = 1 << 20) -> float:
    """float64 extended-ML NLL (ops.nll term for term) from the f32
    per-signal weights ``w`` the device formed (ops.nll.signal_weights),
    so the compare measures the event mix and the compensated
    reduction."""
    pars = np.asarray(pars, np.float32)
    if (pars[:st.nsources] < 0).any():
        return float(np.float32(1e18))
    w64 = np.asarray(w, np.float64)
    lut = np.asarray(lut)
    ev = 0.0
    for a in range(0, lut.shape[1], chunk):
        block = np.nan_to_num(lut[:, a:a + chunk].astype(np.float64),
                              nan=0.0, posinf=0.0, neginf=0.0)
        s = w64 @ block
        ev += float(np.log(s[s > 0]).sum())
    sig = np.asarray(st.sigmas, np.float64)
    z = np.where(sig > 0, (pars - np.asarray(st.means)) / np.where(
        sig > 0, sig, 1.0), 0.0)
    return -ev + float(w64.sum()) + 0.5 * float((z * z).sum())


def _pair_value(pair) -> float:
    return float(np.float64(pair[0]) + np.float64(pair[1]))


def check_nll(name: str, got_pair, want: float) -> float:
    """Two evaluations of one NLL agree to NLL_ATOL."""
    got = _pair_value(got_pair)
    diff = abs(got - want)
    if not np.isfinite(got) or diff > NLL_ATOL:
        raise AssertionError(
            f"{name}: NLL {got!r} vs {want!r}: |diff| {diff:.3g} > "
            f"{NLL_ATOL}")
    log(f"{name}: NLL {got:.6f} vs {want:.6f}, |diff| {diff:.3g} "
        f"(limit {NLL_ATOL})")
    return diff


def check_nll_vs_f64(name: str, got_pairs, wants) -> dict:
    """Device NLL at two nearby points against float64: the difference
    to NLL_ATOL, each absolute value to NLL_RTOL."""
    got = [_pair_value(p) for p in got_pairs]
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, wants))
    delta = abs((got[1] - got[0]) - (wants[1] - wants[0]))
    if not np.isfinite(got).all() or rel > NLL_RTOL or delta > NLL_ATOL:
        raise AssertionError(
            f"{name}: NLL {got} vs float64 {wants}: relative {rel:.3g} "
            f"(limit {NLL_RTOL}), difference off by {delta:.3g} "
            f"(limit {NLL_ATOL})")
    log(f"{name}: NLL {got[0]:.6f} vs float64 {wants[0]:.6f} (|diff| "
        f"{abs(got[0] - wants[0]):.3g}, relative {rel:.3g}, limit "
        f"{NLL_RTOL}); NLL difference to a nearby point "
        f"{got[1] - got[0]:.6f} vs {wants[1] - wants[0]:.6f} (off by "
        f"{delta:.3g}, limit {NLL_ATOL})")
    return {"rel": rel, "delta": delta}


# ----------------------------------------------------------------- phase 2

def _pdfz_stack(samples, weights=None):
    from sxmc_jax.ops import transforms
    from sxmc_jax.pdf.stack import PdfStack
    from sxmc_jax.signal import Observable, Signal, Source, Systematic

    nbins = PDFZ_BINS
    obs = Observable(name="x", field="x", bins=nbins, lower=0.0,
                     upper=1.0, field_index=0)
    syst = Systematic(name="shift", type=transforms.SHIFT,
                      observable_field="x", means=[0.0], sigmas=[0.01],
                      observable_field_index=0, pidx=[0])
    src = Source(name="s", index=0, mean=1.0)
    sig = Signal.from_table("s", "s", samples, ["x"], 0, src, 1000.0,
                            ["x", "DATASET"], [obs], [], [syst])
    if weights is not None:
        sig.histogram.weights = weights
    return PdfStack([sig], [obs], [syst])


def synthetic_nll_inputs(nsig: int, nevents: int, seed: int):
    """A (nsig, nevents) LUT of densities made on the device, with the
    out-of-domain NaN sentinel sprinkled in, and fit constants whose
    expected counts add up to nevents."""
    import jax
    import jax.numpy as jnp

    from sxmc_jax.ops.nll import NLLStatic

    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    lut = jax.random.uniform(k1, (nsig, nevents), jnp.float32, 0.01, 0.3)
    lut = jnp.where(jax.random.uniform(k2, lut.shape) < 0.01, jnp.nan,
                    lut)
    rng = np.random.default_rng(seed)
    n_mc = np.full(nsig, 1e6, np.float32)
    st = NLLStatic(
        nexpected=np.full(nsig, nevents / nsig, np.float32),
        n_mc=n_mc,
        source_id=np.arange(nsig, dtype=np.int32),
        means=np.ones(nsig + 1, np.float32),
        sigmas=np.where(np.arange(nsig + 1) % 2 == 1, 0.1, 0.0).astype(
            np.float32),
        nsources=nsig)
    norms = (n_mc * rng.uniform(0.8, 1.0, nsig)).astype(np.float32)
    pars = (1.0 + rng.normal(0, 0.01, nsig + 1)).astype(np.float32)
    return pars, lut, norms, st


def layer_phase(n_samples: int = PDFZ_SAMPLES, n_eval: int = EVAL_POINTS,
                n_events: int = NLL_EVENTS, nsigs=(10, 40),
                onbb_mc: int = ONBB_MC, seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp

    from sxmc_jax.mcmc.metropolis import MCMC
    from sxmc_jax.ops.nll import nll_pair, signal_weights
    from sxmc_jax.pdf.stack import _host_histogram
    from sxmc_jax.stats.asimov import asimov_dataset

    out = {}
    rng = np.random.default_rng(seed)
    # pdfz shape: Gaussian MC on [0, 1) (bench_sxmc.cpp:34-102).
    samples = rng.normal(0.5, 0.15, (n_samples, 1)).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, n_samples).astype(np.float32)
    theta = np.float32(0.0123)
    shifted = samples[:, :1] + theta  # the SHIFT transform, in f32
    lower, upper, nbins = [0.0], [1.0], (PDFZ_BINS,)

    stack = _pdfz_stack(samples)
    hists, norms = stack.histograms(jnp.asarray([theta]))
    want = _host_histogram(shifted, lower, upper, nbins)
    check_exact("histogram (unweighted)", hists[0], want)

    wstack = _pdfz_stack(samples, weights)
    whists, _ = wstack.histograms(jnp.asarray([theta]))
    wwant = _host_histogram(shifted, lower, upper, nbins, weights=weights)
    out["weighted_max_rel"] = check_weighted(
        "histogram (weighted)", whists[0], wwant, want)
    del wstack, whists

    points = np.stack([rng.uniform(-0.05, 1.05, n_eval),
                       rng.choice([0.0, 1.0], n_eval, p=[0.95, 0.05])],
                      axis=1).astype(np.float32)
    rb = stack.compute_read_bins(points)
    lut, lnorms = stack.evaluate(jnp.asarray([theta]), rb)
    scale = np.float32(np.float32(PDFZ_BINS) / np.float32(1.0))
    ids = np.clip(np.floor(points[:, 0] * scale).astype(np.int32), 0,
                  PDFZ_BINS - 1)
    valid = (points[:, 0] >= 0.0) & (points[:, 0] < 1.0)
    rb_host = np.where(valid, np.where(points[:, 1] == 0.0, ids, -2), -1)
    check_exact("read bins", np.asarray(rb)[0], rb_host)
    out["lut_max_ulps"] = check_ulps(
        "LUT", lut[0], host_lut(want, want.sum(), stack.bin_volume,
                                rb_host), LUT_MAX_ULPS)
    del stack, hists, lut

    for nsig in nsigs:
        pars, lut, lnorms, st = synthetic_nll_inputs(nsig, n_events, seed)
        nll_fn = jax.jit(lambda p, l, n: nll_pair(p, l, n, st))
        w_fn = jax.jit(lambda p, n: signal_weights(p, n, st))
        lut_h = np.asarray(lut)
        got, want = [], []
        # A proposal-sized move: every rate up by one part in 10^3.
        for p in (pars, pars * np.float32(1.001)):
            got.append(nll_fn(jnp.asarray(p), lut, jnp.asarray(lnorms)))
            w = w_fn(jnp.asarray(p), jnp.asarray(lnorms))
            want.append(host_nll(p, w, lut_h, st))
        out[f"nll_{nsig}"] = check_nll_vs_f64(
            f"nll_pair ({nsig} signals, {n_events} events)", got, want)
        del lut, lut_h

    sources, signals, systs, obs = onbb_model(onbb_mc, ONBB_EVENTS, seed)
    model = MCMC(sources, signals, systs, obs)
    events, ew = asimov_dataset(model)
    counts = model.stack.data_bin_counts(events, ew)
    st = model.stack
    check_exact("Asimov data counts", counts[0], _host_histogram(
        events[:, :1], st.lower_host, st.upper_host, st.nbins,
        weights=ew))
    return out


# ----------------------------------------------------------------- phase 3

def onbb_tables(n_mc: int, seed: int):
    """0vbb-shaped MC: a line at 10 (signal 0) over nine falling
    backgrounds of distinct slopes, smeared by 0.3; columns (energy,
    energy_true)."""
    rng = np.random.default_rng(seed)
    tables = []
    for k in range(ONBB_SIGNALS):
        if k == 0:
            truth = np.full(n_mc, 10.0, np.float32)
        else:
            truth = (4.0 + rng.exponential(1.5 * k, n_mc)).astype(
                np.float32)
        energy = truth + rng.normal(0, 0.3, n_mc).astype(np.float32)
        tables.append(np.stack([energy, truth], axis=1))
    return tables


def onbb_model(n_mc: int, n_events: int, seed: int):
    """The phase-3 model built in-process (sources, signals, systs,
    observables)."""
    from sxmc_jax.ops import transforms
    from sxmc_jax.signal import Observable, Signal, Source, Systematic

    obs = Observable(name="energy", field="energy", bins=ONBB_BINS,
                     lower=5.0, upper=15.0, field_index=0)
    syst = Systematic(name="res", type=transforms.RESOLUTION_SCALE,
                      observable_field="energy", truth_field="energy_true",
                      means=[0.0], sigmas=[0.05], observable_field_index=0,
                      truth_field_index=1, pidx=[0])
    fields = ["energy", "energy_true", "DATASET"]
    sources, signals = [], []
    for k, table in enumerate(onbb_tables(n_mc, seed)):
        src = Source(name=f"sig{k}", index=k, mean=1.0,
                     sigma=0.0 if k == 0 else 0.1)
        sources.append(src)
        signals.append(Signal.from_table(
            src.name, src.name, table, ["energy", "energy_true"], 0, src,
            n_events / ONBB_SIGNALS, fields, [obs], [], [syst]))
    return sources, signals, [syst], [obs]


def write_onbb_config(workdir: str, n_mc: int, n_events: int,
                      nsteps: int, seed: int) -> str:
    """The 0vbb-shaped fit as JSON + .npz tables in ``workdir``."""
    from sxmc_jax.io import loaders

    os.makedirs(workdir, exist_ok=True)
    signals = {}
    for k, table in enumerate(onbb_tables(n_mc, seed)):
        fn = os.path.join(workdir, f"sig{k}.npz")
        if not os.path.exists(fn):
            loaders.write_float_table(fn, table, ["energy", "energy_true"])
        signals[f"sig{k}"] = {
            "title": f"sig{k}", "filename": fn, "dataset": 0,
            "systematics": ["res"], "rate": n_events / ONBB_SIGNALS,
            "sigma": 0.0 if k == 0 else 0.1}
    config = {
        "fit": {"nexperiments": 1, "nsteps": nsteps,
                "burnin_fraction": 0.2, "signal_name": "sig0",
                "signals": sorted(signals, key=lambda s: int(s[3:])),
                "observables": ["energy"], "plots": False, "seed": seed,
                # Haario full-covariance proposals: the ten rates are
                # strongly anticorrelated under the fixed total.
                "proposal": "full_cov"},
        "pdfs": {
            "observables": {"energy": {
                "title": "Energy", "field": "energy", "bins": ONBB_BINS,
                "min": 5.0, "max": 15.0}},
            "systematics": {"res": {
                "title": "Resolution", "type": "resolution_scale",
                "observable_field": "energy", "truth_field": "energy_true",
                "mean": [0.0], "sigma": [0.05]}}},
        "signals": signals,
    }
    path = os.path.join(workdir, f"onbb_{n_events}.json")
    with open(path, "w") as f:
        json.dump(config, f, indent=1)
    return path


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def check_fit_output(name: str, outdir: str, stdout: str,
                     signal: str = "sig0") -> dict:
    """cli.main's outputs: a finite likelihood space whose best-fit
    signal rate lies near the generating rate, and the interval line."""
    from sxmc_jax.stats.likelihood import LikelihoodSpace

    path = os.path.join(outdir, "lspace_0.npz")
    ls = LikelihoodSpace.load(path)
    if not (np.isfinite(ls.samples).all()
            and np.isfinite(ls.nll_values).all()):
        raise AssertionError(f"{name}: non-finite likelihood space")
    bf = ls.get_best_fit()[signal]
    width = 0.5 * (bf.upper - bf.lower)
    if not width > 0 or abs(bf.point_estimate - 1.0) > TRUTH_WIDTHS * width:
        raise AssertionError(
            f"{name}: {signal} best fit {bf} is not within "
            f"{TRUTH_WIDTHS} widths of 1.0")
    line = re.search(rf"^ {signal}: \S+ -\S+ \+\S+$", stdout, re.M)
    if line is None:
        raise AssertionError(f"{name}: no interval line for {signal}")
    with open(os.path.join(outdir, "lspace_metrics.jsonl")) as f:
        fit = [json.loads(r) for r in f
               if json.loads(r)["event"] == "experiment_fit"][-1]
    log(f"{name}: {line.group(0).strip()} (truth 1.0), "
        f"{fit['steps_per_sec']:.6g} steps/s, "
        f"{fit['wall_seconds']:.6g} s fit wall time")
    return {"steps_per_sec": fit["steps_per_sec"],
            "wall_seconds": fit["wall_seconds"]}


def run_cli(name: str, argv) -> str:
    from sxmc_jax import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = cli.main(list(argv))
    if rc != 0:
        raise AssertionError(f"{name}: cli.main returned {rc}")
    log(f"{name}: cli.main wall time {time.perf_counter() - t0:.6g} s "
        "(compile included)")
    return buf.getvalue()


def main_path_phase(workdir: str, n_mc: int = ONBB_MC,
                    n_events: int = ONBB_EVENTS,
                    n_events_binned: int = ONBB_EVENTS_BINNED,
                    nsteps: int = ONBB_STEPS, sharded_steps: int = 1000,
                    seed: int = 1) -> dict:
    from sxmc_jax.fitconfig import FitConfig
    from sxmc_jax.parallel.ensemble import run_sharded_ensemble
    from sxmc_jax.utils import median

    out = {}
    cfg = write_onbb_config(workdir, n_mc, n_events, nsteps, seed)
    od = os.path.join(workdir, "unbinned")
    text = run_cli("unbinned", [cfg, od])
    out["unbinned"] = check_fit_output(f"unbinned ({n_events} events)",
                                       od, text)

    cfg_b = write_onbb_config(workdir, n_mc, n_events_binned, nsteps, seed)
    od = os.path.join(workdir, "binned")
    text = run_cli("binned", [cfg_b, od, "--binned"])
    out["binned"] = check_fit_output(
        f"binned ({n_events_binned} events)", od, text)

    fc = FitConfig.from_json_file(cfg)
    fc.nexperiments, fc.nchains = 4, 2
    t0 = time.perf_counter()
    _, limits = run_sharded_ensemble(fc, nsteps=sharded_steps,
                                     verbose=False)
    wall = time.perf_counter() - t0
    med = median(list(limits))
    if len(limits) != 4 or not np.isfinite(limits).all() \
            or not np.isfinite(med):
        raise AssertionError(f"sharded ensemble: limits {limits}")
    rate = 4 * 2 * sharded_steps / wall
    log(f"sharded ensemble (4 exp x 2 chains, {sharded_steps} steps): "
        f"median limit {med:.6g}, {rate:.6g} chain-steps/s, "
        f"{wall:.6g} s wall time (compile included)")
    out["sharded"] = {"median_limit": med, "chain_steps_per_sec": rate,
                      "wall_seconds": wall}
    return out


# ----------------------------------------------------------------- phase 4

def _limit_widths(lspaces, signal: str) -> np.ndarray:
    w = []
    for ls in lspaces:
        bf = ls.get_best_fit()[signal]
        w.append(bf.upper - bf.lower)
    return np.asarray(w)


def four_card_phase(workdir: str, ndev: int = 4, n_mc: int = ONBB_MC,
                    n_events: int = ONBB_EVENTS, nexp: int = 8,
                    nsteps: int = 1500, nll_events: int = NLL_EVENTS,
                    seed: int = 2) -> dict:
    import jax
    import jax.numpy as jnp

    from sxmc_jax.fitconfig import FitConfig
    from sxmc_jax.ops.nll import nll_pair
    from sxmc_jax.parallel import mesh as mesh_lib
    from sxmc_jax.parallel import nll_sharded
    from sxmc_jax.parallel.ensemble import run_sharded_ensemble

    devices = jax.devices()
    if len(devices) < ndev:
        raise AssertionError(f"--four needs {ndev} devices, "
                             f"found {len(devices)}")
    out = {}
    cfg = write_onbb_config(workdir, n_mc, n_events, nsteps, seed)
    fc = FitConfig.from_json_file(cfg)
    fc.nexperiments, fc.nchains = nexp, 1
    runs = {}
    for n in (ndev, 1):
        mesh = mesh_lib.make_mesh(exp=n, devices=devices[:n])
        t0 = time.perf_counter()
        ls, limits = run_sharded_ensemble(fc, mesh=mesh, nsteps=nsteps,
                                          verbose=False)
        wall = time.perf_counter() - t0
        runs[n] = (ls, np.asarray(limits, np.float64))
        log(f"sharded ensemble on {n} card(s) ({nexp} exp, {nsteps} "
            f"steps): {nexp * nsteps / wall:.6g} chain-steps/s, "
            f"{wall:.6g} s wall time (compile included)")
        out[f"ensemble_{n}_cards_wall_seconds"] = wall
    (ls4, lim4), (ls1, lim1) = runs[ndev], runs[1]
    tol = LIMIT_TOL_WIDTHS * float(np.median(
        _limit_widths(ls1, fc.signal_name)))
    diff = np.abs(lim4 - lim1)
    if not (np.isfinite(lim4).all() and (diff <= tol).all()):
        raise AssertionError(
            f"limits on {ndev} cards {lim4} vs 1 card {lim1}: "
            f"|diff| {diff} > {tol}")
    log(f"ensemble limits, {ndev} cards vs 1: max |diff| "
        f"{float(diff.max()):.3g} (limit {tol:.3g} = {LIMIT_TOL_WIDTHS} "
        f"median interval width), {int((diff == 0).sum())} of {nexp} "
        "identical")

    pars, lut, norms, st = synthetic_nll_inputs(10, nll_events, seed)
    ref = jax.jit(lambda p, l, n: nll_pair(p, l, n, st))(
        jnp.asarray(pars), lut, jnp.asarray(norms))
    ref = float(np.float64(ref[0]) + np.float64(ref[1]))
    mesh = mesh_lib.make_mesh(event=ndev, devices=devices[:ndev])
    got = nll_sharded.event_sharded_nll(mesh, st)(
        jnp.asarray(pars), nll_sharded.shard_lut(mesh, lut),
        jnp.asarray(norms))
    out["event_sharded_nll_diff"] = check_nll(
        f"event-sharded NLL ({ndev} cards, {nll_events} events) vs "
        "1-card nll_pair", got, ref)
    return out


# --------------------------------------------------------------------- main

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the multi-card phases, on 4 cards")
    args = parser.parse_args(argv)

    dev = require_gpu()
    import jax

    from sxmc_jax.utils import configure_compile_cache

    log(f"compile cache: {configure_compile_cache()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.four:
            four_card_phase(workdir)
        else:
            layer_phase()
            main_path_phase(workdir)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
