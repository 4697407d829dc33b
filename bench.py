"""Headline benchmark: pdfz-equivalent histogramming throughput.

Mirrors the reference benchmark ``bench_sxmc pdfz``
(reference: bench/bench_sxmc.cpp:34-102): 10M Gaussian samples, 100k
evaluation points, 1000 bins, one shift systematic; repeated full PDF
evaluations (re-histogram + evaluate at the data points).  Metric =
samples histogrammed per second.  Baseline: 2.99546e9 samples/s on an
NVIDIA Tesla K40, the best published reference number (README.md:322).

Runs on a GPU only: with no GPU it exits non-zero and measures
nothing.

Timing: the repetition loop runs inside one jit (``lax.fori_loop``);
each metric is warmed up once (compilation), then timed as the best of
three calls, each ended by ``block_until_ready``.  A window is tens of
milliseconds or more, so the microseconds of dispatch do not count.
Device arrays are always jit arguments, never closure constants.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "device": {"platform": ..., "kind": ..., "count": N}}
Extra metrics (--suite): BENCH_extra.json + stderr lines.
"""

import json
import sys
import time

import numpy as np

BASELINE_K40 = 2.99546e9  # samples/s, reference README.md:322

NSAMPLES = 10_000_000
NEVAL = 100_000
NBINS = 1000
REPS = 500


def _device() -> dict:
    """The device every result names; no GPU is a failure, not a CPU
    number."""
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py: needs a GPU, JAX runs on "
                 f"{jax.default_backend()!r}")
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _per_rep(fn, n, args, trials: int = 3):
    """Seconds per repetition of a jitted ``fn`` that runs ``n`` reps:
    one warm-up call (compilation), then the best of ``trials``."""
    import jax

    jax.block_until_ready(fn(*args))
    best = None
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best / n


def main() -> None:
    import jax
    import jax.numpy as jnp

    from sxmc_jax.ops import histogram as hist_ops
    from sxmc_jax.ops import transforms
    from sxmc_jax.ops.transforms import SHIFT, SystematicDesc
    from sxmc_jax.pdf.evalhist import EvalHist, eval_from_bins

    device = _device()

    rng = np.random.default_rng(20230817)
    # Gaussian at 0.5, sigma 0.15 on [0, 1) — bench_sxmc.cpp:54-57.
    samples = rng.normal(0.5, 0.15, (NSAMPLES, 1)).astype(np.float32)
    eval_points = np.stack([
        rng.uniform(0.0, 1.0, NEVAL).astype(np.float32),
        np.zeros(NEVAL, np.float32)], axis=1)

    ev = EvalHist(samples, 1, 1, [0.0], [1.0], [NBINS])
    syst = SystematicDesc(SHIFT, obs=0, par_indices=(0,))
    ev.add_systematic(syst)
    # Eval-point bins once, like the reference's one-time SetEvalPoints
    # precompute (pdfz.cpp:245-302): the per-eval work is histogram +
    # LUT only.
    read_bins = ev.compute_read_bins(eval_points)
    dd = (jnp.asarray(samples),)

    def _eval(theta, read_bins, device_data):
        (s,) = device_data
        t = transforms.apply_systematics(s, theta, (syst,))
        ids, valid = hist_ops.compute_bin_ids(
            t[:, :1], ev.lower, ev.upper, (NBINS,))
        bins = hist_ops.fixed_bincount(
            ids, valid.astype(jnp.float32), NBINS)
        norm = bins.sum()
        return eval_from_bins(bins, norm, ev.bin_volume,
                              read_bins), norm

    def make_reps(nreps):
        @jax.jit
        def f(read_bins, *device_data):
            def body(i, acc):
                theta = jnp.full((1,), 1e-6 * i, jnp.float32)
                values, norm = _eval(theta, read_bins, device_data)
                return acc + values[0] + norm
            return jax.lax.fori_loop(0, nreps, body, jnp.float32(0))
        return f

    per_rep = _per_rep(make_reps(REPS), REPS, (read_bins, *dd))

    # Correctness spot check (after all timing).
    theta0 = jnp.zeros((1,), jnp.float32)
    _, norm = _eval(theta0, read_bins, dd)
    assert float(norm) > 0.99 * NSAMPLES

    rate = NSAMPLES / per_rep
    print(json.dumps({
        "metric": "pdfz_samples_histogrammed_per_sec",
        "value": rate,
        "unit": "samples/s",
        "vs_baseline": rate / BASELINE_K40,
        "device": device,
    }))
    print(f"# {per_rep*1e3:.3f} ms/rep on {device['kind']}",
          file=sys.stderr)


def bench_group():
    """29-signal group scenario (reference: bench_sxmc.cpp:105-225).

    Ragged per-signal sample counts (1e3..3e6, ~4.9M total) histogrammed
    as one segmented build through PdfStack.histograms — the reference
    used one CUDA stream per PDF; here concurrency is batching.
    """
    import jax
    import jax.numpy as jnp

    from sxmc_jax.pdf.stack import PdfStack
    from sxmc_jax.signal import Observable, Signal, Source, Systematic

    rng = np.random.default_rng(29)
    nsignals = 29
    raw = np.exp(rng.uniform(np.log(1e3), np.log(3e6), nsignals))
    counts = np.maximum((raw * (4.9e6 / raw.sum())).astype(int), 100)
    total = int(counts.sum())

    obs = Observable(name="x", field="x", bins=1000, lower=0.0,
                     upper=1.0, field_index=0)
    syst = Systematic(name="shift", type=0, observable_field="x",
                      means=[0.0], sigmas=[0.01],
                      observable_field_index=0, pidx=[0])
    signals = []
    for k in range(nsignals):
        src = Source(name=f"s{k}", index=k, mean=1.0)
        mc = rng.normal(0.5, 0.2, (int(counts[k]), 1)).astype(np.float32)
        signals.append(Signal.from_table(
            src.name, src.name, mc, ["x"], 0, src, 100.0,
            ["x", "DATASET"], [obs], [], [syst]))
    stack = PdfStack(signals, [obs], [syst])
    dd = stack.device_data
    nreps = 200

    @jax.jit
    def f(*dd):
        def body(i, acc):
            theta = jnp.full((1,), 1e-6 * i, jnp.float32)
            bins, _ = stack.histograms(theta, dd)
            return acc + bins[0, 0] + bins.sum()
        return jax.lax.fori_loop(0, nreps, body, jnp.float32(0))

    per_rep = _per_rep(f, nreps, dd)
    return {"metric": "pdfz_group_samples_per_sec",
            "value": total / per_rep, "unit": "samples/s",
            "detail": f"{nsignals} signals, {total} samples, "
                      f"{per_rep*1e3:.3f} ms/rebuild"}


def bench_mcmc():
    """MCMC steps/s with floating systematics (full PDF rebuild per
    step) and NLL evaluations/s on a fixed LUT."""
    import jax
    import jax.numpy as jnp

    from sxmc_jax.mcmc import metropolis
    from sxmc_jax.ops.nll import nll as nll_fn
    from sxmc_jax.signal import Observable, Signal, Source, Systematic
    from sxmc_jax.mcmc.metropolis import MCMC

    rng = np.random.default_rng(5)
    obs = Observable(name="energy", field="energy", bins=100, lower=5.0,
                     upper=15.0, field_index=0)
    syst = Systematic(name="shift", type=0, observable_field="energy",
                      means=[0.0], sigmas=[0.05],
                      observable_field_index=0, pidx=[0])
    sample_fields = ["energy", "DATASET"]
    n_mc = 1_000_000
    sig_mc = rng.normal(10, 1, (n_mc, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (n_mc, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "s", sig_mc, ["energy"], 0, src_s,
                            1000.0, sample_fields, [obs], [], [syst])
    bkg = Signal.from_table("bkg", "b", bkg_mc, ["energy"], 0, src_b,
                            2000.0, sample_fields, [obs], [], [])
    mcmc = MCMC([src_s, src_b], [sig, bkg], [syst], [obs])

    nevents = 3000
    data = np.stack([rng.uniform(5, 15, nevents).astype(np.float32),
                     np.zeros(nevents, np.float32)], axis=1)
    mcmc.stack.set_data(data)
    rb = mcmc.stack._read_bins
    dd = mcmc.stack.device_data

    p0, nll0, w0 = metropolis.initial_state(mcmc, rb, dd)

    def seg_fn(nsteps):
        def f(p0, nll0, w0, rb, *dd):
            out = metropolis.run_segment(mcmc, p0, nll0, w0, rb, dd,
                                         jax.random.PRNGKey(1), nsteps)
            return out[1][0]  # final NLL hi part
        return f

    n = 5000
    per_step = _per_rep(seg_fn(n), n, (p0, nll0, w0, rb, *dd))

    # Blocked Metropolis-within-Gibbs: M extra rate-only updates per
    # systematic update reuse the carried LUT (no PDF rebuild) — the
    # rebuild that dominates per_step above amortizes over 1+M
    # parameter updates.
    M = 4

    def seg_blocked_fn(nsteps):
        def f(p0, nll0, w0, rb, *dd):
            out = metropolis.run_segment(mcmc, p0, nll0, w0, rb, dd,
                                         jax.random.PRNGKey(1), nsteps,
                                         False, M)
            return out[1][0]
        return f

    nb = 2500
    per_cycle = _per_rep(seg_blocked_fn(nb), nb, (p0, nll0, w0, rb, *dd))
    blocked_rate = (M + 1) / per_cycle

    # NLL-only evals/s (fixed LUT), fori inside one jit.
    theta0 = jnp.zeros(1, jnp.float32)
    lut, norms = mcmc.stack.evaluate(theta0, rb)
    nbatch = 8192

    nreps = 2000

    @jax.jit
    def nll_reps(lut, norms):
        def body(i, acc):
            pars = jnp.ones((nbatch, mcmc.nparameters), jnp.float32)
            pars = pars * (1.0 + 1e-6 * i)
            vals = jax.vmap(
                lambda p: nll_fn(p, lut, norms, mcmc.static))(pars)
            return acc + vals[0]
        return jax.lax.fori_loop(0, nreps, body, jnp.float32(0))

    per_batch = _per_rep(nll_reps, nreps, (lut, norms))

    # Chains/s scaling: 1 chain via run_segment, 8 chains via the
    # batched lock-step runner (one fused chains x signals rebuild per
    # step — the production nchains>1 path).
    def chains_fn(nchains, nsteps):
        if nchains == 1:
            def f(p0, nll0, w0, rb, *dd):
                key = jax.random.PRNGKey(3)
                return metropolis.run_segment(
                    mcmc, p0, nll0, w0, rb, dd, key, nsteps)[1][0]
            return f

        def f(p0, nll0, w0, rb, *dd):
            keys = jax.random.split(jax.random.PRNGKey(3), nchains)
            _, nl, _ = metropolis._run_chains_batched(
                mcmc, keys, rb, dd, nsteps, 0, False)
            return nl[0][:, -1].sum()
        return f

    chain_rates = {}
    for nchains in (1, 8):
        n = 2500
        per = _per_rep(chains_fn(nchains, n), n, (p0, nll0, w0, rb, *dd))
        chain_rates[nchains] = nchains / per

    # A config/example.json-scale experiment is 100k steps
    # (reference config/example.json "nsteps": 100000).
    exp_per_hour = 3600.0 / (100_000 * per_step)

    return [
        {"metric": "mcmc_steps_per_sec_floating_syst",
         "value": 1.0 / per_step, "unit": "steps/s",
         "detail": f"2 signals x {n_mc} MC samples rebuilt per step, "
                   f"{nevents} events, {per_step*1e3:.3f} ms/step"},
        {"metric": "ensemble_experiments_per_hour_per_chip",
         "value": exp_per_hour, "unit": "experiments/h",
         "detail": "100k-step experiments, floating systematics"},
        {"metric": "mcmc_updates_per_sec_blocked",
         "value": blocked_rate, "unit": "param-updates/s",
         "detail": f"blocked within-Gibbs, 1 syst rebuild + {M} "
                   f"fixed-LUT rate updates per cycle, "
                   f"{per_cycle*1e3:.3f} ms/cycle"},
        {"metric": "nll_evals_per_sec", "value": nbatch / per_batch,
         "unit": "evals/s",
         "detail": f"fixed LUT, {nevents} events x 2 signals, "
                   f"batch {nbatch}"},
        {"metric": "chain_steps_per_sec_1chain",
         "value": chain_rates[1], "unit": "chain-steps/s",
         "detail": "single chain"},
        {"metric": "chain_steps_per_sec_8chains",
         "value": chain_rates[8], "unit": "chain-steps/s",
         "detail": "8 lock-step chains, one batched rebuild/step"},
    ]


def bench_sharded_ensemble(n_mc: int = 1_000_000, nevents: int = 3000,
                           nexp: int = 4, nchain: int = 2):
    """Per-device throughput of the sharded-ensemble segment.

    Measures parallel.ensemble._batched_segment — the (exp, chain)
    batch of scan steppers — on a 1-device {exp, chain} mesh with
    nexp x nchain chains, the per-device workload of
    run_sharded_ensemble.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from sxmc_jax.mcmc import metropolis
    from sxmc_jax.parallel import ensemble as par_ensemble
    from sxmc_jax.signal import Observable, Signal, Source, Systematic
    from sxmc_jax.mcmc.metropolis import MCMC

    rng = np.random.default_rng(5)
    obs = Observable(name="energy", field="energy", bins=100, lower=5.0,
                     upper=15.0, field_index=0)
    syst = Systematic(name="shift", type=0, observable_field="energy",
                      means=[0.0], sigmas=[0.05],
                      observable_field_index=0, pidx=[0])
    sample_fields = ["energy", "DATASET"]
    sig_mc = rng.normal(10, 1, (n_mc, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (n_mc, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "s", sig_mc, ["energy"], 0, src_s,
                            1000.0, sample_fields, [obs], [], [syst])
    bkg = Signal.from_table("bkg", "b", bkg_mc, ["energy"], 0, src_b,
                            2000.0, sample_fields, [obs], [], [])
    mcmc = MCMC([src_s, src_b], [sig, bkg], [syst], [obs])

    datasets = [
        np.stack([rng.uniform(5, 15, nevents - 7 * e).astype(np.float32),
                  np.zeros(nevents - 7 * e, np.float32)], axis=1)
        for e in range(nexp)]
    rb = mcmc.stack.compute_read_bins(
        par_ensemble.pad_datasets(datasets))
    dd = mcmc.stack.device_data
    npar = mcmc.nparameters
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                axis_names=("exp", "chain"))

    p0, nll0, w0 = metropolis.initial_state(mcmc, rb[0], dd)
    params = jnp.broadcast_to(p0, (nexp, nchain, npar))
    hi0 = jnp.broadcast_to(nll0[0], (nexp, nchain))
    lo0 = jnp.broadcast_to(nll0[1], (nexp, nchain))
    width = jnp.broadcast_to(w0, (nexp, nchain, npar))
    keys = par_ensemble._segment_keys(jax.random.PRNGKey(3), nexp,
                                      nchain, 0, 0)

    def seg_fn(nsteps):
        def f(params, hi, lo, width, keys, rb, *dd):
            with mesh:
                _, nll_pair, _, _, _ = par_ensemble._batched_segment(
                    mcmc, params, (hi, lo), width, keys, rb, dd, nsteps,
                    False)
            return nll_pair[0].sum()
        return f

    n = 2500
    per_seg = _per_rep(seg_fn(n), n,
                       (params, hi0, lo0, width, keys, rb, *dd))
    rate = nexp * nchain / per_seg
    return {"metric": "sharded_ensemble_steps_per_sec",
            "value": rate, "unit": "chain-steps/s",
            "detail": f"{nexp} exp x {nchain} chains on a 1-device mesh, "
                      f"2 signals x {n_mc} MC rebuilt per step, "
                      f"{nevents} events/exp"}


def bench_binned():
    """Binned vs unbinned per-step cost at the 10^6-data-event scale.

    The binned likelihood regroups the unbinned NLL exactly by
    (dataset, bin) (ops/nll.binned_nll_pair), so the per-step event
    term is O(nbins) instead of O(nevents * nsignals).  With a
    floating systematic the MC rebuild still runs each step; the gap
    between the two metrics is the pure event-term saving.
    """
    import jax

    from sxmc_jax.mcmc import metropolis
    from sxmc_jax.signal import Observable, Signal, Source, Systematic
    from sxmc_jax.mcmc.metropolis import MCMC

    rng = np.random.default_rng(6)
    obs = Observable(name="energy", field="energy", bins=100, lower=5.0,
                     upper=15.0, field_index=0)
    syst = Systematic(name="shift", type=0, observable_field="energy",
                      means=[0.0], sigmas=[0.05],
                      observable_field_index=0, pidx=[0])
    sample_fields = ["energy", "DATASET"]
    n_mc = 1_000_000
    sig_mc = rng.normal(10, 1, (n_mc, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (n_mc, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "s", sig_mc, ["energy"], 0, src_s,
                            300_000.0, sample_fields, [obs], [], [syst])
    bkg = Signal.from_table("bkg", "b", bkg_mc, ["energy"], 0, src_b,
                            700_000.0, sample_fields, [obs], [], [])

    nevents = 1_000_000
    data = np.stack([rng.uniform(5, 15, nevents).astype(np.float32),
                     np.zeros(nevents, np.float32)], axis=1)

    out = []
    for binned in (False, True):
        mcmc = MCMC([src_s, src_b], [sig, bkg], [syst], [obs],
                    binned=binned)
        mcmc.stack.set_data(data)
        rb = mcmc.stack._read_bins
        dd = mcmc.stack.device_data
        p0, nll0, w0 = metropolis.initial_state(mcmc, rb, dd)

        def seg_fn(nsteps, mcmc=mcmc):
            def f(p0, nll0, w0, rb, *dd):
                o = metropolis.run_segment(mcmc, p0, nll0, w0, rb, dd,
                                           jax.random.PRNGKey(1), nsteps)
                return o[1][0]
            return f

        n = 1000
        per_step = _per_rep(seg_fn(n), n, (p0, nll0, w0, rb, *dd))
        tag = "binned" if binned else "unbinned"
        out.append({
            "metric": f"mcmc_steps_per_sec_1M_events_{tag}",
            "value": 1.0 / per_step, "unit": "steps/s",
            "detail": f"{tag} NLL, {nevents} data events, 2 signals x "
                      f"{n_mc} MC rebuilt per step, "
                      f"{per_step*1e3:.3f} ms/step"})
    return out


def bench_scale10m(nsignals: int = 10, n_mc_each: int = 1_000_000,
                   nevents: int = 10_000_000):
    """Hardware scale proof at the BASELINE config-#5 size.

    The large multi-signal 0vbb-style fit (BASELINE.json configs[4] /
    SURVEY §6 cost model): ``nsignals`` signals with ``n_mc_each`` MC
    samples each (10M total), one floating resolution_scale systematic
    shared by every signal (so the full 10M-sample PDF stack rebuilds
    every step), and ``nevents`` = 10M data events, on a single chip.
    Two metrics:

      * ``binned_steps_per_sec_10M`` — binned likelihood (exact
        (dataset, bin) regrouping): per-step cost is the 10M-sample
        rebuild + O(nbins) event term.
      * ``mcmc_steps_per_sec_10M`` — unbinned: the event term is the
        full (nsignals x nevents) LUT gather + compensated log-sum.

    """
    import jax

    from sxmc_jax.mcmc import metropolis
    from sxmc_jax.ops import transforms
    from sxmc_jax.signal import Observable, Signal, Source, Systematic
    from sxmc_jax.mcmc.metropolis import MCMC

    rng = np.random.default_rng(10)
    obs = Observable(name="energy", field="energy", bins=100, lower=5.0,
                     upper=15.0, field_index=0)
    syst = Systematic(name="res", type=transforms.RESOLUTION_SCALE,
                      observable_field="energy",
                      truth_field="energy_true",
                      means=[0.0], sigmas=[0.05],
                      observable_field_index=0, truth_field_index=1,
                      pidx=[0])
    sample_fields = ["energy", "energy_true", "DATASET"]

    sources, signals = [], []
    for k in range(nsignals):
        if k == 0:
            truth = np.full(n_mc_each, 10.0, np.float32)  # 0vbb peak
            src = Source(name="sig0", index=0, mean=1.0)
        else:
            truth = rng.uniform(5, 15, n_mc_each).astype(np.float32)
            src = Source(name=f"bkg{k}", index=k, mean=1.0, sigma=0.1)
        energy = truth + rng.normal(0, 0.3, n_mc_each).astype(np.float32)
        table = np.stack([energy, truth], axis=1)
        sources.append(src)
        signals.append(Signal.from_table(
            src.name, src.name, table, ["energy", "energy_true"], 0,
            src, float(nevents) / nsignals, sample_fields, [obs], [],
            [syst]))

    data = np.zeros((nevents, 3), np.float32)
    data[:, 0] = rng.uniform(5, 15, nevents).astype(np.float32)

    out = []
    for binned, tag, n in (
            (True, "binned_steps_per_sec_10M", 500),
            (False, "mcmc_steps_per_sec_10M", 50)):
        mcmc = MCMC(sources, signals, [syst], [obs], binned=binned)
        mcmc.stack.set_data(data)
        rb = mcmc.stack._read_bins
        dd = mcmc.stack.device_data
        p0, nll0, w0 = metropolis.initial_state(mcmc, rb, dd)

        def seg_fn(nsteps, mcmc=mcmc):
            def f(p0, nll0, w0, rb, *dd):
                o = metropolis.run_segment(mcmc, p0, nll0, w0, rb, dd,
                                           jax.random.PRNGKey(1), nsteps)
                return o[1][0]
            return f

        per_step = _per_rep(seg_fn(n), n, (p0, nll0, w0, rb, *dd))
        out.append({
            "metric": tag, "value": 1.0 / per_step, "unit": "steps/s",
            "detail": f"{nsignals} signals x {n_mc_each} MC "
                      f"(res-scale rebuild/step), {nevents} events "
                      f"{'binned' if binned else 'unbinned'}, "
                      f"{per_step*1e3:.3f} ms/step"})
        del mcmc, rb, dd, p0, nll0, w0
    return out


def bench_mle():
    """Batched gradient-MLE toy fits/s (the Feldman-Cousins inner loop).

    Each "fit" is a full BFGS solve of the 2-rate extended-ML problem
    on its own toy dataset; a batch of toys is one vmapped device call
    (sxmc_jax.stats.mle / stats.feldman_cousins).
    """
    import jax
    import jax.numpy as jnp

    from sxmc_jax.generator import make_fake_dataset_batch
    from sxmc_jax.ops.nll import nll as nll_fn
    from sxmc_jax.signal import Observable, Signal, Source
    from sxmc_jax.stats.mle import MLE, _bfgs

    rng = np.random.default_rng(5)
    obs = Observable(name="energy", field="energy", bins=100, lower=5.0,
                     upper=15.0, field_index=0)
    sample_fields = ["energy", "DATASET"]
    sig_mc = rng.normal(10, 1, (200_000, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (200_000, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "s", sig_mc, ["energy"], 0, src_s,
                            1000.0, sample_fields, [obs], [], [])
    bkg = Signal.from_table("bkg", "b", bkg_mc, ["energy"], 0, src_b,
                            2000.0, sample_fields, [obs], [], [])
    mle = MLE([src_s, src_b], [sig, bkg], [], [obs])

    ntoys = 256
    batch = make_fake_dataset_batch(
        jax.random.PRNGKey(2), [sig, bkg], [], [obs], ntoys)
    rb = jnp.asarray(np.asarray(mle.stack.compute_read_bins(batch)))
    dd = mle.stack.device_data
    theta = jnp.zeros(0, jnp.float32)
    x0 = jnp.zeros(2, jnp.float32)  # log-rates at the truth

    def reps_fn(nreps):
        @jax.jit
        def f(rb, *dd):
            def one(rb1, jit_x0):
                lut, norms = mle.stack.evaluate(theta, rb1, dd)

                def fun(qf):
                    pars = jnp.exp(jnp.clip(qf, -30.0, 30.0))
                    return nll_fn(pars, lut, norms, mle.static)

                _, fmin, _ = _bfgs(fun, jit_x0, 100)
                return fmin

            def body(i, acc):
                xi = x0 + 1e-6 * i
                return acc + jax.vmap(one, in_axes=(0, None))(rb, xi).sum()

            return jax.lax.fori_loop(0, nreps, body, jnp.float32(0))
        return f

    n = 10
    per_rep = _per_rep(reps_fn(n), n, (rb, *dd))
    return {"metric": "mle_toy_fits_per_sec",
            "value": ntoys / per_rep, "unit": "fits/s",
            "detail": f"batched BFGS, {ntoys} toys/batch, ~3000 events "
                      f"each, {per_rep*1e3:.2f} ms/batch"}


def suite():
    """Full benchmark suite; extra metrics -> BENCH_extra.json."""
    device = _device()
    extras = [bench_group()] + bench_mcmc() \
        + [bench_sharded_ensemble()] + bench_binned() \
        + bench_scale10m() + [bench_mle()]
    for m in extras:
        m["device"] = device
    with open("BENCH_extra.json", "w") as f:
        json.dump(extras, f, indent=2)
    for m in extras:
        print(f"# {m['metric']}: {m['value']:.6g} {m['unit']} "
              f"({m.get('detail', '')})", file=sys.stderr)


if __name__ == "__main__":
    from sxmc_jax.utils import configure_compile_cache

    configure_compile_cache()
    if "--suite" in sys.argv:
        suite()
    main()
