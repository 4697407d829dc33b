"""Ensemble runner: fake experiments -> fits -> limits.

Re-implements reference src/sxmc.cpp:44-148 (``ensemble``): for each
experiment, generate (or load) a dataset, run the MCMC, extract the best
fit and the upper limit on the signal of interest, persist the
likelihood space, and report the median limit.

Beyond the reference: per-experiment results are checkpointed, so a
killed ensemble resumes where it left off (``resume=True``), and
experiments can be fanned out over hosts (see sxmc_jax.parallel).
"""

from __future__ import annotations

import os
import traceback
from typing import List, Optional

import jax
import numpy as np

from sxmc_jax.fitconfig import FitConfig
from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.stats.likelihood import LikelihoodSpace
from sxmc_jax.utils import median


def run_ensemble(
    fc: FitConfig,
    output_path: str,
    resume: bool = False,
    verbose: bool = True,
    sampler: str = "metropolis",
    hypotest_toys: int = 0,
    hypotest_band: bool = False,
    hypotest_asymptotic: bool = False,
    checkpoint_steps: int = 0,
    max_retries: int = 1,
    gof_toys: int = -1,
    bias_toys: int = 0,
) -> List[float]:
    """Run the full ensemble; returns the per-experiment upper limits.

    ``gof_toys >= 0`` (the ``--gof`` CLI flag) adds a saturated-chi2
    goodness-of-fit check at each experiment's best fit (asymptotic
    p-value; plus an exact posterior-predictive p-value from that many
    simulated toys when > 0) — see sxmc_jax.stats.gof.

    ``hypotest_toys > 0`` additionally runs the frequentist hypothesis
    tests (q0 discovery significance + CLs upper limit, and the expected
    "Brazil band" when ``hypotest_band``) on the configured
    ``signal_name`` for every experiment — machinery the reference
    lacks entirely (its nearest analog is the median-limit loop,
    sxmc.cpp:110-127).  ``hypotest_asymptotic`` adds (or, with no toys,
    replaces them by) the Asimov-based asymptotic CLs limit and
    expected band — deterministic, no toy ensembles
    (stats.hypotest.asymptotic_upper_limit).

    ``checkpoint_steps > 0`` runs each Metropolis chain in segments of
    that many steps with the full chain state persisted after each —
    a killed fit resumes mid-chain (sxmc_jax.checkpoint; the reference
    can only resume whole experiments, sxmc.cpp:84-94).

    Structured JSONL metrics (step timing, acceptance, ESS, best fit)
    go to ``<output_path>/<prefix>_metrics.jsonl`` — the analog of the
    reference's per-batch acceptance prints (mcmc.cpp:356-358).

    Failure detection/recovery (SURVEY.md section 5; the reference
    aborts the whole ensemble on any error): each experiment runs
    behind a fault barrier — a failure is logged to the metrics stream
    (with traceback), retried up to ``max_retries`` times under a fresh
    key (so a pathologically-drawn toy is redrawn), and a permanently
    failing experiment is recorded and SKIPPED so the remaining
    ensemble still completes and reports its median limit.
    """
    from sxmc_jax.observability import MetricsLogger, Stopwatch

    os.makedirs(output_path, exist_ok=True)
    metrics = MetricsLogger(os.path.join(
        output_path, f"{fc.output_prefix}_metrics.jsonl"))
    metrics.log("ensemble_start", nexperiments=fc.nexperiments,
                nsteps=fc.nsteps, sampler=sampler, nchains=fc.nchains)

    def log(msg):
        if verbose:
            print(msg)

    # One sampler (and one batched PDF stack) is reused for every
    # experiment, the PDF export, and fake-data generation — per-signal
    # kernel builds would pay one compile per distinct MC size.
    mcmc: Optional[MCMC] = None
    if not fc.samples:
        if sampler == "hmc":
            from sxmc_jax.mcmc.hmc import HMC

            mcmc = HMC(fc.sources, fc.signals, fc.systematics,
                       fc.observables, binned=fc.binned)
        elif sampler == "nuts":
            from sxmc_jax.mcmc.nuts import NUTS

            mcmc = NUTS(fc.sources, fc.signals, fc.systematics,
                        fc.observables, binned=fc.binned)
        elif sampler == "stretch":
            from sxmc_jax.mcmc.stretch import StretchSampler

            mcmc = StretchSampler(fc.sources, fc.signals,
                                  fc.systematics, fc.observables,
                                  binned=fc.binned)
        elif sampler == "tempered":
            from sxmc_jax.mcmc.tempered import TemperedMCMC

            mcmc = TemperedMCMC(fc.sources, fc.signals, fc.systematics,
                                fc.observables, binned=fc.binned)
        elif sampler == "mle":
            from sxmc_jax.stats.mle import MLE

            mcmc = MLE(fc.sources, fc.signals, fc.systematics,
                       fc.observables, binned=fc.binned)
        else:
            mcmc = MCMC(fc.sources, fc.signals, fc.systematics,
                        fc.observables, binned=fc.binned)

    # Export nominal PDFs (sxmc.cpp:45-55) from the batched stack.
    if fc.plots and not fc.samples:
        from sxmc_jax.signal import nominal_params

        hists, norms = mcmc.stack.histograms(
            nominal_params(fc.systematics))
        hists = np.asarray(hists)
        norms = np.asarray(norms)
        for i, sig in enumerate(fc.signals):
            dens = hists[i].reshape(mcmc.stack.nbins) / max(
                float(norms[i]) * mcmc.stack.bin_volume, 1e-30)
            np.save(os.path.join(output_path, f"{sig.name}_pdf.npy"), dens)

    ht = None
    want_hypotest = hypotest_toys > 0 or hypotest_asymptotic
    if want_hypotest and fc.signal_name:
        from sxmc_jax.stats.hypotest import HypoTest
        from sxmc_jax.stats.mle import MLE

        est = mcmc if isinstance(mcmc, MLE) else MLE(
            fc.sources, fc.signals, fc.systematics, fc.observables)
        try:
            ht = HypoTest(est, fc.signal_name)
        except ValueError as e:
            log(f"ensemble: hypotest disabled: {e}")
    elif want_hypotest:
        log("ensemble: hypotest requires fit.signal_name")

    if bias_toys > 0 and not fc.samples:
        # Pre-fit validation: pull/bias study of the free rates over a
        # batched toy ensemble (stats.bias) — run once per ensemble.
        import json

        from sxmc_jax.stats.bias import pull_study
        from sxmc_jax.stats.mle import MLE

        est_b = (ht.mle if ht is not None else
                 mcmc if isinstance(mcmc, MLE) else
                 MLE(fc.sources, fc.signals, fc.systematics,
                     fc.observables))
        ps = pull_study(est_b, bias_toys,
                        jax.random.PRNGKey(fc.seed + 0x5A5A),
                        cl=fc.confidence)
        log(str(ps))
        summary = ps.summary()
        metrics.log("pull_study", ntoys=bias_toys, cl=fc.confidence,
                    summary=summary)
        with open(os.path.join(
                output_path, f"{fc.output_prefix}_pulls.json"),
                "w") as f:
            json.dump({"ntoys": bias_toys, "cl": fc.confidence,
                       "summary": summary}, f, indent=1)
        if fc.plots:
            try:
                from sxmc_jax.plots import plot_pulls

                plot_pulls(ps, os.path.join(
                    output_path, f"{fc.output_prefix}_pulls.png"))
            except Exception as e:  # plotting must never kill the fit
                log(f"bias study: plotting failed: {e}")

    key = jax.random.PRNGKey(fc.seed)
    limits: List[float] = []
    failures: List[dict] = []

    def _run_experiment(i: int, exp_key) -> None:
        """One experiment: data -> fit -> diagnostics -> limit."""
        lspace_file = os.path.join(
            output_path, f"{fc.output_prefix}_{i}.{fc.output_format}")


        if resume and os.path.exists(lspace_file):
            log(f"ensemble: Resuming from {lspace_file}")
            ls = LikelihoodSpace.load(lspace_file, fc.confidence,
                                      fc.error_type)
            samples_data = None
        elif fc.samples:
            # Recompute intervals from stored MCMC samples
            # (sxmc.cpp:84-94).
            log(f"ensemble: Loading samples from {fc.samples}")
            ls = LikelihoodSpace.load(fc.samples, fc.confidence,
                                      fc.error_type)
            samples_data = None
        else:
            # Make fake data or load a real dataset (sxmc.cpp:63-79).
            if not fc.data:
                log(f"ensemble: Sampling fake dataset {i}")
                samples_data = make_fake_dataset(
                    exp_key, fc.signals, fc.systematics, fc.observables,
                    poisson=True, verbose=verbose,
                    stack=mcmc.stack if mcmc else None)
            else:
                chunks = []
                for dataset, sigs in fc.data.items():
                    sig = sigs[i] if i < len(sigs) else sigs[0]
                    log(f"ensemble: Loading dataset {dataset}.{i} "
                        f"({sig.filename})")
                    chunks.append(sig.histogram.get_samples())
                samples_data = np.concatenate(chunks, axis=0)

            if ht is not None:
                _run_hypotest(ht, fc, samples_data, output_path, i,
                              hypotest_toys, hypotest_band,
                              jax.random.fold_in(exp_key, 7), log,
                              asymptotic=hypotest_asymptotic)

            if sampler == "mle":
                limit = _run_mle_experiment(
                    mcmc, fc, samples_data, output_path, i, log,
                    gof_toys=gof_toys, metrics=metrics,
                    gof_key=jax.random.fold_in(exp_key, 11))
                if limit is not None:
                    limits.append(limit)
                return

            sw = Stopwatch()
            if checkpoint_steps > 0 and sampler in (
                    "metropolis", "hmc", "nuts", "stretch", "tempered"):
                from sxmc_jax import checkpoint as ckpt_mod

                ckpt = os.path.join(
                    output_path, f"{fc.output_prefix}_chain_{i}.ckpt.npz")
                if sampler in ("hmc", "nuts"):
                    # run_checkpointed_hmc dispatches on the sampler
                    # type (HMC vs NUTS) internally.
                    ls = ckpt_mod.run_checkpointed_hmc(
                        mcmc, samples_data, fc.nsteps,
                        fc.burnin_fraction,
                        segment_steps=checkpoint_steps,
                        checkpoint_path=ckpt, seed=fc.seed + i,
                        verbose=verbose)
                elif sampler == "stretch":
                    ls = ckpt_mod.run_checkpointed_stretch(
                        mcmc, samples_data, fc.nsteps,
                        fc.burnin_fraction,
                        segment_steps=checkpoint_steps,
                        checkpoint_path=ckpt, debug_mode=fc.debug_mode,
                        seed=fc.seed + i, verbose=verbose)
                elif sampler == "tempered":
                    ls = ckpt_mod.run_checkpointed_tempered(
                        mcmc, samples_data, fc.nsteps,
                        fc.burnin_fraction,
                        segment_steps=checkpoint_steps,
                        checkpoint_path=ckpt, debug_mode=fc.debug_mode,
                        seed=fc.seed + i, verbose=verbose)
                else:
                    ls = ckpt_mod.run_checkpointed(
                        mcmc, samples_data, fc.nsteps,
                        fc.burnin_fraction,
                        segment_steps=checkpoint_steps,
                        checkpoint_path=ckpt, debug_mode=fc.debug_mode,
                        seed=fc.seed + i, verbose=verbose,
                        rate_substeps=fc.rate_substeps,
                        proposal=getattr(fc, "proposal", "diagonal"))
                if os.path.exists(ckpt):
                    os.remove(ckpt)  # completed; resume file not needed
            else:
                extra = ({"rate_substeps": fc.rate_substeps,
                          "proposal": getattr(fc, "proposal",
                                              "diagonal")}
                         if sampler == "metropolis" else {})
                ls = mcmc(samples_data, fc.nsteps, fc.burnin_fraction,
                          debug_mode=fc.debug_mode, key=exp_key,
                          nchains=fc.nchains, **extra)
            elapsed = sw.real_time()
            ls.cl = fc.confidence
            ls.error_type = fc.error_type
            ls.save(lspace_file)
            metrics.log(
                "experiment_fit", experiment=i, sampler=sampler,
                nsteps=fc.nsteps, nchains=fc.nchains,
                wall_seconds=elapsed,
                steps_per_sec=fc.nsteps * max(fc.nchains, 1) / max(
                    elapsed, 1e-9),
                accept_rate=getattr(mcmc, "last_accept_rate", None))

        log(ls.print_best_fit())
        log(ls.print_correlations())

        # Convergence diagnostics (absent from the reference).
        from sxmc_jax.stats.diagnostics import summarize

        # The tempered sampler returns ONE cold chain regardless of
        # fc.nchains; splitting it into pseudo-chains would corrupt
        # R-hat/ESS.
        diag_nchains = 1 if sampler == "tempered" else max(fc.nchains, 1)
        diag = summarize(ls.samples, [n for n in ls.names],
                         nchains=diag_nchains)
        log("-- Diagnostics --")
        for pname, d in diag.items():
            log(f" {pname}: ESS={d['ess']:.0f} R-hat={d['rhat']:.3f}")
        metrics.log(
            "experiment_result", experiment=i, nll_min=ls.nll_min,
            best_fit={n: iv.point_estimate
                      for n, iv in ls.get_best_fit().items()},
            ess={n: d["ess"] for n, d in diag.items()},
            rhat={n: d["rhat"] for n, d in diag.items()})

        if gof_toys >= 0 and samples_data is not None \
                and getattr(mcmc, "parameter_names", None):
            from sxmc_jax.stats.gof import goodness_of_fit

            bf = ls.get_best_fit()
            best_params = np.asarray(
                [bf[n].point_estimate for n in mcmc.parameter_names],
                np.float32)
            gof = goodness_of_fit(
                fc.sources, fc.signals, fc.systematics, fc.observables,
                samples_data, best_params, ntoys=max(gof_toys, 0),
                key=jax.random.fold_in(exp_key, 11), stack=mcmc.stack,
                refit=True)
            log(f"-- Goodness of fit --\n {gof}")
            metrics.log("experiment_gof", experiment=i, chi2=gof.chi2,
                        ndof=gof.ndof, p_asymptotic=gof.p_asymptotic,
                        p_toys=gof.p_toys)

        if fc.plots and samples_data is not None:
            try:
                from sxmc_jax import plots

                plots.plot_fit(ls.get_best_fit(), fc, samples_data,
                               output_path, suffix=f"_{i}",
                               formats=fc.plot_formats)
            except Exception as e:  # plotting must never kill the fit
                log(f"ensemble: plotting failed: {e}")

        # Collect the upper limit on the signal of interest
        # (sxmc.cpp:110-127).
        best_fit = ls.get_best_fit()
        if fc.signal_name and fc.signal_name in best_fit:
            bfi = best_fit[fc.signal_name]
            log(f"ensemble: Signal {fc.signal_name}: {bfi}")
            if not bfi.one_sided:
                log("ensemble: Warning: Two-sided limit!")
            log(f"ensemble: lower = {bfi.lower}, upper = {bfi.upper}, "
                f"coverage = {bfi.coverage}")
            limits.append(bfi.upper)
            metrics.log("experiment_limit", experiment=i,
                        signal=fc.signal_name, upper=bfi.upper,
                        lower=bfi.lower, one_sided=bool(bfi.one_sided))

    for i in range(fc.nexperiments):
        log(f"Experiment {i + 1} / {fc.nexperiments}")
        for attempt in range(max(max_retries, 0) + 1):
            # Attempt 0 uses the canonical per-experiment key;
            # retries rekey so a pathologically-drawn toy dataset
            # (or a transient backend failure) gets a fresh draw.
            exp_key = jax.random.fold_in(key, i) if attempt == 0 \
                else jax.random.fold_in(
                    jax.random.fold_in(key, 1_000_003 + attempt), i)
            try:
                _run_experiment(i, exp_key)
                break
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — fault barrier
                tb = traceback.format_exc(limit=8)
                metrics.log(
                    "experiment_failed", experiment=i,
                    attempt=attempt,
                    error=f"{type(e).__name__}: {e}", traceback=tb)
                if attempt >= max(max_retries, 0):
                    log(f"ensemble: experiment {i} FAILED after "
                        f"{attempt + 1} attempt(s): {e}")
                    failures.append(
                        {"experiment": i,
                         "error": f"{type(e).__name__}: {e}"})
                else:
                    log(f"ensemble: experiment {i} attempt "
                        f"{attempt} failed ({e}); retrying")

    if failures:
        log(f"ensemble: {len(failures)} experiment(s) failed "
            f"permanently: {[f['experiment'] for f in failures]}")
    metrics.log("ensemble_done", nlimits=len(limits),
                median_limit=float(median(limits)) if limits else -1.0,
                nfailed=len(failures), failures=failures)
    return limits


def _run_hypotest(ht, fc: FitConfig, data, output_path: str, index: int,
                  ntoys: int, band: bool, key, log,
                  asymptotic: bool = False) -> None:
    """Discovery significance + CLs limit for the signal of interest.

    The CLs scan grid is auto-sized from the profile-likelihood upper
    limit (grid = [hi/8 .. 2x the profile limit]), so no user tuning is
    needed; results go to ``{prefix}_hypotest_{i}.json``.
    ``asymptotic`` adds the Asimov-based CLs limit + expected band
    (deterministic; the only path when ``ntoys == 0``).
    """
    import json

    cl = max(fc.confidence, 0.9)
    k_disc, k_cls, k_band = jax.random.split(key, 3)

    disc = ht.discovery(data, ntoys=ntoys, key=k_disc)
    log(f"hypotest: Discovery {fc.signal_name}: {disc}")

    result = ht.mle.fit(np.asarray(data, np.float32))
    lim0 = ht.mle.upper_limit(fc.signal_name, cl, result)
    hi = max(2.0 * lim0, 1e-2)
    grid = np.linspace(hi / 8.0, hi, 8)

    out = {
        "signal": fc.signal_name, "cl": cl, "ntoys": ntoys,
        "q0": disc.q0, "z_asymptotic": disc.z_asymptotic,
        "p_asymptotic": disc.p_asymptotic, "z_toys": disc.z_toys,
        "p_toys": disc.p_toys, "profile_limit": lim0,
        "r_grid": list(grid),
    }

    limit = None
    cls_vals = None
    if ntoys > 0:
        limit, grid, cls_vals = ht.cls_upper_limit(
            k_cls, data, grid, ntoys=ntoys, cl=cl)
        log(f"hypotest: CLs upper limit ({cl:.0%} CL): {limit:g} "
            f"(profile-likelihood: {lim0:g})")
        out["cls_limit"] = limit
        out["cls_values"] = list(cls_vals)
        # The refinement pass merged extra points into the grid;
        # keep r_grid aligned with cls_values.
        out["r_grid"] = list(grid)

    bd = None
    if band and ntoys > 0:
        bd = ht.cls_expected_band(k_band, grid, ntoys=ntoys, cl=cl,
                                  background_fit=result,
                                  quantiles=(0.16, 0.5, 0.84))
        log(f"hypotest: Expected limit (median [-1s, +1s]): "
            f"{bd[0.5]:g} [{bd[0.16]:g}, {bd[0.84]:g}]")
        out["expected_limit"] = {str(k): v for k, v in bd.items()}

    if asymptotic:
        asym = ht.asymptotic_upper_limit(data, grid, cl=cl)
        log(f"hypotest: Asymptotic (Asimov) {asym}")
        out["asymptotic_limit"] = asym.limit
        out["asymptotic_expected"] = {
            str(n): v for n, v in asym.expected.items()}
        out["asymptotic_cls_values"] = list(asym.cls_obs)
        if limit is None:
            limit = asym.limit
            cls_vals = asym.cls_obs
            bd = {0.16: asym.expected[-1], 0.5: asym.expected[0],
                  0.84: asym.expected[1]}
    with open(os.path.join(
            output_path,
            f"{fc.output_prefix}_hypotest_{index}.json"), "w") as f:
        json.dump(out, f, indent=1)

    if fc.plots and cls_vals is not None:
        try:
            from sxmc_jax import plots

            plots.plot_cls_scan(
                grid, cls_vals, limit, cl,
                os.path.join(output_path,
                             f"{fc.output_prefix}_cls_{index}.png"),
                signal_name=fc.signal_name, expected=bd)
        except Exception as e:  # plotting must never kill the fit
            log(f"hypotest: plotting failed: {e}")


def _run_mle_experiment(mle, fc: FitConfig, samples_data, output_path: str,
                        index: int, log, gof_toys: int = -1,
                        metrics=None, gof_key=None) -> Optional[float]:
    """One gradient-MLE experiment: fit, profile the signal, plot.

    Returns the one-sided profile-likelihood upper limit on the signal
    of interest (the quantity the ensemble medians, sxmc.cpp:110-127),
    or None when no signal_name is configured.
    """
    import json

    result = mle.fit(samples_data)
    log(str(result))

    if gof_toys >= 0:
        from sxmc_jax.stats.gof import goodness_of_fit

        best_params = np.asarray(
            [result.value(n) for n in mle.parameter_names], np.float32)
        gof = goodness_of_fit(
            fc.sources, fc.signals, fc.systematics, fc.observables,
            samples_data, best_params, ntoys=max(gof_toys, 0),
            key=gof_key, stack=mle.stack, refit=True)
        log(f"-- Goodness of fit --\n {gof}")
        if metrics is not None:
            metrics.log("experiment_gof", experiment=index,
                        chi2=gof.chi2, ndof=gof.ndof,
                        p_asymptotic=gof.p_asymptotic,
                        p_toys=gof.p_toys)

    best_fit = result.to_intervals(fc.confidence)
    limit = None
    if fc.signal_name and fc.signal_name in best_fit:
        iv = mle.profile_interval(fc.signal_name, fc.confidence, result)
        best_fit[fc.signal_name] = iv
        limit = mle.upper_limit(fc.signal_name, max(fc.confidence, 0.9),
                                result)
        log(f"ensemble: Signal {fc.signal_name}: {iv}")
        log(f"ensemble: Profile upper limit "
            f"({max(fc.confidence, 0.9):.0%} CL): {limit:g}")

    out = {
        "params": {n: result.value(n) for n in result.names},
        "errors": {n: result.error(n) for n in result.free_names},
        "nll": result.nll,
        "converged": result.converged,
        "upper_limit": limit,
    }
    with open(os.path.join(
            output_path, f"{fc.output_prefix}_mle_{index}.json"), "w") as f:
        json.dump(out, f, indent=1)

    if fc.plots:
        try:
            from sxmc_jax import plots

            plots.plot_fit(best_fit, fc, samples_data, output_path,
                           suffix=f"_{index}", formats=fc.plot_formats)
        except Exception as e:  # plotting must never kill the fit
            log(f"ensemble: plotting failed: {e}")
    return limit


def main_fit(config_file: str, output_path: str, resume: bool = False,
             data_root: Optional[str] = None,
             sampler: str = "metropolis",
             hypotest_toys: int = 0,
             hypotest_band: bool = False,
             hypotest_asymptotic: bool = False,
             checkpoint_steps: int = 0,
             max_retries: int = 1,
             rate_substeps: Optional[int] = None,
             gof_toys: int = -1,
             bias_toys: int = 0,
             binned: Optional[bool] = None) -> List[float]:
    """Full driver (reference: sxmc.cpp:181-229)."""
    print("sxmc_jax: Loading configuration...")
    print(f"sxmc_jax: Configuration: {config_file}")
    fc = FitConfig.from_json_file(config_file, data_root=data_root)
    if rate_substeps is not None:
        fc.rate_substeps = rate_substeps
    if binned is not None:
        fc.binned = binned
    print(fc.print())

    print("sxmc_jax: Running ensemble...")
    limits = run_ensemble(fc, output_path, resume=resume,
                          sampler=sampler, hypotest_toys=hypotest_toys,
                          hypotest_band=hypotest_band,
                          hypotest_asymptotic=hypotest_asymptotic,
                          checkpoint_steps=checkpoint_steps,
                          max_retries=max_retries, gof_toys=gof_toys,
                          bias_toys=bias_toys)

    if limits:
        print("sxmc_jax: Upper limits:", ", ".join(f"{x:g}" for x in limits))
        print(f"sxmc_jax: Median upper limit: {median(limits)}")
    else:
        print("sxmc_jax: Median upper limit: -1")
    return limits
