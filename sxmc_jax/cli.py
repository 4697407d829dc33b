"""Command-line interface.

``python -m sxmc_jax.cli fit_configuration.json output_path``
mirrors the reference binary's usage (reference: src/sxmc.cpp:181-187),
with extra flags for resume and data-path resolution.
"""

from __future__ import annotations

import argparse
import sys

from sxmc_jax.ensemble import main_fit


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="sxmc_jax",
        description="Signal extraction with MCMC on JAX")
    parser.add_argument("config", help="fit configuration JSON file")
    parser.add_argument("output_path", help="output directory")
    parser.add_argument("--resume", action="store_true",
                        help="skip experiments with existing outputs")
    parser.add_argument("--data-root", default=None,
                        help="base directory for relative data filenames")
    parser.add_argument("--cpu", action="store_true",
                        help="force the CPU backend")
    parser.add_argument("--profile", metavar="LOGDIR", default=None,
                        help="capture a jax.profiler trace of the run "
                             "into LOGDIR (view in TensorBoard)")
    parser.add_argument("--sharded", action="store_true",
                        help="run all fake experiments as one vmapped "
                             "batch sharded over the device mesh")
    parser.add_argument("--coordinator", default=None,
                        help="multi-process: coordinator address "
                             "(host:port) for jax.distributed")
    parser.add_argument("--num-processes", type=int, default=0,
                        help="multi-process: total process count")
    parser.add_argument("--process-id", type=int, default=0,
                        help="multi-process: this process's id")
    parser.add_argument("--sampler",
                        choices=["metropolis", "hmc", "nuts", "stretch",
                                 "tempered", "mle"],
                        default="metropolis",
                        help="MCMC sampler ('tempered' = parallel-"
                             "tempered replica exchange for multimodal "
                             "posteriors), or 'mle' for a gradient "
                             "maximum-likelihood fit with profile-"
                             "likelihood intervals")
    parser.add_argument("--hypotest", metavar="NTOYS", nargs="?",
                        const=200, type=int, default=0,
                        help="also run frequentist hypothesis tests on "
                             "fit.signal_name: q0 discovery significance "
                             "and a toy-MC CLs upper limit (NTOYS toys "
                             "per grid point, default 200)")
    parser.add_argument("--rate-substeps", type=int, default=None,
                        metavar="M",
                        help="blocked Metropolis-within-Gibbs: take M "
                             "extra rate-only updates per systematic "
                             "update (each skips the PDF rebuild); "
                             "overrides fit.rate_substeps")
    parser.add_argument("--checkpoint-steps", type=int, default=0,
                        metavar="N",
                        help="run Metropolis chains in N-step segments "
                             "with the full chain state checkpointed "
                             "after each; a killed fit resumes "
                             "mid-chain with --resume")
    parser.add_argument("--max-retries", type=int, default=1,
                        metavar="N",
                        help="retry a failed experiment up to N times "
                             "under a fresh RNG key before recording it "
                             "as failed and continuing the ensemble "
                             "(default 1)")
    parser.add_argument("--gof", metavar="NTOYS", nargs="?", const=0,
                        type=int, default=-1, dest="gof_toys",
                        help="report a saturated-chi2 goodness-of-fit "
                             "at each best fit (asymptotic p-value); "
                             "with NTOYS > 0, also an exact "
                             "posterior-predictive p-value from that "
                             "many simulated toys")
    parser.add_argument("--binned", action="store_true", default=None,
                        help="use the binned likelihood (exact "
                             "regrouping of the unbinned NLL by "
                             "(dataset, bin) — same posterior, per-step "
                             "event cost O(nbins) instead of "
                             "O(nevents)); overrides fit.binned")
    parser.add_argument("--hypotest-band", action="store_true",
                        help="with --hypotest, also compute the median "
                             "and +-1 sigma expected CLs limits (the "
                             "Brazil band) from background-only toys")
    parser.add_argument("--bias-study", metavar="NTOYS", type=int,
                        default=0, dest="bias_toys",
                        help="before fitting, validate the fit with a "
                             "pull/bias study: NTOYS toy experiments "
                             "generated at the nominal rates and fit "
                             "as one vmapped batch; reports pull "
                             "mean/width and coverage per free rate "
                             "(written to {prefix}_pulls.json)")
    parser.add_argument("--hypotest-asymptotic", action="store_true",
                        help="compute the asymptotic (Asimov) CLs "
                             "upper limit and expected +-2 sigma band "
                             "for fit.signal_name — deterministic, no "
                             "toys (combine with --hypotest for the "
                             "toy-exact versions too)")
    args = parser.parse_args(argv)

    import jax

    from sxmc_jax.utils import configure_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    configure_compile_cache()

    if args.num_processes > 1:
        # Multi-process ensemble: experiments fan out over processes;
        # every process computes the same gathered limits, process 0
        # writes the outputs.
        import os

        from sxmc_jax.fitconfig import FitConfig
        from sxmc_jax.parallel import mesh as mesh_lib
        from sxmc_jax.parallel.multihost import run_multihost_ensemble
        from sxmc_jax.utils import median

        # One process per card on one host: process i drives card i (a
        # second process on a card could not allocate its memory).
        pin = {} if args.cpu else {"local_device_ids": [args.process_id]}
        mesh_lib.initialize_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id, **pin)
        fc = FitConfig.from_json_file(args.config,
                                      data_root=args.data_root)
        lspaces, limits = run_multihost_ensemble(fc)
        if jax.process_index() == 0:
            os.makedirs(args.output_path, exist_ok=True)
            for i, ls in enumerate(lspaces):
                if ls is not None:
                    ls.save(os.path.join(
                        args.output_path,
                        f"{fc.output_prefix}_{i}.{fc.output_format}"))
            print("sxmc_jax: Upper limits:",
                  ", ".join(f"{x:g}" for x in limits))
            print(f"sxmc_jax: Median upper limit: "
                  f"{median(list(limits))}")
        return 0

    if args.sharded:
        import os

        from sxmc_jax.fitconfig import FitConfig
        from sxmc_jax.parallel.ensemble import run_sharded_ensemble
        from sxmc_jax.utils import median

        fc = FitConfig.from_json_file(args.config,
                                      data_root=args.data_root)
        print(fc.print())
        os.makedirs(args.output_path, exist_ok=True)
        lspaces, limits = run_sharded_ensemble(fc)
        for i, ls in enumerate(lspaces):
            ls.save(os.path.join(
                args.output_path,
                f"{fc.output_prefix}_{i}.{fc.output_format}"))
            print(ls.print_best_fit())
        if limits:
            print(f"sxmc_jax: Median upper limit: {median(limits)}")
        return 0

    from sxmc_jax.observability import profile

    with profile(args.profile):
        main_fit(args.config, args.output_path, resume=args.resume,
                 data_root=args.data_root, sampler=args.sampler,
                 hypotest_toys=args.hypotest,
                 hypotest_band=args.hypotest_band,
                 hypotest_asymptotic=args.hypotest_asymptotic,
                 checkpoint_steps=args.checkpoint_steps,
                 max_retries=args.max_retries,
                 rate_substeps=args.rate_substeps,
                 gof_toys=args.gof_toys,
                 bias_toys=args.bias_toys,
                 binned=args.binned)
    return 0


if __name__ == "__main__":
    sys.exit(main())
