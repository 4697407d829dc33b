"""Subprocess entry point for the multi-process jax.distributed test.

Usage: python multihost_worker.py <process_id> <num_processes>
           <coordinator or "-"> <outdir>

Each process runs the multi-host ensemble driver
(sxmc_jax.parallel.multihost) on a small synthetic fit and writes its
gathered limits to ``limits_<pid>.json``.  The analog of the
reference's CPU-fallback testing (SURVEY.md section 4): the identical
code paths, on a multi-process CPU backend instead of several hosts.
"""

import json
import os
import sys
import types

import numpy as np


def make_fixture():
    """Tiny two-signal fit; fixed (non-Poisson) event counts so every
    process-count produces identically shaped datasets (padding is the
    only shape-dependent input to the chain)."""
    from sxmc_jax.signal import Observable, Signal, Source

    rng = np.random.default_rng(7)
    obs = Observable(name="energy", field="energy", bins=20, lower=5.0,
                     upper=15.0, field_index=0)
    sample_fields = ["energy", "DATASET"]
    n_mc = 20_000
    sig_mc = rng.normal(10, 1, (n_mc, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (n_mc, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "s", sig_mc, ["energy"], 0, src_s,
                            300.0, sample_fields, [obs], [], [])
    bkg = Signal.from_table("bkg", "b", bkg_mc, ["energy"], 0, src_b,
                            600.0, sample_fields, [obs], [], [])
    return types.SimpleNamespace(
        nexperiments=4, nsteps=600, burnin_fraction=0.25, seed=11,
        signals=[sig, bkg], sources=[src_s, src_b], systematics=[],
        observables=[obs], signal_name="sig", confidence=0.683,
        error_type="projection", debug_mode=False)


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    coord = sys.argv[3]
    outdir = sys.argv[4]

    import jax

    jax.config.update("jax_platforms", "cpu")

    from sxmc_jax.parallel import mesh as mesh_lib

    if nproc > 1:
        ok = mesh_lib.initialize_distributed(
            coordinator_address=coord, num_processes=nproc,
            process_id=pid)
        assert ok and jax.process_count() == nproc, \
            (jax.process_count(), nproc)
        assert mesh_lib.process_local_experiments(4) == \
            ([0, 1] if pid == 0 else [2, 3])

    from sxmc_jax.parallel.multihost import run_multihost_ensemble

    fc = make_fixture()
    lspaces, limits = run_multihost_ensemble(fc, verbose=True,
                                             poisson=False)
    n_local = sum(1 for ls in lspaces if ls is not None)
    with open(os.path.join(outdir, f"limits_{pid}.json"), "w") as f:
        json.dump({"process": pid, "nproc": jax.process_count(),
                   "n_local": n_local,
                   "limits": [float(x) for x in limits]}, f)
    print(f"worker {pid}: limits {list(limits)}")


if __name__ == "__main__":
    main()
