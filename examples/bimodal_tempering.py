"""Parallel tempering on a bimodal shift posterior.

Constructs a fit whose shift-systematic posterior has two exactly
symmetric modes at +-1 (the MC PDF is a two-peak mixture, the data a
single peak between them), then samples it with plain Metropolis and
with the parallel-tempered ladder:

    python examples/bimodal_tempering.py

Plain Metropolis gets trapped in whichever mode it falls into first;
the tempered cold chain crosses the likelihood valley through the hot
replicas and recovers both modes with their correct weights.
"""

import jax
import numpy as np

from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.mcmc.tempered import TemperedMCMC
from sxmc_jax.signal import Observable, Signal, Source, Systematic


def build():
    rng = np.random.default_rng(2)
    obs = Observable(name="energy", field="energy", bins=40, lower=5.0,
                     upper=15.0, field_index=0)
    syst = Systematic(
        name="shift", type=0, observable_field="energy",
        means=[0.0], sigmas=[2.0], observable_field_index=0, pidx=[0])
    fields = ["energy", "DATASET"]
    half = 20_000
    mc = np.concatenate([
        rng.normal(9.0, 0.3, half), rng.normal(11.0, 0.3, half)
    ]).astype(np.float32)[:, None]
    src = Source(name="sig", index=0, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "Signal", mc, ["energy"], 0, src,
                            500.0, fields, [obs], [], [syst])
    ev = rng.normal(10.0, 0.3, 500).astype(np.float32)
    data = np.stack([ev, np.zeros_like(ev)], axis=1)
    return obs, syst, src, sig, data


def main():
    obs, syst, src, sig, data = build()
    nsteps = 12_000

    plain = MCMC([src], [sig], [syst], [obs])
    ls = plain(data, nsteps=nsteps, burnin_fraction=0.15, seed=3)
    shift = np.asarray(ls.column("shift_0"))
    print(f"plain Metropolis: P(shift > 0) = {(shift > 0).mean():.3f} "
          f"(trapped in one mode)")

    temp = TemperedMCMC([src], [sig], [syst], [obs], ntemps=8,
                        tmax=64.0, swap_every=5)
    ls = temp(data, nsteps=nsteps, burnin_fraction=0.15, seed=3)
    shift = np.asarray(ls.column("shift_0"))
    pos, neg = shift[shift > 0], shift[shift < 0]
    print(f"tempered (8 replicas, Tmax=64): "
          f"P(shift > 0) = {(shift > 0).mean():.3f}, "
          f"modes at {np.median(neg):+.3f} / {np.median(pos):+.3f}, "
          f"swap rate {temp.last_swap_rate:.2f}")


if __name__ == "__main__":
    import os

    if os.environ.get("SXMC_CPU"):  # demo runs fine on any backend
        jax.config.update("jax_platforms", "cpu")
    main()
