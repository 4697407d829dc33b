"""Gradient MLE + profile likelihood + Feldman-Cousins, end to end.

Builds a two-signal counting model (Gaussian line over a flat
background), fits it three ways, and prints the comparison:

  1. gradient MLE with Hessian errors (stats.mle),
  2. MINOS-style profile-likelihood interval,
  3. Feldman-Cousins unified interval from a toy-MC belt
     (every toy fit is part of one vmapped BFGS batch).

    python examples/fc_limit.py [--cpu]
"""

import sys

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import numpy as np

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.signal import Observable, Signal, Source
from sxmc_jax.stats.feldman_cousins import FeldmanCousins
from sxmc_jax.stats.mle import MLE


def main():
    rng = np.random.default_rng(42)
    obs = Observable(name="energy", field="energy", bins=25, lower=5.0,
                     upper=15.0, field_index=0)
    fields = ["energy", "DATASET"]
    sig_mc = rng.normal(10, 1, (50000, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (50000, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "Signal", sig_mc, ["energy"], 0,
                            src_s, 80.0, fields, [obs], [], [])
    bkg = Signal.from_table("bkg", "Background", bkg_mc, ["energy"], 0,
                            src_b, 400.0, fields, [obs], [], [])

    data = make_fake_dataset(jax.random.PRNGKey(1), [sig, bkg], [],
                             [obs], poisson=True)
    print(f"Dataset: {data.shape[0]} events")

    mle = MLE([src_s, src_b], [sig, bkg], [], [obs])
    result = mle.fit(data)
    print(result)

    iv = mle.profile_interval("sig", cl=0.9, result=result)
    print(f"Profile (MINOS) 90% interval: {iv}")
    ul = mle.upper_limit("sig", cl=0.9, result=result)
    print(f"Profile 90% upper limit:      {ul:g}")

    fc = FeldmanCousins(mle, "sig")
    grid = np.linspace(0.0, 2.5, 11)
    fc_iv = fc.run(jax.random.PRNGKey(2), data, grid, ntoys=200, cl=0.9,
                   verbose=True)
    print(f"Feldman-Cousins 90% interval: {fc_iv}")


if __name__ == "__main__":
    main()
