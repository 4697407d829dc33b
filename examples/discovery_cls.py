"""Discovery significance + CLs limits + expected band, end to end.

Builds a two-signal counting model (Gaussian line over a flat
background) and runs the LHC-style hypothesis tests (stats.hypotest,
arXiv:1007.1727 prescriptions):

  1. q0 discovery significance on a signal-injected dataset
     (asymptotic Z = sqrt(q0) plus a toy-exact p-value),
  2. observed CLs upper limit on a background-only dataset,
  3. median / +-1 sigma expected CLs limits (the Brazil band).

Every toy dataset is one batched draw and its fit one lane of a
vmapped BFGS batch, so a grid point's whole toy ensemble is a single
device call.

    python examples/discovery_cls.py [--cpu] [--toys N]

``--toys`` scales every toy-ensemble size (default 200; the band uses
2x that — tail quantiles need the statistics).

The same tests run inside the CLI with ``--hypotest [NTOYS]`` and
``--hypotest-band`` (see docs/CONFIG.md).
"""

import sys

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import numpy as np

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.signal import Observable, Signal, Source
from sxmc_jax.stats.hypotest import HypoTest
from sxmc_jax.stats.mle import MLE


def main():
    ntoys = 200
    if "--toys" in sys.argv:
        ntoys = int(sys.argv[sys.argv.index("--toys") + 1])

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

    ht = HypoTest(MLE([src_s, src_b], [sig, bkg], [], [obs]), "sig")

    # --- Discovery on a dataset with the signal injected.
    data_sb = make_fake_dataset(jax.random.PRNGKey(1), [sig, bkg], [],
                                [obs], poisson=True)
    disc = ht.discovery(data_sb, ntoys=ntoys,
                        key=jax.random.PRNGKey(2))
    print(f"Signal-injected dataset ({data_sb.shape[0]} events):")
    print(f"  {disc}")

    # --- CLs limit on a background-only dataset.
    n = 400
    data_b = np.stack([rng.uniform(5, 15, n).astype(np.float32),
                       np.zeros(n, np.float32)], axis=1)
    grid = np.linspace(0.05, 1.0, 9)
    limit, grid, cls_vals = ht.cls_upper_limit(
        jax.random.PRNGKey(3), data_b, grid, ntoys=ntoys, cl=0.95,
        verbose=True)
    print(f"Background-only dataset: observed CLs 95% UL = {limit:g}")

    # --- Expected (median, +-1 sigma) limits from b-only toys.
    band = ht.cls_expected_band(jax.random.PRNGKey(4), grid,
                                ntoys=2 * ntoys,
                                cl=0.95, quantiles=(0.16, 0.5, 0.84))
    print(f"Expected 95% UL: median {band[0.5]:g}, "
          f"band [{band[0.16]:g}, {band[0.84]:g}]")


if __name__ == "__main__":
    main()
