"""Asimov sensitivity: expected significance + limits without toys.

The same model as examples/discovery_cls.py, but every "expected"
quantity comes from ONE deterministic fit of the Asimov dataset
(stats.asimov; arXiv:1007.1727) instead of a toy ensemble:

  1. median expected discovery significance vs signal rate,
  2. the observed asymptotic CLs limit on a background-only dataset,
  3. the full +-2 sigma expected-limit (Brazil) band,
  4. a cross-check of the asymptotic limit against the toy-exact one.

Because this framework's PDFs are histograms, the Asimov dataset is
EXACT (one weighted event per bin), so the asymptotic formulas converge
to the toy answers as statistics grow — the cross-check below shows the
agreement at ~400 events.

    python examples/asimov_sensitivity.py [--cpu] [--toys N]

The same machinery runs inside the CLI with ``--hypotest-asymptotic``
(see docs/CONFIG.md).
"""

import sys

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import numpy as np

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

    # --- 1. Median expected discovery significance vs rate (no toys).
    print("Expected discovery significance (Asimov):")
    for rate in (0.25, 0.5, 1.0):
        z = ht.asymptotic_significance(rate)
        print(f"  rate {rate:4.2f} (~{80 * rate:.0f} signal events): "
              f"Z_med = {z.z_asymptotic:.2f} sigma")

    # --- 2+3. Asymptotic CLs limit + expected band on b-only data.
    n = 400
    data_b = np.stack([rng.uniform(5, 15, n).astype(np.float32),
                       np.zeros(n, np.float32)], axis=1)
    grid = np.linspace(0.05, 1.0, 20)
    res = ht.asymptotic_upper_limit(data_b, grid, cl=0.95)
    print(f"\nBackground-only dataset ({n} events):")
    print(f"  {res}")

    # --- 4. Cross-check against the toy-exact CLs limit.
    toy_limit, _, _ = ht.cls_upper_limit(
        jax.random.PRNGKey(3), data_b, np.linspace(0.05, 1.0, 9),
        ntoys=ntoys, cl=0.95)
    print(f"\nCross-check: toy-exact CLs limit ({ntoys} toys/point) = "
          f"{toy_limit:g} vs asymptotic {res.limit:g}")


if __name__ == "__main__":
    main()
