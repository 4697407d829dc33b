"""Golden end-to-end regression fixture (seeded mini-ensemble).

A COMMITTED config + MC tables (tests/data/golden/) run through the
full driver stack — config parse, PDF build, fake-data generation,
Metropolis walk, interval estimation, median limit — and every summary
number is asserted against frozen values.  This one test catches any
cross-layer statistical regression: a change to binning, sentinel
semantics, NLL terms, proposal RNG derivation, or interval math moves
these numbers far outside the tolerances.

The frozen values were recorded on the CPU backend (the suite's
pinned backend, tests/conftest.py).  Tolerances are ~1e-3 relative —
wide enough for cross-version fp drift (FMA contraction, reduction
order), far tighter than any statistical change.  If you CHANGE
semantics deliberately (e.g. a different RNG stream), re-record and
say so in the commit message.
"""

import os

import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "data", "golden")

# Frozen 2026-08-20 (jax CPU backend).
FROZEN_LIMITS = [1.0225945711135864, 1.0653597116470337]
FROZEN_BEST = {
    # name: (point_estimate, lower, upper)
    "signal1": (0.9221986532211304, 0.8210943937301636,
                1.0225945711135864),
    "signal2": (0.9921176433563232, 0.9413881301879883,
                1.0305536985397339),
    "energy_scale_0": (-0.004130491986870766, -0.009637633338570595,
                       0.009119960479438305),
}
FROZEN_NLL_MIN = -1712.2490234375


@pytest.fixture(scope="module")
def golden_run(tmp_path_factory):
    from sxmc_jax.ensemble import run_ensemble
    from sxmc_jax.fitconfig import FitConfig

    fc = FitConfig.from_json_file(os.path.join(GOLDEN, "config.json"),
                                  data_root=GOLDEN)
    out = str(tmp_path_factory.mktemp("golden_out"))
    limits = run_ensemble(fc, out, verbose=False)
    return limits, out


class TestGoldenEnsemble:
    def test_limits(self, golden_run):
        limits, _ = golden_run
        np.testing.assert_allclose(limits, FROZEN_LIMITS, rtol=2e-3)
        # Median limit over the 2-experiment ensemble.
        assert np.median(limits) == pytest.approx(
            np.median(FROZEN_LIMITS), rel=2e-3)

    def test_best_fit_and_intervals(self, golden_run):
        from sxmc_jax.stats.likelihood import LikelihoodSpace

        _, out = golden_run
        ls = LikelihoodSpace.load(os.path.join(out, "golden_0.npz"))
        bf = ls.get_best_fit()
        assert set(bf) == set(FROZEN_BEST)
        for name, (pt, lo, up) in FROZEN_BEST.items():
            iv = bf[name]
            scale = max(abs(pt), 0.02)
            assert abs(iv.point_estimate - pt) < 2e-3 * scale, \
                (name, iv.point_estimate, pt)
            assert abs(iv.lower - lo) < 2e-3 * max(abs(lo), 0.02), \
                (name, iv.lower, lo)
            assert abs(iv.upper - up) < 2e-3 * max(abs(up), 0.02), \
                (name, iv.upper, up)

    def test_nll_min(self, golden_run):
        from sxmc_jax.stats.likelihood import LikelihoodSpace

        _, out = golden_run
        ls = LikelihoodSpace.load(os.path.join(out, "golden_0.npz"))
        assert ls.nll_min == pytest.approx(FROZEN_NLL_MIN, abs=0.5)
