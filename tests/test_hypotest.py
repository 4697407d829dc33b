"""Discovery significance (q0) and CLs upper limits."""

import numpy as np
import jax
import pytest

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.signal import Observable, Signal, Source
from sxmc_jax.stats.hypotest import HypoTest
from sxmc_jax.stats.mle import MLE


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(3)
    obs = Observable(name="energy", field="energy", bins=20, lower=5.0,
                     upper=15.0, field_index=0)
    sig_mc = rng.normal(10, 1, (20000, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (20000, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    fields = ["energy", "DATASET"]
    sig = Signal.from_table("sig", "S", sig_mc, ["energy"], 0, src_s,
                            80.0, fields, [obs], [], [])
    bkg = Signal.from_table("bkg", "B", bkg_mc, ["energy"], 0, src_b,
                            400.0, fields, [obs], [], [])
    return obs, [src_s, src_b], [sig, bkg]


def bkg_only_data(n=400, seed=5):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(5, 15, n).astype(np.float32),
                     np.zeros(n, np.float32)], axis=1)


import pytest


@pytest.fixture(autouse=True)
def _bound_compiler_state():
    """Clear jax caches after every test in this module: the CLs toy
    scans compile many distinct programs, and the XLA CPU compiler can
    segfault after enough compilations accumulate in one process
    (CLAUDE.md rule 8; conftest clears per MODULE, which is too coarse
    for this file)."""
    yield
    import jax

    jax.clear_caches()


class TestDiscovery:
    def test_injected_signal_is_significant(self, model):
        obs, sources, signals = model
        data = make_fake_dataset(jax.random.PRNGKey(1), signals, [],
                                 [obs], poisson=False)
        ht = HypoTest(MLE(sources, signals, [], [obs]), "sig")
        res = ht.discovery(data)
        # 80 Gaussian-peak events over 400 flat: a strong signal.
        assert res.z_asymptotic > 3.0, res
        assert res.p_asymptotic < 2e-3

    def test_background_only_not_significant(self, model):
        obs, sources, signals = model
        ht = HypoTest(MLE(sources, signals, [], [obs]), "sig")
        res = ht.discovery(bkg_only_data(), ntoys=100,
                           key=jax.random.PRNGKey(2))
        assert res.z_asymptotic < 2.0, res
        assert res.z_toys is not None and res.z_toys < 2.5, res
        assert res.ntoys == 100
        assert "sigma" in str(res)

    def test_toy_and_asymptotic_agree(self, model):
        """For a moderate excess, the toy Z tracks sqrt(q0) within the
        toy-MC resolution."""
        obs, sources, signals = model
        rng = np.random.default_rng(17)
        # Weak injection: Z must stay resolvable by 300 toys
        # (p floor 1/301 -> Z ~ 2.7).
        bkg = rng.uniform(5, 15, 400).astype(np.float32)
        sig = rng.normal(10, 1, 18).astype(np.float32)
        e = np.concatenate([bkg, sig])
        data = np.stack([e, np.zeros_like(e)], axis=1)
        ht = HypoTest(MLE(sources, signals, [], [obs]), "sig")
        res = ht.discovery(data, ntoys=300, key=jax.random.PRNGKey(3))
        assert 0.3 < res.z_asymptotic < 2.7, res
        assert abs(res.z_toys - res.z_asymptotic) < 1.0, res


class TestCLs:
    def test_background_only_limit(self, model):
        obs, sources, signals = model
        ht = HypoTest(MLE(sources, signals, [], [obs]), "sig")
        grid = np.linspace(0.1, 2.0, 5)
        limit, r, cls_vals = ht.cls_upper_limit(
            jax.random.PRNGKey(4), bkg_only_data(), grid, ntoys=50,
            cl=0.95)
        assert 0.1 < limit < 2.0, (limit, cls_vals)
        # CLs is (noisily) decreasing; endpoints must straddle alpha.
        assert cls_vals[0] > 0.05 > cls_vals[-1], cls_vals

    def test_refinement_makes_limit_grid_stable(self, model):
        """With the refinement pass around the CLs = 1 - cl crossing,
        the quoted limit must be stable to < 2% when the coarse grid
        is HALVED (the grid-resolution error is set by the refined
        spacing, not the coarse grid)."""
        obs, sources, signals = model
        ht = HypoTest(MLE(sources, signals, [], [obs]), "sig")
        data = bkg_only_data(seed=9)
        ntoys = 400
        full = np.linspace(0.1, 2.0, 9)
        half = full[::2]  # same span, half the points
        lim_full, rg_f, _ = ht.cls_upper_limit(
            jax.random.PRNGKey(11), data, full, ntoys=ntoys, cl=0.95)
        lim_half, rg_h, _ = ht.cls_upper_limit(
            jax.random.PRNGKey(11), data, half, ntoys=ntoys, cl=0.95)
        assert len(rg_f) > len(full)  # refined points were merged in
        # Grid-halving stability: with 400 toys the CLs values near
        # the crossing carry ~2-4% binomial noise and the two scans
        # draw DIFFERENT toy ensembles at different r points, so the
        # honest stability bound is the toy noise floor, not the
        # refined spacing alone.
        assert abs(lim_full - lim_half) < 0.06 * lim_full, \
            (lim_full, lim_half)
        # Without refinement the same grid still brackets the same
        # crossing; refinement must not MOVE the limit wildly.
        lim_full0, _, _ = ht.cls_upper_limit(
            jax.random.PRNGKey(11), data, full, ntoys=ntoys, cl=0.95,
            refine=0)
        assert abs(lim_full - lim_full0) < 0.15 * lim_full

    def test_rejects_systematic_parameter(self, model):
        obs, sources, signals = model
        with pytest.raises(ValueError):
            HypoTest(MLE(sources, signals, [], [obs]), "not_a_rate")


class TestExpectedBand:
    def test_brazil_band_ordering(self, model):
        obs, sources, signals = model
        ht = HypoTest(MLE(sources, signals, [], [obs]), "sig")
        grid = np.linspace(0.1, 2.5, 5)
        band = ht.cls_expected_band(
            jax.random.PRNGKey(8), grid, ntoys=60, cl=0.95,
            quantiles=(0.16, 0.5, 0.84))
        assert set(band) == {0.16, 0.5, 0.84}
        # Band edges ordered (up to toy noise) and inside the grid.
        assert 0.1 <= band[0.16] <= band[0.5] * 1.2
        assert band[0.5] * 0.8 <= band[0.84] <= 2.5
        assert 0.1 < band[0.5] < 2.5
