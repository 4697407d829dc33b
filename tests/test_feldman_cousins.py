"""Feldman-Cousins unified intervals: belt shape, coverage, unification."""

import numpy as np
import jax
import pytest

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.signal import Observable, Signal, Source
from sxmc_jax.stats.feldman_cousins import FeldmanCousins
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
                            60.0, fields, [obs], [], [])
    bkg = Signal.from_table("bkg", "B", bkg_mc, ["energy"], 0, src_b,
                            300.0, fields, [obs], [], [])
    return obs, [src_s, src_b], [sig, bkg]


class TestBatchedGenerator:
    def test_matches_serial_statistics(self, model):
        from sxmc_jax.generator import make_fake_dataset_batch
        from sxmc_jax.pdf.stack import PdfStack

        obs, sources, signals = model
        stack = PdfStack(signals, [obs], [])
        batch = make_fake_dataset_batch(
            jax.random.PRNGKey(3), signals, [], [obs], ntoys=200,
            stack=stack, rates={"sig": 2.0})
        assert batch.ndim == 3 and batch.shape[0] == 200
        tags = batch[..., 1]
        nsig = (tags == 0).sum(axis=1)  # both signals share dataset 0
        # Expected 2*60 + 300 = 420 events/toy, Poisson-fluctuated.
        assert abs(nsig.mean() - 420) < 3 * np.sqrt(420 / 200) * 2
        assert 300 < nsig.var() < 560  # Poisson: var ~ mean
        # Padding is tagged -1 and events are inside the domain.
        valid = tags >= 0
        assert ((batch[..., 0] >= 5.0) & (batch[..., 0] < 15.0))[valid].all()

    def test_nonpoisson_counts_fixed(self, model):
        from sxmc_jax.generator import make_fake_dataset_batch

        obs, sources, signals = model
        batch = make_fake_dataset_batch(
            jax.random.PRNGKey(3), signals, [], [obs], ntoys=8,
            poisson=False)
        counts = (batch[..., 1] >= 0).sum(axis=1)
        assert (counts == counts[0]).all()


class TestBelt:
    def test_belt_and_interval(self, model):
        obs, sources, signals = model
        mle = MLE(sources, signals, [], [obs])
        fc = FeldmanCousins(mle, "sig")
        grid = np.linspace(0.0, 3.0, 7)
        data = make_fake_dataset(jax.random.PRNGKey(1), signals, [],
                                 [obs], poisson=False)
        iv = fc.run(jax.random.PRNGKey(2), data, grid, ntoys=60, cl=0.9)
        belt = fc.last_belt
        # Critical values near the chi2 asymptotic (0.5*2.71=1.35), very
        # loosely — small-sample + boundary effects move them around.
        assert np.all(belt.crit > 0.2) and np.all(belt.crit < 4.0), belt.crit
        assert belt.dnll_toys.shape == (7, 60)
        # Truth (r=1) inside the 90% interval for nominal data.
        assert iv.lower <= 1.0 <= iv.upper, iv
        assert 0.0 <= iv.lower < iv.upper <= 3.0

    def test_zero_signal_unifies_to_upper_limit(self, model):
        obs, sources, signals = model
        rng = np.random.default_rng(5)
        # Background-only data.
        n = 300
        data = np.stack([
            rng.uniform(5, 15, n).astype(np.float32),
            np.zeros(n, np.float32)], axis=1)
        mle = MLE(sources, signals, [], [obs])
        fc = FeldmanCousins(mle, "sig")
        grid = np.linspace(0.0, 2.0, 9)
        iv = fc.run(jax.random.PRNGKey(7), data, grid, ntoys=60, cl=0.9)
        # Interval includes 0 -> reported one-sided (the FC unification).
        assert iv.one_sided, iv
        assert iv.lower == 0.0
        assert 0.0 < iv.upper < 1.5, iv

    def test_rejects_systematic_parameter(self, model):
        obs, sources, signals = model
        mle = MLE(sources, signals, [], [obs])
        with pytest.raises(ValueError):
            FeldmanCousins(mle, "nonexistent")


class TestCoverage:
    @pytest.mark.slow
    def test_belt_coverage_at_truth(self, model):
        """Toys generated at r_true land inside the belt ~cl of the time
        by construction; check on an independent toy set."""
        obs, sources, signals = model
        mle = MLE(sources, signals, [], [obs])
        fc = FeldmanCousins(mle, "sig")
        grid = np.array([1.0], np.float32)
        belt = fc.build_belt(jax.random.PRNGKey(11), grid, ntoys=150,
                             cl=0.9)
        belt2 = fc.build_belt(jax.random.PRNGKey(12), grid, ntoys=150,
                              cl=0.9)
        frac = float(np.mean(belt2.dnll_toys[0] <= belt.crit[0]))
        assert 0.8 < frac <= 1.0, frac
