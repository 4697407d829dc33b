"""3-D fits: the reference's dimensional ceiling, exceeded.

The reference's histogram export and sampling stop at 3-D
(pdfz.cpp:498-594, 817-922 handle TH1/2/3 only); this build is
rank-generic.  These tests pin 3-D end-to-end (the reference's max) and
4-D construction (beyond it).
"""

import numpy as np
import jax

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.ops import histogram as hist_ops
from sxmc_jax.pdf.evalhist import EvalHist
from sxmc_jax.signal import Observable, Signal, Source


def make_3d_fixture(n=40000, seed=2):
    rng = np.random.default_rng(seed)
    obs = [
        Observable(name="energy", field="energy", bins=12, lower=5.0,
                   upper=15.0, field_index=0),
        Observable(name="radius", field="radius", bins=6, lower=0.0,
                   upper=10.0, field_index=1),
        Observable(name="psd", field="psd", bins=5, lower=0.0,
                   upper=1.0, field_index=2),
    ]
    fields = ["energy", "radius", "psd", "DATASET"]
    sig_mc = np.stack([
        rng.normal(10, 1, n),
        np.clip(rng.normal(3, 2, n), 0, 9.99),
        np.clip(rng.normal(0.7, 0.1, n), 0, 0.999),
    ], axis=1).astype(np.float32)
    bkg_mc = np.stack([
        rng.uniform(5, 15, n),
        rng.uniform(0, 10, n),
        rng.uniform(0, 1, n),
    ], axis=1).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "S", sig_mc, fields[:3], 0, src_s,
                            150.0, fields, obs, [], [])
    bkg = Signal.from_table("bkg", "B", bkg_mc, fields[:3], 0, src_b,
                            400.0, fields, obs, [], [])
    return obs, [src_s, src_b], [sig, bkg]


class Test3D:
    def test_bin_layout_row_major(self):
        """Flat index = ((i0 * n1) + i1) * n2 + i2, the reference's
        row-major convention (pdfz.cpp:215-230)."""
        obs, _, signals = make_3d_fixture()
        h = signals[0].histogram
        assert h.total_nbins == 12 * 6 * 5
        assert hist_ops.bin_strides((12, 6, 5)) == (30, 5, 1)
        # One hand-placed sample lands in the right flat bin.
        s = np.array([[10.1, 4.9, 0.55]], np.float32)  # bins (6, 2, 2)
        hh = EvalHist(s, 3, 3, (5.0, 0.0, 0.0), (15.0, 10.0, 1.0),
                      (12, 6, 5))
        counts, norm = hh.histogram(np.zeros(0, np.float32))
        counts = np.asarray(counts)
        assert float(norm) == 1.0
        assert counts[(6 * 6 + 2) * 5 + 2] == 1.0
        assert counts.sum() == 1.0

    def test_3d_density_normalized(self):
        obs, _, signals = make_3d_fixture()
        dens = np.asarray(
            signals[0].histogram.density_histogram(None))
        vol = (10.0 / 12) * (10.0 / 6) * (1.0 / 5)
        assert abs(dens.sum() * vol - 1.0) < 1e-3

    def test_3d_sampling_within_bounds(self):
        obs, sources, signals = make_3d_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(7), signals, [],
                                 obs, poisson=False)
        assert data.shape[1] == 4
        assert (data[:, 0] >= 5).all() and (data[:, 0] < 15).all()
        assert (data[:, 1] >= 0).all() and (data[:, 1] < 10).all()
        assert (data[:, 2] >= 0).all() and (data[:, 2] < 1).all()

    def test_3d_fit_recovers_rates(self):
        obs, sources, signals = make_3d_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(7), signals, [],
                                 obs, poisson=False)
        mcmc = MCMC(sources, signals, [], obs)
        ls = mcmc(data, nsteps=6000, burnin_fraction=0.2, seed=3)
        bf = ls.get_best_fit()
        assert abs(bf["sig"].point_estimate - 1.0) < 0.3, bf["sig"]
        assert abs(bf["bkg"].point_estimate - 1.0) < 0.25, bf["bkg"]

    def test_4d_constructs_and_samples(self):
        """Beyond the reference's TH3 ceiling."""
        rng = np.random.default_rng(4)
        n = 5000
        mc = rng.uniform(0, 1, (n, 4)).astype(np.float32)
        h = EvalHist(mc, 4, 4, (0.0,) * 4, (1.0,) * 4, (4, 3, 5, 2))
        counts, norm = h.histogram(np.zeros(0, np.float32))
        assert float(norm) == n
        assert np.asarray(counts).shape == (4 * 3 * 5 * 2,)
        pts = np.concatenate([mc[:5], np.zeros((5, 1), np.float32)],
                             axis=1)
        dens, _ = h.eval_points(pts)
        assert np.isfinite(np.asarray(dens)).all()
