"""Bin-dimension sharding (SURVEY.md §2.2 last parallel axis).

Runs on the virtual 8-device CPU mesh: the bin-sharded build/eval must
equal the replicated PdfStack path exactly, sentinels included, and
its LUT must produce the identical NLL.
"""

import jax
import jax.numpy as jnp
import numpy as np

from sxmc_jax.parallel.bin_sharded import (
    bin_sharded_eval, bin_sharded_histograms, make_bin_mesh)
from sxmc_jax.pdf.stack import PdfStack
from sxmc_jax.signal import Observable, Signal, Source, Systematic

FIELDS = ["energy", "DATASET"]


def _fixture(nbins=37, weighted=False):
    """37 bins: deliberately NOT divisible by 8 devices (pad bins)."""
    rng = np.random.default_rng(21)
    obs = Observable(name="energy", field="energy", bins=nbins,
                     lower=0.0, upper=10.0, field_index=0)
    syst = Systematic(name="shift", type=0, observable_field="energy",
                      means=[0.0], sigmas=[0.1],
                      observable_field_index=0, pidx=[0])
    mc1 = rng.normal(5, 1.5, (4000, 1)).astype(np.float32)
    mc2 = rng.uniform(0, 10, (6000, 1)).astype(np.float32)
    s1 = Signal.from_table(
        "sig", "s", mc1, ["energy"], 0,
        Source(name="s", index=0, mean=1.0), 100.0, FIELDS, [obs], [],
        [syst])
    s2 = Signal.from_table(
        "bkg", "b", mc2, ["energy"], 0,
        Source(name="b", index=1, mean=1.0), 200.0, FIELDS, [obs], [],
        [syst])
    if weighted:
        s2.histogram.weights = rng.uniform(
            0.5, 2.0, 6000).astype(np.float32)
    stack = PdfStack([s1, s2], [obs], [syst])
    return obs, stack


def test_build_matches_replicated():
    obs, stack = _fixture()
    mesh = make_bin_mesh()
    for tv in (0.0, 0.35):
        theta = jnp.asarray([tv], jnp.float32)
        h_sh, n_sh = bin_sharded_histograms(mesh, stack, theta)
        h_ref, n_ref = stack.histograms(theta)
        assert h_sh.shape[1] % mesh.shape["bin"] == 0
        np.testing.assert_array_equal(
            np.asarray(h_sh)[:, :stack.total_nbins], np.asarray(h_ref))
        # Pad bins hold nothing.
        np.testing.assert_array_equal(
            np.asarray(h_sh)[:, stack.total_nbins:], 0.0)
        np.testing.assert_array_equal(np.asarray(n_sh),
                                      np.asarray(n_ref))


def test_weighted_build_matches():
    obs, stack = _fixture(weighted=True)
    mesh = make_bin_mesh()
    theta = jnp.asarray([0.1], jnp.float32)
    h_sh, n_sh = bin_sharded_histograms(mesh, stack, theta)
    h_ref, n_ref = stack.histograms(theta)
    np.testing.assert_allclose(
        np.asarray(h_sh)[:, :stack.total_nbins], np.asarray(h_ref),
        rtol=1e-5)
    np.testing.assert_allclose(np.asarray(n_sh), np.asarray(n_ref),
                               rtol=1e-6)


def test_eval_matches_replicated_with_sentinels():
    obs, stack = _fixture()
    mesh = make_bin_mesh()
    rng = np.random.default_rng(3)
    nev = 500
    data = np.stack([rng.uniform(-1, 11, nev).astype(np.float32),
                     np.where(rng.uniform(size=nev) < 0.1, 9.0,
                              0.0).astype(np.float32)], axis=1)
    stack.set_data(data)
    rb = stack._read_bins

    theta = jnp.asarray([0.2], jnp.float32)
    h_sh, n_sh = bin_sharded_histograms(mesh, stack, theta)
    lut_sh = bin_sharded_eval(mesh, h_sh, n_sh, rb, stack.bin_volume)
    lut_ref, _ = stack.evaluate(theta)
    np.testing.assert_allclose(np.asarray(lut_sh), np.asarray(lut_ref),
                               rtol=1e-6, equal_nan=True)
    # Sentinels really present in this dataset.
    assert np.isnan(np.asarray(lut_sh)).any()
    assert (np.asarray(lut_sh) == 0.0).any()
