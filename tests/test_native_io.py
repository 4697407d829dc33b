"""Tests for the native C++ columnar event store."""

import numpy as np
import pytest

from sxmc_jax.io import loaders, native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native evstore not buildable")


@pytest.fixture
def table(tmp_path):
    rng = np.random.default_rng(1)
    data = np.stack([
        rng.normal(10, 1, 1000), rng.uniform(0, 10, 1000),
        rng.uniform(5, 15, 1000)], axis=1).astype(np.float32)
    fields = ["energy", "radius", "mc_energy"]
    path = str(tmp_path / "mc.sxnt")
    native.write_sxnt(path, data, fields)
    return path, data, fields


class TestEventStore:
    def test_roundtrip(self, table):
        path, data, fields = table
        store = native.EventStore(path)
        assert store.nrows == 1000
        assert store.fields == fields
        np.testing.assert_array_equal(store.read_all(), data)
        store.close()

    def test_loaders_integration(self, table):
        path, data, fields = table
        got, names = loaders.read_float_table(path)
        assert names == fields
        np.testing.assert_array_equal(got, data)

    def test_write_via_loaders(self, tmp_path, table):
        _, data, fields = table
        p = str(tmp_path / "copy.sxnt")
        loaders.write_float_table(p, data, fields)
        got, names = loaders.read_float_table(p)
        np.testing.assert_array_equal(got, data)

    def test_select_cuts_and_mapping(self, table):
        path, data, fields = table
        store = native.EventStore(path)
        out = store.select(["energy", "mc_energy"],
                           cuts=[("radius", 0.0, 5.0)], dataset_tag=3.0)
        store.close()

        keep = (data[:, 1] >= 0.0) & (data[:, 1] <= 5.0)
        expect = data[keep][:, [0, 2]]
        assert out.shape == (keep.sum(), 3)
        np.testing.assert_array_equal(out[:, :2], expect)
        np.testing.assert_array_equal(out[:, 2], 3.0)

    def test_select_matches_python_path(self, table):
        from sxmc_jax.signal import Observable, read_dataset_to_samples

        path, data, fields = table
        cut = Observable(name="radius", field="radius", lower=2.0,
                         upper=8.0)
        py = read_dataset_to_samples(
            data, fields, 7, ["energy", "mc_energy", "DATASET"], [cut])
        store = native.EventStore(path)
        cc = store.select(["energy", "mc_energy"],
                          cuts=[("radius", 2.0, 8.0)], dataset_tag=7.0)
        store.close()
        np.testing.assert_array_equal(py, cc)

    def test_signal_from_sxnt(self, table, tmp_path):
        from sxmc_jax.signal import Observable, Signal, Source

        path, _, _ = table
        obs = Observable(name="energy", field="energy", bins=10,
                         lower=5.0, upper=15.0, field_index=0)
        sig = Signal.from_file(
            "s", "S", path, 0, Source(name="s", index=0), -1.0 / 10.0,
            ["energy", "DATASET"], [obs], [], [])
        assert sig.n_mc == 1000
        assert sig.nexpected == pytest.approx(100.0)
        assert sig.histogram.samples.shape[1] == 2

    def test_bad_file(self, tmp_path):
        p = tmp_path / "junk.sxnt"
        p.write_bytes(b"not an sxnt file at all")
        with pytest.raises(IOError):
            native.EventStore(str(p))


class TestConvertCLI:
    def test_roundtrip_npz_to_sxnt(self, tmp_path, capsys):
        from sxmc_jax.io.convert import main
        from sxmc_jax.io.loaders import read_float_table

        rng = np.random.default_rng(0)
        d1 = rng.normal(size=(50, 2)).astype(np.float32)
        d2 = rng.normal(size=(30, 2)).astype(np.float32)
        np.savez(tmp_path / "a.npz", x=d1[:, 0], y=d1[:, 1])
        np.savez(tmp_path / "b.npz", x=d2[:, 0], y=d2[:, 1])
        out = tmp_path / "merged.sxnt"
        assert main([str(tmp_path / "a.npz"), str(tmp_path / "b.npz"),
                     str(out)]) == 0
        assert "80 rows" in capsys.readouterr().out
        data, fields = read_float_table(str(out))
        assert fields == ["x", "y"]
        np.testing.assert_allclose(data, np.concatenate([d1, d2]),
                                   rtol=1e-6)

    def test_usage(self, capsys):
        from sxmc_jax.io.convert import main

        assert main([]) == 2
        assert main(["--help"]) == 0
        assert "convert" in capsys.readouterr().out
