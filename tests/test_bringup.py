"""Running on the card: compile cache, output formats, precision and
chip_smoke.py's own checks (at tiny sizes, on the CPU)."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from sxmc_jax import utils
from sxmc_jax.fitconfig import FitConfig
from sxmc_jax.ops import nll as nll_ops
from sxmc_jax.parallel import mesh as mesh_lib
from sxmc_jax.parallel import nll_sharded
from sxmc_jax.utils import ConfigError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ compile cache

@pytest.fixture
def cache_dir_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_dir_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = utils.configure_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_honours_env(monkeypatch, tmp_path, cache_dir_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert utils.configure_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code.
    assert jax.config.jax_compilation_cache_dir is None


# ----------------------------------------------------------- output format

def _minimal_config(**fit):
    return {"fit": {"nexperiments": 1, "nsteps": 10, "signals": [],
                    "observables": [], **fit}}


def test_output_format_defaults_to_npz():
    assert FitConfig.from_dict(_minimal_config()).output_format == "npz"


@pytest.mark.parametrize("fmt,package", [("hdf5", "h5py"),
                                         ("root", "uproot")])
def test_optional_format_without_package_fails_at_load(monkeypatch, fmt,
                                                       package):
    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(ConfigError, match=package):
        FitConfig.from_dict(_minimal_config(output_format=fmt))


# ---------------------------------------------------------------- precision

def _dot_precisions(jaxpr) -> list:
    """precision params of every dot_general, nested jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out += _dot_precisions(sub)
    return out


def _all_highest(closed) -> bool:
    precs = _dot_precisions(closed.jaxpr)
    highest = jax.lax.Precision.HIGHEST
    return bool(precs) and all(
        p is not None and all(q == highest for q in p) for p in precs)


def _nll_inputs(nsig, nev=64):
    return chip_smoke.synthetic_nll_inputs(nsig, nev, seed=1)


def test_mix_density_is_highest_precision():
    w = jnp.ones(3, jnp.float32)
    lut = jnp.ones((3, 8), jnp.float32)
    assert _all_highest(jax.make_jaxpr(nll_ops.mix_density)(w, lut))


def test_wide_nll_pair_is_highest_precision():
    pars, lut, norms, st = _nll_inputs(40)
    closed = jax.make_jaxpr(
        lambda p, l, n: nll_ops.nll_pair(p, l, n, st))(pars, lut, norms)
    assert _all_highest(closed)


def test_event_sharded_nll_is_highest_precision_and_compensated():
    pars, lut, norms, st = _nll_inputs(10, nev=200_000)
    mesh = mesh_lib.make_mesh(event=8)
    fn = nll_sharded.event_sharded_nll(mesh, st)
    lut_s = nll_sharded.shard_lut(mesh, lut)
    assert _all_highest(jax.make_jaxpr(fn)(pars, lut_s, norms))
    hi, lo = fn(jnp.asarray(pars), lut_s, jnp.asarray(norms))
    want = nll_ops.nll_pair(jnp.asarray(pars), lut, jnp.asarray(norms), st)
    # |NLL| ~ 2e6 here, where one f32 ulp is 0.25: a plain psum of the
    # shard sums would miss by that much.
    assert abs((float(hi) + float(lo))
               - (float(want[0]) + float(want[1]))) < 0.01


# ------------------------------------------------------------ chip_smoke.py

def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_check_exact_and_ulps():
    a = np.asarray([1.0, np.nan, 0.5], np.float32)
    chip_smoke.check_exact("same", a, a.copy())
    with pytest.raises(AssertionError, match="1 of 3 differ"):
        chip_smoke.check_exact("diff", a, np.asarray([1.0, np.nan, 0.25],
                                                      np.float32))
    b = a.copy()
    b[0] = np.nextafter(np.nextafter(a[0], np.float32(2)), np.float32(2))
    assert chip_smoke.check_ulps("two", b, a, 2) == 2
    b[0] = np.nextafter(b[0], np.float32(2))
    with pytest.raises(AssertionError, match="3 ulp"):
        chip_smoke.check_ulps("three", b, a, 2)


def test_check_weighted_gates_on_entries():
    want = np.asarray([1000.0, 50.0], np.float64)
    entries = np.asarray([1000, 50])
    got = want * np.asarray([1 + 5e-6, 1.5])
    # Bin 1 is off by 50%, but has too few entries to be gated.
    assert chip_smoke.check_weighted("w", got, want, entries) < 1e-5
    with pytest.raises(AssertionError, match="relative error"):
        chip_smoke.check_weighted("w", want * 1.001, want, entries)


def test_host_nll_matches_nll_pair():
    pars, lut, norms, st = _nll_inputs(5, nev=5000)
    got, want = [], []
    for p in (pars, pars * np.float32(1.001)):
        got.append(nll_ops.nll_pair(jnp.asarray(p), lut,
                                    jnp.asarray(norms), st))
        w = nll_ops.signal_weights(jnp.asarray(p), jnp.asarray(norms), st)
        want.append(chip_smoke.host_nll(p, w, np.asarray(lut), st,
                                        chunk=1000))
    out = chip_smoke.check_nll_vs_f64("nll", got, want)
    assert out["delta"] < 1e-3
    assert chip_smoke.check_nll("nll", got[0], want[0]) < 1e-3
    with pytest.raises(AssertionError, match="difference off"):
        chip_smoke.check_nll_vs_f64("nll", got, [want[0], want[1] + 1.0])
    with pytest.raises(AssertionError, match="NLL"):
        chip_smoke.check_nll("nll", got[0], want[0] + 1.0)


def test_layer_phase_tiny():
    out = chip_smoke.layer_phase(n_samples=200_000, n_eval=2000,
                                 n_events=20_000, nsigs=(3, 40),
                                 onbb_mc=5000)
    assert out["lut_max_ulps"] <= chip_smoke.LUT_MAX_ULPS
    assert out["nll_40"]["delta"] < chip_smoke.NLL_ATOL
