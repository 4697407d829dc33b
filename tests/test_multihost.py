"""Multi-host (DCN) ensemble: 2-process jax.distributed CPU test.

SURVEY.md section 4 calls for "multi-host tests using jax.distributed
with a multi-process CPU mesh" — the analog of the reference's CPU
fallback.  Two worker processes bring up a real jax.distributed
runtime over a localhost coordinator, each generates/fits only its own
half of the ensemble, the limits are all-gathered, and the result must
match a single-process run of the same ensemble exactly (datasets are
keyed by global experiment index and shaped identically, so the
computation is process-count-invariant).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in [env.get("PYTHONPATH", ""), root] if p])
    return env


def test_two_process_ensemble_matches_single(tmp_path):
    env = _env()

    # --- single-process reference.
    ref_dir = tmp_path / "single"
    ref_dir.mkdir()
    subprocess.run(
        [sys.executable, WORKER, "0", "1", "-", str(ref_dir)],
        env=env, check=True, timeout=900)
    ref = json.load(open(ref_dir / "limits_0.json"))
    assert ref["n_local"] == 4
    assert all(x > 0 for x in ref["limits"])

    # --- two processes over a localhost coordinator.
    mh_dir = tmp_path / "multi"
    mh_dir.mkdir()
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", coord, str(mh_dir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    r0 = json.load(open(mh_dir / "limits_0.json"))
    r1 = json.load(open(mh_dir / "limits_1.json"))
    assert r0["nproc"] == r1["nproc"] == 2
    # Each process fit only its local half...
    assert r0["n_local"] == r1["n_local"] == 2
    # ...but the gathered limit vector is identical on both.
    assert r0["limits"] == r1["limits"]
    # And the split ensemble reproduces the single-process ensemble.
    np.testing.assert_allclose(r0["limits"], ref["limits"],
                               rtol=1e-5, atol=0.0)
