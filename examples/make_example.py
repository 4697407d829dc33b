"""Generate example MC ntuples + a fit configuration.

Creates the analog of the reference's config/example.json setup with
synthetic data, runnable out of the box:

    python examples/make_example.py workdir/
    python -m sxmc_jax.cli workdir/example.json workdir/out/
"""

import json
import os
import sys

import numpy as np


def main(outdir: str = "example_workdir") -> str:
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(1234)
    n = 500_000
    fields = ["energy", "mc_energy", "radius"]

    # Signal 1: Gaussian line at 10 MeV with detector smearing.
    mc_e1 = rng.normal(10.0, 0.2, n).astype(np.float32)
    e1 = (mc_e1 + rng.normal(0, 0.8, n)).astype(np.float32)
    sig1 = np.stack([e1, mc_e1, rng.uniform(0, 10, n).astype(np.float32)],
                    axis=1)

    # Signal 2: falling background spectrum.
    mc_e2 = (5.0 + rng.exponential(3.0, n)).astype(np.float32)
    e2 = (mc_e2 + rng.normal(0, 0.8, n)).astype(np.float32)
    sig2 = np.stack([e2, mc_e2, rng.uniform(0, 10, n).astype(np.float32)],
                    axis=1)

    from sxmc_jax.io import loaders

    loaders.write_float_table(os.path.join(outdir, "signal1.npz"),
                              sig1, fields)
    loaders.write_float_table(os.path.join(outdir, "signal2.npz"),
                              sig2, fields)

    # The reference's config/example.json structure.
    config = {
        "fit": {
            "nexperiments": 1,
            "nsteps": 100000,
            "burnin_fraction": 0.2,
            "signal_name": "signal1",
            "signals": ["signal1", "signal2"],
            "observables": ["energy"],
            "cuts": ["radius"],
            "seed": 42,
        },
        "pdfs": {
            "observables": {
                "energy": {"title": "Energy (MeV)", "units": "MeV",
                           "field": "energy", "bins": 10,
                           "min": 5.0, "max": 15.0},
                "radius": {"title": "Radius (m)", "units": "m",
                           "field": "radius", "bins": 10,
                           "min": 0.0, "max": 10.0},
            },
            "systematics": {
                "energy_scale": {
                    "title": "Energy scale", "type": "scale",
                    "observable_field": "energy",
                    "mean": [0.0], "sigma": [1e-2]},
                "energy_resolution": {
                    "title": "Energy resolution",
                    "type": "resolution_scale",
                    "observable_field": "energy",
                    "truth_field": "mc_energy",
                    "mean": [0.0], "sigma": [1e-3]},
            },
        },
        "signals": {
            "signal1": {
                "title": "Signal 1",
                "filename": os.path.join(outdir, "signal1.npz"),
                "dataset": 0,
                "systematics": ["energy_scale", "energy_resolution"],
                "scale": 500.0,
                "sigma": 0.05,
            },
            "signal2": {
                "title": "Signal 2",
                "filename": os.path.join(outdir, "signal2.npz"),
                "systematics": ["energy_scale", "energy_resolution"],
                "dataset": 0,
                "scale": 1000.0,
            },
        },
    }
    cfg = os.path.join(outdir, "example.json")
    with open(cfg, "w") as f:
        json.dump(config, f, indent=2)
    print(f"wrote {cfg}")
    return cfg


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "example_workdir")
