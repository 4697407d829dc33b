"""Tracing, metrics, and profiling.

Replaces the reference's TStopwatch timing + stderr prints +
``bin/time_plot`` (SURVEY.md section 5): structured step metrics, a
jax.profiler context for device traces, and parameter-trace plots from a
likelihood space.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np


class Stopwatch:
    """Wall-clock timer (reference: TStopwatch usage, mcmc.cpp:259)."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter()

    def real_time(self) -> float:
        return time.perf_counter() - self._t0


class MetricsLogger:
    """Structured JSONL metrics (acceptance rates, step times, ...)."""

    def __init__(self, path: Optional[str] = None, verbose: bool = False):
        self.path = path
        self.verbose = verbose
        self._records = []

    def log(self, event: str, **fields):
        rec = {"event": event, "time": time.time(), **fields}
        self._records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.verbose:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{event}] {kv}")

    @property
    def records(self):
        return list(self._records)


@contextlib.contextmanager
def profile(logdir: Optional[str] = None):
    """jax.profiler trace context (device timeline in TensorBoard)."""
    import jax

    if logdir is None:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def plot_traces(lspace, output_path: str, names=None, suffix: str = ""):
    """Parameter value vs step (reference: bin/time_plot:1-33)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_path, exist_ok=True)
    names = names or lspace.names
    nrows = len(names) + 1
    fig, axes = plt.subplots(nrows, 1, figsize=(8, 2 * nrows), sharex=True)
    axes = np.atleast_1d(axes)
    for ax, name in zip(axes, names):
        ax.plot(lspace.column(name), lw=0.3)
        ax.set_ylabel(name)
    axes[-1].plot(lspace.nll_values, lw=0.3, color="crimson")
    axes[-1].set_ylabel("NLL")
    axes[-1].set_xlabel("step")
    fig.tight_layout()
    out = os.path.join(output_path, f"traces{suffix}.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out
