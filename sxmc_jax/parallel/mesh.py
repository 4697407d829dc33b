"""Device-mesh construction for sharded fits.

The reference is single-process/single-GPU (SURVEY.md section 2.2);
here the math maps onto a device mesh with up to three axes:

  * ``exp``   — fake experiments (the ensemble axis; no collective
    until the final gather),
  * ``chain`` — MCMC chains per experiment,
  * ``event`` — the event dimension of the NLL reduction (one psum per
    step), the structural analog of sequence/context parallelism.

The mesh follows the algorithm, not the interconnect: the cards of one
host are joined all to all.

Collectives: the event-sharded NLL finishes with a psum; chain/ensemble
statistics pool with pmean/all_gather (see sxmc_jax.parallel.ensemble).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    exp: int = 1,
    chain: int = 1,
    event: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build an {exp x chain x event} mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = exp * chain * event
    if n > len(devices):
        raise ValueError(
            f"Mesh {exp}x{chain}x{event} needs {n} devices, "
            f"have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(exp, chain, event)
    return Mesh(dev, axis_names=("exp", "chain", "event"))


def auto_mesh(nexperiments: int, nchains: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Pick a mesh: fill the experiment axis first, then chains."""
    if devices is None:
        devices = jax.devices()
    nd = len(devices)
    exp = min(nexperiments, nd) if nexperiments > 0 else 1
    while nd % exp != 0:
        exp -= 1
    chain = min(max(nchains, 1), nd // exp)
    while (nd // exp) % chain != 0:
        chain -= 1
    return make_mesh(exp=exp, chain=chain, event=1,
                     devices=devices[:exp * chain])


def experiment_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a leading (experiment, chain, ...) batch over the mesh."""
    return NamedSharding(mesh, P("exp", "chain"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> bool:
    """Bring up the multi-process runtime (jax.distributed).

    The reference has no distributed story at all (SURVEY.md section
    2.2); here the ensemble axis fans out across processes.  With an
    explicit coordinator any failure raises: a run that asked for N
    processes must not quietly continue as one.  With no arguments,
    cluster auto-detection is attempted and single-process is the
    fallback.  ``kwargs`` pass through (e.g. ``local_device_ids`` to
    pin each process of one host to its own card).

    Returns:
        True if a multi-process runtime is active after the call.
    """
    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id, **kwargs)
    else:
        try:
            jax.distributed.initialize(**kwargs)
        except (RuntimeError, ValueError):
            pass  # already initialized or nothing to detect
    return jax.process_count() > 1


def process_local_experiments(nexperiments: int,
                              process_index: Optional[int] = None,
                              process_count: Optional[int] = None):
    """Global experiment indices owned by this process.

    Contiguous blocks, remainder spread over the first processes.  Fake
    datasets are keyed by the GLOBAL index (fold_in), so the ensemble's
    results are bit-identical for any process count.
    """
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    base, extra = divmod(nexperiments, pc)
    start = pi * base + min(pi, extra)
    stop = start + base + (1 if pi < extra else 0)
    return list(range(start, stop))


def local_mesh(nchains: int = 1) -> Mesh:
    """{exp x chain} mesh over THIS process's devices (one process's
    block of the global {exp x chain} layout)."""
    devices = jax.local_devices()
    nd = len(devices)
    chain = min(max(nchains, 1), nd)
    while nd % chain != 0:
        chain -= 1
    dev = np.asarray(devices).reshape(nd // chain, chain)
    return Mesh(dev, axis_names=("exp", "chain"))
