"""Sharded toy-fit batches: the statistics tier over the device mesh.

The toy engines (Feldman-Cousins belts, CLs ensembles, pull studies)
are vmapped BFGS batches — embarrassingly parallel over the toy axis.
Sharding that axis over the mesh runs every chip's slice concurrently:
a pod-slice computes a belt in the wall-clock of ntoys / ndevices
fits.  The reference has no analog at any scale (its ensemble is a
serial host loop, sxmc.cpp:59-145, and it has no toy-fit machinery).

Mechanism: the padded toy batch is placed with a NamedSharding over
ALL mesh axes flattened onto the leading (toy) dimension; the existing
jitted kernels (stats.feldman_cousins._toy_dnll_batch,
stats.bias._toy_fit_batch) then partition automatically under XLA's
SPMD — no shard_map needed because the computation is elementwise in
the batch dimension.  MC sample arrays (device_data) are replicated.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _toy_sharding(mesh: Mesh) -> NamedSharding:
    """Leading (toy) axis sharded over every mesh axis."""
    return NamedSharding(mesh, P(tuple(mesh.axis_names)))


def _replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _pad_to_devices(arr: jnp.ndarray, ndev: int) -> Tuple[jnp.ndarray,
                                                          int]:
    """Pad the leading axis to a device-count multiple by repeating
    row 0 (results of pad rows are discarded)."""
    n = arr.shape[0]
    m = math.ceil(n / ndev) * ndev
    if m == n:
        return arr, n
    pad = jnp.broadcast_to(arr[:1], (m - n,) + arr.shape[1:])
    return jnp.concatenate([arr, pad], axis=0), n


def _shard_args(mesh: Mesh, leading, replicated):
    """device_put the toy-axis args (padded) and the replicated args."""
    ndev = mesh.size
    toy_sh = _toy_sharding(mesh)
    rep_sh = _replicated(mesh)
    out_leading = []
    n = None
    for a in leading:
        a, n = _pad_to_devices(jnp.asarray(a), ndev)
        out_leading.append(jax.device_put(a, toy_sh))
    out_rep = jax.tree_util.tree_map(
        lambda x: jax.device_put(jnp.asarray(x), rep_sh), replicated)
    return out_leading, out_rep, n


def sharded_toy_dnll(mesh: Mesh, mle, r_values, read_bins_batch,
                     k: int, free_idx, maxiter: int):
    """stats.feldman_cousins._toy_dnll_batch with the toy axis sharded
    over ``mesh``.  Returns (dnll, rhat) as numpy, un-padded.

    Exactness: every toy's fit is independent, so sharding changes
    placement, not math — asserted by tests/test_toys_sharded.py.
    """
    from sxmc_jax.stats.feldman_cousins import _toy_dnll_batch

    (rv, rb), dd, n = _shard_args(
        mesh, (r_values, read_bins_batch), mle.stack.device_data)
    with mesh:
        dnll, rhat = _toy_dnll_batch(mle, rv, rb, tuple(dd), k,
                                     tuple(free_idx), maxiter)
    return np.asarray(dnll)[:n], np.asarray(rhat)[:n]


def sharded_pull_batch(mesh: Mesh, mle, read_bins_batch, free_idx,
                       maxiter: int):
    """stats.bias._toy_fit_batch with the toy axis sharded over
    ``mesh``.  Returns (r_hat, sigma_hat) as numpy, un-padded."""
    from sxmc_jax.stats.bias import _toy_fit_batch

    (rb,), dd, n = _shard_args(
        mesh, (read_bins_batch,), mle.stack.device_data)
    with mesh:
        rhat, err = _toy_fit_batch(mle, rb, tuple(dd),
                                   tuple(free_idx), maxiter)
    return np.asarray(rhat)[:n], np.asarray(err)[:n]
