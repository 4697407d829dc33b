"""Event-sharded NLL: the 10M+ event path.

The reference chunks events with grid-stride partial sums + a
shared-memory reduction (nll_kernels.cpp:97-146, mcmc.cpp:37-44); the
equivalent here shards the event axis of the LUT over the mesh, takes
per-shard log-sums locally, and finishes with a ``psum`` over the
``event`` axis — the partial-sums pipeline reborn as one collective.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sxmc_jax.ops.nll import (NLLStatic, df_sum, finish_nll, log_sum,
                              mix_density, signal_weights, two_sum)


def psum_pair(hi, lo, axis_name: str):
    """Compensated sum of per-shard (hi, lo) pairs over a mesh axis.

    A plain psum of the hi parts would round once per add at the
    magnitude of the total (at 10^7 events that is several units of
    NLL); gathering the pairs and summing them with TwoSum keeps the
    full compensated precision.
    """
    his = jax.lax.all_gather(hi, axis_name)
    los = jax.lax.all_gather(lo, axis_name)
    h, e = df_sum(his)
    return two_sum(h, e + jnp.sum(los))


def event_sharded_nll(mesh: Mesh, st: NLLStatic):
    """Build nll(pars, lut, norms) with lut sharded over ``event``.

    Returns a jitted callable giving the compensated ``(hi, lo)`` pair
    of :func:`sxmc_jax.ops.nll.nll_pair`; ``lut`` is
    ``(nsignals, nevents)`` with the event axis laid out over the
    mesh's ``event`` axis.  The event log-sum is computed shard-locally
    and finished with a compensated all-reduce, so no shard ever
    materializes the full LUT.
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(None, "event"), P()),
        out_specs=(P(), P()),
        # psum_pair's gathered sums are identical on every shard, which
        # the varying-axes checker cannot infer.
        check_vma=False,
    )
    def _nll(pars, lut_shard, norms):
        w = signal_weights(pars, norms, st)
        lut0 = jnp.nan_to_num(lut_shard, nan=0.0, posinf=0.0, neginf=0.0)
        # Same dot -> log -> reduce fence as ops.nll.nll_pair.
        s = jax.lax.optimization_barrier(mix_density(w, lut0))
        ev_hi, ev_lo = psum_pair(*log_sum(s), "event")
        return finish_nll(pars, ev_hi, ev_lo, w, st)

    return jax.jit(_nll)


def shard_lut(mesh: Mesh, lut: jnp.ndarray) -> jnp.ndarray:
    """Lay a (nsignals, nevents) LUT out over the event axis."""
    return jax.device_put(lut, NamedSharding(mesh, P(None, "event")))
