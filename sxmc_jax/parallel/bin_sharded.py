"""Bin-dimension sharding: PDFs too large for one device's memory.

SURVEY.md §2.2 lists the bin/model axis as the remaining parallel
dimension: a high-dimensional PDF (e.g. 5 observables x 20 bins =
3.2M bins x nsignals) can outgrow a single device once multiplied by
chains and experiments.  The reference has no analog (one GPU holds
one histogram, pdfz.cpp:158-175).

Here the flat bin axis is laid out over a mesh axis ``bin``:

  * build: every shard histograms the (replicated) samples into ONLY
    its bin range — no collective at all; the output histogram is
    born sharded ``P(None, "bin")``.
  * eval:  each shard looks up the events whose read bin falls in its
    range and contributes zero elsewhere; one ``psum`` over ``bin``
    reassembles the (nsignals, nevents) LUT.  Sentinels are applied
    after the psum from the replicated read bins (-1 -> NaN out of
    domain, -2 -> 0 dataset mismatch; pdfz.cpp:289-301).

Composable with the event axis: the LUT produced here feeds
``nll_sharded.event_sharded_nll`` unchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sxmc_jax.ops import histogram as hist_ops
from sxmc_jax.pdf.stack import _apply_masked_systematics


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def padded_bins(total_nbins: int, mesh: Mesh) -> int:
    """Flat bin count padded to a multiple of the ``bin`` axis size."""
    return _pad_to(total_nbins, mesh.shape["bin"])


def bin_sharded_histograms(mesh: Mesh, stack, theta_syst):
    """All signals' histograms with the BIN axis sharded over ``bin``.

    Args:
        mesh: a Mesh with a ``bin`` axis.
        stack: a PdfStack (binned signals only).
        theta_syst: systematic parameters.

    Returns:
        (hists, norms): ``(nsignals, padded_bins)`` f32 laid out
        ``P(None, "bin")`` (pad bins always zero), and ``(nsignals,)``
        replicated in-domain counts.
    """
    if getattr(stack, "has_kde", False):
        raise NotImplementedError(
            "bin-sharded builds support binned PDFs only")
    ndev = mesh.shape["bin"]
    total = stack.total_nbins
    padded = _pad_to(total, ndev)
    local = padded // ndev
    nsignals = stack.nsignals

    samples = jnp.asarray(stack.samples_host)
    seg = jnp.asarray(stack.segment_ids_host)
    w = (jnp.asarray(stack.sample_weights_host)
         if stack.sample_weights_host is not None
         else jnp.ones(samples.shape[0], jnp.float32))
    theta_syst = jnp.asarray(theta_syst, jnp.float32)
    lower, upper = stack.lower, stack.upper
    nbins = stack.nbins
    systematics = stack.systematics

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(None, "bin"), P()),
    )
    def build(samples_r, seg_r, w_r, theta):
        # Shard-local bin range [lo, lo + local).
        lo = jax.lax.axis_index("bin") * local
        transformed = _apply_masked_systematics(
            samples_r, seg_r, theta, systematics, nsignals)
        ids, valid = hist_ops.compute_bin_ids(
            transformed[:, :len(nbins)], lower, upper, nbins)
        norms = jax.ops.segment_sum(
            valid.astype(jnp.float32) * w_r, seg_r,
            num_segments=nsignals)
        # Mask to the local range; fixed_bincount over local bins only.
        in_range = valid & (ids >= lo) & (ids < lo + local)
        local_ids = jnp.clip(ids - lo, 0, local - 1)
        flat = seg_r * local + local_ids
        hists = hist_ops.fixed_bincount(
            flat, in_range.astype(jnp.float32) * w_r, nsignals * local
        ).reshape(nsignals, local)
        return hists, norms

    with mesh:
        return build(samples, seg, w, theta_syst)


def bin_sharded_eval(mesh: Mesh, hists_sharded, norms, read_bins,
                     bin_volume: float):
    """Evaluate the (nsignals, nevents) LUT from a bin-sharded table.

    Each shard resolves only the events whose read bin lives in its
    range; a single psum over ``bin`` assembles the full LUT
    (replicated), with the EvalHist sentinel contract applied after
    (-1 -> NaN, -2 -> 0).
    """
    ndev = mesh.shape["bin"]
    nsignals, padded = hists_sharded.shape
    local = padded // ndev
    read_bins = jnp.asarray(read_bins)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, "bin"), P(), P()),
        out_specs=P(),
    )
    def evaluate(h_local, norms_r, rb_r):
        lo = jax.lax.axis_index("bin") * local
        pos = rb_r - lo
        mine = (pos >= 0) & (pos < local)
        pos = jnp.clip(pos, 0, local - 1)
        counts = jnp.take_along_axis(h_local, pos, axis=1)
        counts = jnp.where(mine, counts, 0.0)
        part = counts / (norms_r[:, None] * bin_volume)
        return jax.lax.psum(part, "bin")

    with mesh:
        vals = evaluate(hists_sharded, jnp.asarray(norms), read_bins)
    vals = jnp.where(read_bins == -2, 0.0, vals)
    vals = jnp.where(read_bins == -1, jnp.nan, vals)
    return vals


def make_bin_mesh(ndev: int = 0) -> Mesh:
    """A 1-D mesh whose single axis is the bin dimension."""
    devs = jax.devices()
    if ndev <= 0:
        ndev = len(devs)
    return Mesh(np.asarray(devs[:ndev]), axis_names=("bin",))
