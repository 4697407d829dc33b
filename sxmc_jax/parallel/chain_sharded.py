"""Fully event-sharded MCMC chain: the 10M+ event / 10M+ MC-sample path.

Both the MC samples (histogram build) and the data events (NLL
reduction) are sharded over the mesh's ``event`` axis; each step runs
under ``shard_map`` with two psums:

    local partial histogram  --psum-->  full bins + norms
    local event log-sum      --psum-->  full NLL event term

Every shard runs the identical proposal/accept RNG stream, so the chain
state stays replicated without broadcasts — the whole walk is one
``lax.scan`` per phase, as in the single-device path.

In-shard histogram: each shard transforms and bins its slice of the
MC samples with the same scatter-add bincount as the single-device
path (ops.histogram.segmented_histogram), then psums the partial
tables.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sxmc_jax.mcmc.metropolis import MCMC, HAARIO, nll_history_to_f64
from sxmc_jax.ops import histogram as hist_ops
from sxmc_jax.ops.nll import (df_diff, finish_nll, log_sum, mix_density,
                              signal_weights)
from sxmc_jax.parallel.nll_sharded import psum_pair
from sxmc_jax.pdf import evalhist
from sxmc_jax.pdf.stack import _apply_masked_systematics
from sxmc_jax.stats.likelihood import LikelihoodSpace


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def run_sharded_chain(
    mcmc: MCMC,
    data: np.ndarray,
    nsteps: int,
    burnin_fraction: float = 0.1,
    mesh: Optional[Mesh] = None,
    seed: int = 0,
    debug_mode: bool = False,
) -> LikelihoodSpace:
    """Run one chain with MC samples + events sharded over ``event``."""
    if mesh is None:
        ndev = len(jax.devices())
        mesh = Mesh(np.asarray(jax.devices()), axis_names=("event",))
    ndev = mesh.shape["event"]
    stack = mcmc.stack
    if getattr(stack, "has_kde", False):
        raise NotImplementedError(
            "Event-sharded chains support binned PDFs only; KDE signals "
            "evaluate on the replicated path.")

    # --- shard the MC samples (pad with out-of-domain rows). ---
    # Host copies: nothing is read back from the device here.
    # Static-segment skip (mirrors PdfStack): only signals some
    # systematic touches need per-step rebuilds — their samples shard;
    # static signals contribute a host-precomputed constant table.
    dyn_idx = stack._dyn_idx
    ndyn = stack._ndyn
    if ndyn < stack.nsignals:
        full_samples = stack.samples_host
        full_seg = stack.segment_ids_host
        sel = np.isin(full_seg, np.asarray(dyn_idx, np.int32))
        remap = np.zeros(stack.nsignals, np.int64)
        for j, i in enumerate(dyn_idx):
            remap[i] = j
        samples = full_samples[sel]
        seg = remap[full_seg[sel]].astype(np.int32)
        static_base = np.zeros((stack.nsignals, stack.total_nbins),
                               np.float32)
        if stack._static_idx:
            static_base[np.asarray(stack._static_idx)] = \
                stack._static_hists_np
    else:
        samples = stack.samples_host
        seg = stack.segment_ids_host
        static_base = None
    n = samples.shape[0]
    npad = _pad_to(max(n, 1), ndev * 8)
    pad_rows = np.full((npad - n, samples.shape[1]),
                       stack.lower_host[0] - 1e9, np.float32)
    samples_p = np.concatenate([samples, pad_rows])
    seg_p = np.concatenate([seg, np.zeros(npad - n, np.int32)])

    # --- shard the data events (pad with unknown dataset tag). ---
    data = np.asarray(data, np.float32)
    rb = np.asarray(stack.compute_read_bins(data))
    nev = rb.shape[1]
    nev_pad = _pad_to(nev, ndev * 8)
    rb_p = np.full((rb.shape[0], nev_pad), -2, np.int32)
    rb_p[:, :nev] = rb

    burnin_steps = int(nsteps * burnin_fraction)
    key = jax.random.PRNGKey(seed)

    nsources = mcmc.nsources
    st = mcmc.static
    fixed = jnp.asarray(mcmc.parameter_fixed)
    sf = HAARIO / max(mcmc.nfloat, 1)
    syst_float = (mcmc.nsystematics > 0) and not mcmc.systematics_fixed
    # No dynamic binned segment -> the histogram table is constant even
    # when systematic parameters float (they only enter constraints).
    rebuild = syst_float and ndyn > 0
    theta0_np = mcmc.parameter_means[nsources:].astype(np.float32)

    nbins = stack.nbins
    nsignals = stack.nsignals
    total_nbins = stack.total_nbins
    bin_volume = stack.bin_volume
    lower = np.asarray(stack.lower_host, np.float32)
    upper = np.asarray(stack.upper_host, np.float32)
    systematics = (stack.systematics if static_base is None
                   else stack._systematics_dyn)
    nseg_build = max(ndyn, 1)

    hist_in_host = (samples_p, seg_p)
    hist_in_specs = (P("event"), P("event"))

    def _assemble_static(dyn_h):
        dyn_h = jax.lax.psum(dyn_h, "event")
        if static_base is None:
            hists = dyn_h
        else:
            hists = jnp.asarray(static_base)
            if ndyn:
                hists = hists.at[np.asarray(dyn_idx)].set(dyn_h)
        return hists, hists.sum(axis=1)

    def local_hists(hist_in, theta):
        samples_l, seg_l = hist_in
        transformed = _apply_masked_systematics(
            samples_l, seg_l, theta, systematics, nseg_build)
        dyn_h, _ = hist_ops.segmented_histogram(
            transformed[:, :len(nbins)], seg_l,
            jnp.ones(samples_l.shape[0], bool),
            lower, upper, nbins, nseg_build)
        return _assemble_static(dyn_h)

    def sharded_nll(params, hist_in, rb_l, hists0, norms0):
        """Compensated (hi, lo) NLL with the event sum all-reduced.

        Each shard accumulates its local log-sum as a TwoSum pair (the
        double-accumulation analog of nll_kernels.cpp:89-116), and the
        pairs combine with a compensated all-reduce (psum_pair).
        """
        if rebuild:
            hists, norms = local_hists(hist_in, params[nsources:])
        else:
            hists, norms = hists0, norms0
        lut = jax.vmap(evalhist.eval_from_bins,
                       in_axes=(0, 0, None, 0))(
            hists, norms, bin_volume, rb_l)
        w = signal_weights(params, norms, st)
        lut0 = jnp.nan_to_num(lut, nan=0.0)
        # Same dot -> log -> reduce fence as ops.nll.nll_pair.
        s = jax.lax.optimization_barrier(mix_density(w, lut0))
        ev_hi, ev_lo = psum_pair(*log_sum(s), "event")
        return finish_nll(params, ev_hi, ev_lo, w, st)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(hist_in_specs, P(None, "event"), P()),
        out_specs=(P(), (P(), P()), P()),
        # The chain state is replicated (identical RNG stream and
        # all-reduced NLL on every shard), which the varying-axes
        # checker cannot infer.
        check_vma=False,
    )
    def run(hist_in, rb_l, key):
        if not rebuild:
            hists0, norms0 = local_hists(hist_in,
                                         jnp.asarray(theta0_np))
        else:
            hists0 = norms0 = None

        def chain_nll(params):
            return sharded_nll(params, hist_in, rb_l, hists0, norms0)

        def step(carry, step_key):
            params, (cur_hi, cur_lo), width = carry
            k_prop, k_accept = jax.random.split(step_key)
            noise = jax.random.normal(k_prop, params.shape) * \
                jnp.maximum(width, 0.0)
            proposed = jnp.where(width > 0, params + noise, params)
            prop_hi, prop_lo = chain_nll(proposed)
            u = jax.random.uniform(k_accept, ())
            delta = df_diff(cur_hi, cur_lo, prop_hi, prop_lo)
            accept = debug_mode | (delta > 0) | (u <= jnp.exp(delta))
            params = jnp.where(accept, proposed, params)
            cur_hi = jnp.where(accept, prop_hi, cur_hi)
            cur_lo = jnp.where(accept, prop_lo, cur_lo)
            return ((params, (cur_hi, cur_lo), width),
                    (params, (cur_hi, cur_lo),
                     accept.astype(jnp.float32)))

        def phase(carry, k, nsteps_phase):
            return jax.lax.scan(step, carry,
                                jax.random.split(k, nsteps_phase))

        def retune(width, phase_samples):
            rms = jnp.std(phase_samples, axis=0)
            new = jnp.where(rms > 0, sf * rms, width)
            return jnp.where(fixed, -1.0, new)

        params0 = jnp.asarray(mcmc.parameter_means, jnp.float32)
        nll0 = chain_nll(params0)
        width0 = jnp.asarray(mcmc.initial_jump_widths())
        carry = (params0, nll0, width0)

        k1, k2, k3 = jax.random.split(key, 3)
        if burnin_steps > 0:
            carry, (s1, _, _) = phase(carry, k1, burnin_steps)
            p, c, w = carry
            carry = (p, c, retune(w, s1))
            carry, (s2, _, _) = phase(carry, k2, burnin_steps)
            p, c, w = carry
            carry = (p, c, retune(w, s2))
        remaining = max(
            nsteps - (2 * burnin_steps if burnin_steps > 0 else 0), 1)
        carry, (s3, n3, a3) = phase(carry, k3, remaining)
        return s3, n3, a3.mean()

    with mesh:
        hist_in_s = tuple(
            jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
            for a, spec in zip(hist_in_host, hist_in_specs))
        rb_s = jax.device_put(
            jnp.asarray(rb_p), NamedSharding(mesh, P(None, "event")))
        chain, nlls, accept = run(hist_in_s, rb_s, key)

    mcmc.last_accept_rate = float(np.asarray(accept))
    return LikelihoodSpace.from_arrays(
        np.asarray(chain), nll_history_to_f64(nlls),
        mcmc.parameter_names)
