"""Sharded ensemble: fake experiments fanned out over the mesh.

Replaces the reference's serial experiment loop (sxmc.cpp:59-145): all
``nexperiments`` datasets are padded to a common event count (padding
rows carry an unknown dataset tag, so their read-bin sentinel -2 makes
them invisible to the NLL), their chains run as one batch over
{experiments x chains}, and the batch's leading axes are sharded over
the mesh's {exp, chain} axes.  The chains run the vmapped scan
steppers, partitioned over the mesh by jit.

Checkpointing: with ``checkpoint_steps > 0`` the batched walk runs in
fixed-size segments with the FULL batched chain state (params,
compensated NLL pairs, proposal state, per-phase moment accumulators
for the retunes) persisted atomically after each segment — a preempted
run resumes exactly where the last completed segment ended
(``resume=True``), since datasets and per-segment keys are derived
deterministically from ``fc.seed`` and the segment index.  Segment
sample histories land in sidecar files and are concatenated at the
end; results are bit-identical to an uninterrupted segmented run.
Both proposals checkpoint: ``full_cov`` retunes resume exactly from
running centered moments (count, sum, cross-products around the
phase-start point) instead of the whole phase history.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sxmc_jax.fitconfig import FitConfig
from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc import metropolis
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.parallel import mesh as mesh_lib
from sxmc_jax.stats.likelihood import LikelihoodSpace

PAD_TAG = -999.0  # dataset tag no signal uses -> -2 read-bin sentinel


def pad_datasets(datasets: Sequence[np.ndarray],
                 nevents: Optional[int] = None) -> np.ndarray:
    """Stack ragged datasets into (nexp, nevents, ncols) with pad rows."""
    if nevents is None:
        nevents = max(d.shape[0] for d in datasets)
    ncols = datasets[0].shape[1]
    out = np.zeros((len(datasets), nevents, ncols), np.float32)
    out[:, :, -1] = PAD_TAG
    for i, d in enumerate(datasets):
        out[i, :d.shape[0]] = d[:nevents]
    return out


@functools.partial(
    jax.jit,
    static_argnames=("mcmc", "nsteps", "debug_mode", "rate_substeps",
                     "proposal"))
def _batched_segment(mcmc: MCMC, params, nll_pair, width, keys, rb,
                     device_data, nsteps: int, debug_mode: bool,
                     rate_substeps: int = 0,
                     proposal: str = "diagonal"):
    """One fixed-width segment of the (nexp, nchain) batched walk on
    the vmapped scan steppers.

    Explicit chain state in/out — the checkpointing building block
    (the batched analog of metropolis.run_segment).  With
    ``proposal="full_cov"`` the per-chain ``width`` slot carries the
    ``(npar, npar)`` scale_tril."""

    if proposal == "full_cov":
        def one(p, nl, t, k, rb_):
            step = metropolis._make_step_cov(mcmc, rb_, device_data,
                                             debug_mode)
            ks = jax.random.split(k, nsteps)
            carry, (samples, nlls, accepts) = jax.lax.scan(
                step, (p, nl, t), ks)
            return carry[0], carry[1], samples, nlls, accepts.mean()
    else:
        def one(p, nl, w, k, rb_):
            step, init_extras, m = metropolis._make_stepper(
                mcmc, rb_, device_data, debug_mode, rate_substeps)
            ks = jax.random.split(k, nsteps)
            xs = metropolis._presample(ks, mcmc.nparameters, m)
            carry = (p, nl, w) + tuple(init_extras(p))
            carry, (samples, nlls, accepts) = jax.lax.scan(step, carry,
                                                           xs)
            return carry[0], carry[1], samples, nlls, accepts.mean()

    over_chains = jax.vmap(one, in_axes=(0, (0, 0), 0, 0, None))
    return jax.vmap(over_chains, in_axes=(0, (0, 0), 0, 0, 0))(
        params, nll_pair, width, keys, rb)


def _segment_keys(key, nexp: int, nchain: int, phase: int, seg: int):
    """Deterministic per-(exp, chain) segment keys — identical whether
    or not the run was interrupted before this segment."""
    base = jax.random.fold_in(jax.random.fold_in(key, 7000 + phase),
                              seg)
    flat = jax.random.split(base, nexp * nchain)
    return flat.reshape(nexp, nchain, *flat.shape[1:])


def _sharded_retune(mcmc: MCMC, width, count, psum, psumsq):
    """Batched jump-width retune from running phase moments.

    jnp.std(phase_samples, axis=0) == sqrt(E[x^2] - E[x]^2) (ddof=0),
    so the checkpoint only carries (count, sum, sumsq) instead of the
    whole burn-in history."""
    from sxmc_jax.mcmc.metropolis import HAARIO

    mean = psum / count
    var = jnp.maximum(psumsq / count - mean * mean, 0.0)
    rms = jnp.sqrt(var)
    sf = HAARIO / max(mcmc.nfloat, 1)
    fixed = jnp.asarray(mcmc.parameter_fixed)
    new = jnp.where(rms > 0, sf * rms, width)
    return jnp.where(fixed[None, None, :], -1.0, new)


def _sharded_retune_cov(mcmc: MCMC, tril, count, psum, pcross):
    """Batched Haario full-covariance retune from running CENTERED
    phase moments.

    ``psum``/``pcross`` accumulate (x - c) and (x - c)(x - c)^T around
    the phase-start point c, so the one-pass covariance
    (pcross - n mu mu^T) / (n - 1) suffers no large-mean cancellation
    in f32.  Per-parameter masking matches
    :func:`metropolis.retune_scale_tril` (equal up to fp association);
    the checkpoint carries only (count, sum, cross) instead of the
    whole phase history."""
    free = jnp.asarray(~mcmc.parameter_fixed, jnp.float32)
    mu = psum / count
    cov = (pcross - count * mu[..., :, None] * mu[..., None, :]) \
        / jnp.maximum(count - 1.0, 1.0)
    cov = cov * (free[:, None] * free[None, :])
    return jax.vmap(jax.vmap(
        lambda t, c: metropolis._tril_from_cov(mcmc, t, c)))(tril, cov)


def run_sharded_ensemble(
    fc: FitConfig,
    mesh: Optional[Mesh] = None,
    nsteps: Optional[int] = None,
    verbose: bool = True,
    checkpoint_path: Optional[str] = None,
    checkpoint_steps: int = 0,
    resume: bool = False,
) -> Tuple[List[LikelihoodSpace], List[float]]:
    """Generate + fit all experiments as one sharded batch.

    ``checkpoint_steps > 0`` (with a ``checkpoint_path`` prefix) runs
    the walk in persisted segments; ``resume=True`` continues a killed
    run from its last completed segment.  Returns the per-experiment
    likelihood spaces and upper limits on ``fc.signal_name``.
    """
    nsteps = nsteps or fc.nsteps
    if mesh is None:
        mesh = mesh_lib.auto_mesh(fc.nexperiments, fc.nchains)
    if checkpoint_steps > 0 and not checkpoint_path:
        raise ValueError(
            "checkpoint_steps > 0 requires checkpoint_path")

    setup = _ensemble_setup(fc, nsteps)
    mcmc, rb, key, nchains, burnin_steps, device_data, extras = setup
    if checkpoint_steps > 0:
        return _run_sharded_ensemble_segmented(
            fc, mesh, nsteps, verbose, checkpoint_path,
            checkpoint_steps, resume, setup)

    keys = jnp.stack([
        jax.random.split(jax.random.fold_in(key, 1000 + i), nchains)
        for i in range(fc.nexperiments)])  # (nexp, nchain, 2)

    # Proposal geometry follows the fit config: diagonal widths, or
    # Haario full-covariance chains (fit.proposal = "full_cov").
    if getattr(fc, "proposal", "diagonal") == "full_cov":
        chain_fn = lambda k, rb_, dd: metropolis._run_single_chain_fullcov(  # noqa: E731,E501
            mcmc, k, rb_, dd, nsteps=nsteps,
            burnin_steps=burnin_steps, debug_mode=fc.debug_mode)
    else:
        chain_fn = lambda k, rb_, dd: metropolis._run_single_chain(  # noqa: E731,E501
            mcmc, k, rb_, dd, nsteps=nsteps,
            burnin_steps=burnin_steps, debug_mode=fc.debug_mode,
            rate_substeps=getattr(fc, 'rate_substeps', 0))

    shard = NamedSharding(mesh, P("exp", "chain"))
    keys = jax.device_put(keys, shard)
    rb = jax.device_put(rb, NamedSharding(mesh, P("exp")))

    if extras is not None:
        # Exact-LUT KDE: each experiment pairs with ITS OWN event
        # coordinates and precomputed static KDE rows, appended to the
        # shared device data inside the experiment vmap (the shapes
        # then match a set_data() snapshot, so _exact_kde_override
        # applies unchanged).
        def run_one_experiment(exp_keys, exp_rb, exp_extras, dd0):
            dd = tuple(dd0) + tuple(exp_extras)
            return jax.vmap(lambda k: chain_fn(k, exp_rb, dd))(exp_keys)

        extras = tuple(
            jax.device_put(e, NamedSharding(mesh, P("exp")))
            for e in extras)
        with mesh:
            samples, nlls, accept = jax.jit(jax.vmap(
                run_one_experiment, in_axes=(0, 0, 0, None)))(
                    keys, rb, extras, device_data)
        samples = np.asarray(samples)
        nlls = metropolis.nll_history_to_f64(nlls)
        return _collect_results(fc, mcmc, samples, nlls, verbose)

    def run_one_experiment(exp_keys, exp_rb, dd):
        return jax.vmap(lambda k: chain_fn(k, exp_rb, dd))(exp_keys)

    # The MC samples are jit arguments, never closure constants.
    batched = jax.vmap(run_one_experiment, in_axes=(0, 0, None))

    with mesh:
        samples, nlls, accept = jax.jit(batched)(keys, rb, device_data)
    samples = np.asarray(samples)  # (nexp, nchain, nkeep, npar)
    nlls = metropolis.nll_history_to_f64(nlls)

    return _collect_results(fc, mcmc, samples, nlls, verbose)


def _collect_results(fc, mcmc, samples, nll_vals, verbose):
    """(nexp, nchain, nkeep, ...) histories -> lspaces + upper limits."""
    lspaces = []
    limits = []
    for i in range(fc.nexperiments):
        ls = LikelihoodSpace.from_arrays(
            samples[i].reshape(-1, mcmc.nparameters),
            nll_vals[i].reshape(-1),
            mcmc.parameter_names, cl=fc.confidence,
            error_type=fc.error_type)
        lspaces.append(ls)
        if fc.signal_name and fc.signal_name in mcmc.parameter_names:
            bf = ls.get_best_fit()
            limits.append(bf[fc.signal_name].upper)
            if verbose:
                print(f"experiment {i}: {fc.signal_name}: "
                      f"{bf[fc.signal_name]}")
    return lspaces, limits


def _ensemble_setup(fc: FitConfig, nsteps: int):
    """Shared deterministic setup: model, padded read bins, base key.

    Everything here is a pure function of the FitConfig, so a resumed
    run reconstructs identical datasets and read bins.

    Exact-LUT KDE stacks additionally get PER-EXPERIMENT device-data
    extras (event coordinates + precomputed static rows/norms, the
    batched analog of set_data()'s tail arrays): padding rows carry an
    unknown dataset tag, so eval_at's mismatch sentinel zeroes them
    exactly like the -2 read-bin sentinel zeroes binned rows.
    """
    mcmc = MCMC(fc.sources, fc.signals, fc.systematics, fc.observables)

    key = jax.random.PRNGKey(fc.seed)
    datasets = [
        make_fake_dataset(jax.random.fold_in(key, i), fc.signals,
                          fc.systematics, fc.observables, poisson=True,
                          stack=mcmc.stack)
        for i in range(fc.nexperiments)
    ]
    data_batch = pad_datasets(datasets)
    rb = mcmc.stack.compute_read_bins(data_batch)  # (nexp, nsig, nev)

    extras = None
    if getattr(mcmc.stack, "_kde_exact", ()):
        points_b = jnp.asarray(data_batch)
        nev = data_batch.shape[1]

        def one_exp(pts):
            rows, nrms = [], []
            for _, kde in mcmc.stack._kde_exact:
                if not kde.systematics:
                    r, nm = kde.eval_at(pts)
                    rows.append(r)
                    nrms.append(nm)
            return (jnp.stack(rows) if rows
                    else jnp.zeros((0, nev), jnp.float32),
                    jnp.stack(nrms) if nrms
                    else jnp.zeros((0,), jnp.float32))

        static_rows_b, static_norms_b = jax.vmap(one_exp)(points_b)
        extras = (points_b, static_rows_b, static_norms_b)

    nchains = max(fc.nchains, 1)
    burnin_steps = int(nsteps * fc.burnin_fraction)
    return (mcmc, rb, key, nchains, burnin_steps,
            mcmc.stack.device_data, extras)


def _ckpt_file(path: str) -> str:
    return path + ".state.npz"


def _seg_file(path: str, phase: int, seg: int) -> str:
    return f"{path}.p{phase}s{seg}.npz"


def _save_state(path: str, **arrays) -> None:
    # np.savez appends ".npz" when missing, so the tmp name must end
    # with it for the atomic rename to find the file it wrote.
    tmp = _ckpt_file(path) + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, _ckpt_file(path))


def _run_sharded_ensemble_segmented(
    fc: FitConfig, mesh: Mesh, nsteps: int, verbose: bool,
    checkpoint_path: Optional[str], checkpoint_steps: int,
    resume: bool, setup,
) -> Tuple[List[LikelihoodSpace], List[float]]:
    """Segmented batched walk (see module docstring).

    Phase structure matches metropolis._run_single_chain: two burn-in
    phases with a proposal retune after each (from running phase
    moments), then the sampling phase.  The state persists after every
    segment and sampling histories land in sidecar files.  Proposals:
    diagonal widths or full_cov scale_trils (both checkpoint/resume
    exactly)."""
    full_cov = getattr(fc, "proposal", "diagonal") == "full_cov"
    mcmc, rb, key, nchains, burnin_steps, device_data, extras = setup
    if extras is not None:
        raise NotImplementedError(
            "segment checkpointing does not support kde_exact signals "
            "(per-experiment event-coordinate extras are not threaded "
            "through the segment steppers); run without "
            "checkpoint_steps, or use kde_exact=false (grid)")
    nexp = fc.nexperiments
    npar = mcmc.nparameters
    rate_substeps = getattr(fc, "rate_substeps", 0)
    if full_cov and rate_substeps:
        raise ValueError(
            "proposal='full_cov' is incompatible with rate_substeps")

    # Phase plan: (nsteps_in_phase, retune_after)
    remaining = max(nsteps - (2 * burnin_steps if burnin_steps > 0
                              else 0), 1)
    phases = []
    if burnin_steps > 0:
        phases += [(burnin_steps, True), (burnin_steps, True)]
    phases.append((remaining, False))

    state_file = _ckpt_file(checkpoint_path)
    if resume and os.path.exists(state_file):
        st = dict(np.load(state_file))
        params = jnp.asarray(st["params"])
        nll_hi = jnp.asarray(st["nll_hi"])
        nll_lo = jnp.asarray(st["nll_lo"])
        width = jnp.asarray(st["width"])
        phase0 = int(st["phase"])
        done0 = int(st["done"])
        count = jnp.asarray(st["count"])
        psum = jnp.asarray(st["psum"])
        psumsq = jnp.asarray(st["psumsq"]) if "psumsq" in st else None
        pcross = jnp.asarray(st["pcross"]) if "pcross" in st else None
        cref = jnp.asarray(st["cref"]) if "cref" in st else None
    else:
        def init_one(rb_):
            return metropolis.initial_state(mcmc, rb_, device_data)

        p0, n0, w0 = jax.vmap(init_one)(rb)
        params = jnp.broadcast_to(p0[:, None], (nexp, nchains, npar))
        nll_hi = jnp.broadcast_to(n0[0][:, None], (nexp, nchains))
        nll_lo = jnp.broadcast_to(n0[1][:, None], (nexp, nchains))
        if full_cov:
            tril0 = metropolis._initial_scale_tril(mcmc)
            width = jnp.broadcast_to(tril0[None, None],
                                     (nexp, nchains, npar, npar))
        else:
            width = jnp.broadcast_to(w0[:, None], (nexp, nchains, npar))
        phase0, done0 = 0, 0
        count = jnp.zeros((), jnp.float32)
        psum = jnp.zeros((nexp, nchains, npar), jnp.float32)
        psumsq = (None if full_cov else
                  jnp.zeros((nexp, nchains, npar), jnp.float32))
        pcross = (jnp.zeros((nexp, nchains, npar, npar), jnp.float32)
                  if full_cov else None)
        cref = params if full_cov else None

    def _moment_arrays():
        m = dict(count=np.asarray(count), psum=np.asarray(psum))
        if full_cov:
            m["pcross"] = np.asarray(pcross)
            m["cref"] = np.asarray(cref)
        else:
            m["psumsq"] = np.asarray(psumsq)
        return m

    shard = NamedSharding(mesh, P("exp", "chain"))
    rb_s = jax.device_put(rb, NamedSharding(mesh, P("exp")))

    with mesh:
        for phase in range(phase0, len(phases)):
            phase_len, retune_after = phases[phase]
            done = done0 if phase == phase0 else 0
            seg_idx = done // checkpoint_steps
            while done < phase_len:
                seg_len = min(checkpoint_steps, phase_len - done)
                keys = _segment_keys(key, nexp, nchains, phase, seg_idx)
                params = jax.device_put(params, shard)
                nll_pair = (jax.device_put(nll_hi, shard),
                            jax.device_put(nll_lo, shard))
                width = jax.device_put(width, shard)
                keys = jax.device_put(keys, shard)
                params, nll_pair, samples, nlls, _ = _batched_segment(
                    mcmc, params, nll_pair, width, keys, rb_s,
                    device_data, seg_len, fc.debug_mode, rate_substeps,
                    "full_cov" if full_cov else "diagonal")
                nll_hi, nll_lo = nll_pair
                if retune_after:
                    count = count + jnp.float32(seg_len)
                    if full_cov:
                        xc = samples - cref[:, :, None, :]
                        psum = psum + xc.sum(axis=2)
                        pcross = pcross + jnp.einsum(
                            "ecsi,ecsj->ecij", xc, xc,
                            precision=jax.lax.Precision.HIGHEST)
                    else:
                        psum = psum + samples.sum(axis=2)
                        psumsq = psumsq + (samples * samples).sum(axis=2)
                else:
                    np.savez(_seg_file(checkpoint_path, phase, seg_idx),
                             samples=np.asarray(samples),
                             nll_hi=np.asarray(nlls[0]),
                             nll_lo=np.asarray(nlls[1]))
                done += seg_len
                seg_idx += 1
                _save_state(
                    checkpoint_path, params=np.asarray(params),
                    nll_hi=np.asarray(nll_hi),
                    nll_lo=np.asarray(nll_lo),
                    width=np.asarray(width), phase=phase,
                    done=done, **_moment_arrays())
            if retune_after:
                if full_cov:
                    width = _sharded_retune_cov(mcmc, width, count,
                                                psum, pcross)
                    pcross = jnp.zeros_like(pcross)
                    cref = params
                else:
                    width = _sharded_retune(mcmc, width, count, psum,
                                            psumsq)
                    psumsq = jnp.zeros_like(psumsq)
                count = jnp.zeros((), jnp.float32)
                psum = jnp.zeros_like(psum)
                _save_state(
                    checkpoint_path, params=np.asarray(params),
                    nll_hi=np.asarray(nll_hi),
                    nll_lo=np.asarray(nll_lo),
                    width=np.asarray(width), phase=phase + 1,
                    done=0, **_moment_arrays())
            done0 = 0

    # Assemble the sampling-phase history from the persisted segments.
    sampling_phase = len(phases) - 1
    seg_samples, seg_hi, seg_lo = [], [], []
    seg = 0
    while os.path.exists(_seg_file(checkpoint_path, sampling_phase, seg)):
        d = np.load(_seg_file(checkpoint_path, sampling_phase, seg))
        seg_samples.append(d["samples"])
        seg_hi.append(d["nll_hi"])
        seg_lo.append(d["nll_lo"])
        seg += 1
    samples = np.concatenate(seg_samples, axis=2)
    nll_vals = metropolis.nll_history_to_f64(
        (np.concatenate(seg_hi, axis=2), np.concatenate(seg_lo, axis=2)))

    return _collect_results(fc, mcmc, samples, nll_vals, verbose)
