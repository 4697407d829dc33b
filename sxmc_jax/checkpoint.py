"""Chain-level checkpoint / resume.

The reference can only resume at the granularity of a finished
experiment (the ``fit.samples`` file, sxmc.cpp:84-94); mid-chain state
is lost on preemption — unacceptable on preemptible machines.  Here the
Metropolis walk runs in fixed-size segments with the full chain state
(parameters, NLL, jump widths, RNG key, phase, kept samples) persisted
after each segment, so a killed fit resumes exactly where it stopped.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sxmc_jax.mcmc import metropolis
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.stats.likelihood import LikelihoodSpace


def save_chain_state(path: str, state: dict) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **state)
    os.replace(tmp, path)


def load_chain_state(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.keys()}


def _check_burnin(nsteps: int, burnin_steps: int,
                  debug_mode: bool) -> None:
    if burnin_steps > 0 and nsteps <= 2 * burnin_steps \
            and not debug_mode:
        raise ValueError(
            f"nsteps={nsteps} leaves no post-burn-in samples (two "
            f"burn-in phases of {burnin_steps}); lower burnin_fraction "
            f"below 0.5 or raise nsteps")


def run_checkpointed(
    mcmc: MCMC,
    data: np.ndarray,
    nsteps: int,
    burnin_fraction: float = 0.1,
    segment_steps: int = 5000,
    checkpoint_path: str = "chain.ckpt.npz",
    debug_mode: bool = False,
    seed: int = 0,
    verbose: bool = False,
    rate_substeps: int = 0,
    proposal: str = "diagonal",
) -> LikelihoodSpace:
    """Run a single chain with periodic state checkpoints.

    Semantics match MCMC.__call__: two burn-in phases of
    ``nsteps * burnin_fraction`` steps with jump-width retuning, then
    the main phase; only main-phase samples are kept (unless debug).
    ``rate_substeps`` passes through to the blocked stepper; its
    (lut, norms) extras derive from the params, so checkpoint files
    are identical either way.  ``proposal="full_cov"`` checkpoints the
    Haario ``scale_tril`` matrix in place of the width vector.
    """
    if proposal not in ("diagonal", "full_cov"):
        raise ValueError(f"unknown proposal {proposal!r}")
    full_cov = proposal == "full_cov"
    if full_cov and rate_substeps:
        raise ValueError("proposal='full_cov' is incompatible with "
                         "rate_substeps")
    mcmc.stack.set_data(np.asarray(data, np.float32))
    rb = mcmc.stack._read_bins
    dd = mcmc.stack.device_data
    burnin_steps = int(nsteps * burnin_fraction)
    _check_burnin(nsteps, burnin_steps, debug_mode)

    state = load_chain_state(checkpoint_path)
    if state is None:
        params, (nll_hi, nll_lo), width = metropolis.initial_state(
            mcmc, rb, dd)
        if full_cov:
            width = metropolis._initial_scale_tril(mcmc)
        state = {
            "params": np.asarray(params),
            "nll_hi": np.float32(nll_hi), "nll_lo": np.float32(nll_lo),
            "width": np.asarray(width),
            "key": np.asarray(jax.random.PRNGKey(seed)),
            "step": np.int64(0),
            "kept": np.zeros((0, mcmc.nparameters), np.float32),
            "kept_nll": np.zeros((0,), np.float64),
            "phase_samples": np.zeros((0, mcmc.nparameters), np.float32),
        }
    total = int(state["step"])

    phase_bounds = [burnin_steps, 2 * burnin_steps, nsteps] \
        if burnin_steps > 0 else [nsteps]

    while total < nsteps:
        # Which phase are we in, and how far may this segment run?
        bound = next(b for b in phase_bounds if total < b)
        n = min(segment_steps, bound - total)

        key = jnp.asarray(state["key"], jnp.uint32)
        key, seg_key = jax.random.split(key)
        nll_pair = (jnp.asarray(state["nll_hi"]),
                    jnp.asarray(state["nll_lo"]))
        if full_cov:
            params, nll, samples, nlls, acc = \
                metropolis.run_segment_cov(
                    mcmc, jnp.asarray(state["params"]), nll_pair,
                    jnp.asarray(state["width"]), rb, dd, seg_key, n,
                    debug_mode)
        else:
            params, nll, samples, nlls, acc = metropolis.run_segment(
                mcmc, jnp.asarray(state["params"]), nll_pair,
                jnp.asarray(state["width"]),
                rb, dd, seg_key, n, debug_mode, rate_substeps)

        samples = np.asarray(samples)
        nlls = metropolis.nll_history_to_f64(nlls)
        in_burnin = bound != nsteps
        if in_burnin:
            state["phase_samples"] = np.concatenate(
                [state["phase_samples"], samples])
            if debug_mode:
                state["kept"] = np.concatenate([state["kept"], samples])
                state["kept_nll"] = np.concatenate(
                    [state["kept_nll"], nlls])
        else:
            state["kept"] = np.concatenate([state["kept"], samples])
            state["kept_nll"] = np.concatenate([state["kept_nll"], nlls])

        total += n
        width = np.asarray(state["width"])
        if in_burnin and total == bound:
            # Phase end: retune from the phase samples and reset
            # (mcmc.cpp:273-311) — RMS widths, or the Haario
            # covariance Cholesky in full_cov mode.
            retuner = (metropolis.retune_scale_tril if full_cov
                       else metropolis.retune_width)
            width = np.asarray(retuner(
                mcmc, jnp.asarray(width),
                jnp.asarray(state["phase_samples"])))
            state["phase_samples"] = np.zeros(
                (0, mcmc.nparameters), np.float32)

        state.update({
            "params": np.asarray(params),
            "nll_hi": np.float32(nll[0]), "nll_lo": np.float32(nll[1]),
            "width": width, "key": np.asarray(key),
            "step": np.int64(total),
        })
        save_chain_state(checkpoint_path, state)
        if verbose:
            print(f"checkpoint: step {total}/{nsteps} "
                  f"(accept {float(acc):.2f}) -> {checkpoint_path}")

    return LikelihoodSpace.from_arrays(
        state["kept"], state["kept_nll"], mcmc.parameter_names)


def run_checkpointed_stretch(
    sampler,
    data: np.ndarray,
    nsteps: int,
    burnin_fraction: float = 0.1,
    segment_steps: int = 2000,
    checkpoint_path: str = "stretch.ckpt.npz",
    debug_mode: bool = False,
    seed: int = 0,
    verbose: bool = False,
) -> LikelihoodSpace:
    """Stretch (affine-invariant ensemble) sampler with mid-chain
    checkpoints.  Semantics match StretchSampler.__call__ with
    nchains=1: the first ``nsteps * burnin_fraction`` steps are
    discarded, the rest pool all walkers.
    """
    from sxmc_jax.mcmc import stretch as stretch_mod

    sampler.stack.set_data(np.asarray(data, np.float32))
    rb = sampler.stack._read_bins
    dd = sampler.stack.device_data
    burnin = int(nsteps * burnin_fraction)
    npar = sampler.nparameters

    state = load_chain_state(checkpoint_path)
    if state is None:
        key = jax.random.PRNGKey(seed)
        k_init, key = jax.random.split(key)
        walkers, wnll = stretch_mod.initial_walkers(
            sampler, k_init, rb, dd)
        state = {
            "walkers": np.asarray(walkers),
            "wnll_hi": np.asarray(wnll[0]),
            "wnll_lo": np.asarray(wnll[1]),
            "key": np.asarray(key), "step": np.int64(0),
            "kept": np.zeros((0, npar), np.float32),
            "kept_nll": np.zeros((0,), np.float64),
        }
    total = int(state["step"])

    while total < nsteps:
        n = min(segment_steps, nsteps - total)
        key = jnp.asarray(state["key"], jnp.uint32)
        key, seg_key = jax.random.split(key)
        carry, (hist, hist_nll, acc) = stretch_mod.stretch_segment(
            sampler, jnp.asarray(state["walkers"]),
            (jnp.asarray(state["wnll_hi"]),
             jnp.asarray(state["wnll_lo"])),
            rb, dd, seg_key, n, debug_mode)
        walkers, wnll = carry

        # Keep only post-burn-in steps of this segment, pooled over
        # walkers.
        first_kept = max(burnin - total, 0)
        if first_kept < n:
            kept = np.asarray(hist[first_kept:]).reshape(-1, npar)
            kn = metropolis.nll_history_to_f64(
                (hist_nll[0][first_kept:], hist_nll[1][first_kept:])
            ).reshape(-1)
            state["kept"] = np.concatenate([state["kept"], kept])
            state["kept_nll"] = np.concatenate([state["kept_nll"], kn])

        total += n
        state.update({
            "walkers": np.asarray(walkers),
            "wnll_hi": np.asarray(wnll[0]),
            "wnll_lo": np.asarray(wnll[1]),
            "key": np.asarray(key), "step": np.int64(total),
        })
        save_chain_state(checkpoint_path, state)
        if verbose:
            print(f"checkpoint(stretch): step {total}/{nsteps} "
                  f"(accept {float(acc):.2f}) -> {checkpoint_path}")

    sampler.last_accept_rate = float("nan")
    return LikelihoodSpace.from_arrays(
        state["kept"], state["kept_nll"], sampler.parameter_names)


def run_checkpointed_hmc(
    hmc,
    data: np.ndarray,
    nsteps: int,
    burnin_fraction: float = 0.1,
    segment_steps: int = 2000,
    checkpoint_path: str = "hmc.ckpt.npz",
    seed: int = 0,
    verbose: bool = False,
) -> LikelihoodSpace:
    """HMC/NUTS with periodic state checkpoints.

    Semantics match HMC.__call__ (sxmc_jax.mcmc.hmc): a dual-averaging
    warmup phase followed by sampling at the adapted (step size, mass).
    Both phases run in explicit-carry segments (warmup_segment /
    main_segment of the sampler's module), so preemption loses at most
    one segment.  Pass a NUTS instance to checkpoint NUTS chains —
    the same machinery dispatches on the sampler type.
    """
    from sxmc_jax.mcmc import hmc as hmc_base
    from sxmc_jax.mcmc import nuts as nuts_mod

    if isinstance(hmc, nuts_mod.NUTS):
        hmc_mod = nuts_mod
        seg_args = (hmc.max_depth, hmc.target_accept)
    else:
        hmc_mod = hmc_base
        seg_args = (hmc.num_leapfrog, hmc.target_accept)

    hmc.stack.set_data(np.asarray(data, np.float32))
    rb = hmc.stack._read_bins
    dd = hmc.stack.device_data
    warmup = max(int(nsteps * burnin_fraction), 10)
    keep = max(nsteps - warmup, 1)
    total = warmup + keep
    npar = hmc.nparameters

    state = load_chain_state(checkpoint_path)
    if state is None:
        q, u, le, leb, hb, t = hmc_mod.initial_warm_carry(
            hmc, rb, dd, *seg_args)
        state = {
            "q": np.asarray(q), "u": np.float32(u),
            "log_eps": np.float32(le), "log_eps_bar": np.float32(leb),
            "h_bar": np.float32(hb), "t": np.float32(t),
            "eps": np.float32(0.0), "inv_mass": np.zeros(npar, np.float32),
            "key": np.asarray(jax.random.PRNGKey(seed)),
            "step": np.int64(0),
            "warm_qs": np.zeros((0, npar), np.float32),
            "kept": np.zeros((0, npar), np.float32),
            "kept_nll": np.zeros((0,), np.float32),
        }
    total_done = int(state["step"])

    while total_done < total:
        in_warm = total_done < warmup
        bound = warmup if in_warm else total
        n = min(segment_steps, bound - total_done)

        key = jnp.asarray(state["key"], jnp.uint32)
        key, seg_key = jax.random.split(key)
        if in_warm:
            carry = (jnp.asarray(state["q"]), jnp.asarray(state["u"]),
                     jnp.asarray(state["log_eps"]),
                     jnp.asarray(state["log_eps_bar"]),
                     jnp.asarray(state["h_bar"]), jnp.asarray(state["t"]))
            carry, warm_qs = hmc_mod.warmup_segment(
                hmc, carry, rb, dd, seg_key, n, *seg_args)
            q, u, le, leb, hb, t = carry
            state.update({
                "q": np.asarray(q), "u": np.float32(u),
                "log_eps": np.float32(le), "log_eps_bar": np.float32(leb),
                "h_bar": np.float32(hb), "t": np.float32(t),
                "warm_qs": np.concatenate(
                    [state["warm_qs"], np.asarray(warm_qs)]),
            })
            if total_done + n == warmup:
                state["eps"] = np.float32(np.exp(state["log_eps_bar"]))
                state["inv_mass"] = np.asarray(hmc_base.mass_from_warmup(
                    hmc, jnp.asarray(state["warm_qs"])))
        else:
            (q, u), (samples, nlls, _) = hmc_mod.main_segment(
                hmc, jnp.asarray(state["q"]), jnp.asarray(state["u"]),
                jnp.asarray(state["eps"]),
                jnp.asarray(state["inv_mass"]), rb, dd, seg_key, n,
                seg_args[0])
            state.update({
                "q": np.asarray(q), "u": np.float32(u),
                "kept": np.concatenate(
                    [state["kept"], np.asarray(samples)]),
                "kept_nll": np.concatenate(
                    [state["kept_nll"], np.asarray(nlls)]),
            })

        total_done += n
        state.update({"key": np.asarray(key), "step": np.int64(total_done)})
        save_chain_state(checkpoint_path, state)
        if verbose:
            phase = "warmup" if in_warm else "sample"
            print(f"checkpoint(hmc): {phase} {total_done}/{total} "
                  f"-> {checkpoint_path}")

    return LikelihoodSpace.from_arrays(
        state["kept"], state["kept_nll"], hmc.parameter_names)


def run_checkpointed_tempered(
    sampler,
    data: np.ndarray,
    nsteps: int,
    burnin_fraction: float = 0.1,
    segment_steps: int = 5000,
    checkpoint_path: str = "chain.ckpt.npz",
    debug_mode: bool = False,
    seed: int = 0,
    verbose: bool = False,
) -> LikelihoodSpace:
    """Mid-run checkpointing for the parallel-tempered sampler.

    ``sampler`` is a :class:`sxmc_jax.mcmc.tempered.TemperedMCMC`.  The
    persisted state is the full ladder (per-replica params, compensated
    NLL pairs, widths) plus the global step index — the index drives
    the swap cadence and pairing parity, so a resumed run swaps on
    exactly the schedule the uninterrupted run would have.
    """
    from sxmc_jax.mcmc import tempered as tempered_mod

    mcmc = sampler.mcmc
    betas = tuple(float(b) for b in sampler.betas)
    ntemps = len(betas)
    sampler.stack.set_data(np.asarray(data, np.float32))
    rb = sampler.stack._read_bins
    dd = sampler.stack.device_data
    burnin_steps = int(nsteps * burnin_fraction)
    _check_burnin(nsteps, burnin_steps, debug_mode)
    npar = mcmc.nparameters

    state = load_chain_state(checkpoint_path)
    if state is None:
        params = np.broadcast_to(mcmc.parameter_means,
                                 (ntemps, npar)).copy()
        width = np.broadcast_to(mcmc.initial_jump_widths(),
                                (ntemps, npar)).copy()
        batch_nll = metropolis._chain_nll_batch(mcmc, rb, dd, ntemps)
        hi, lo = batch_nll(jnp.asarray(params))
        state = {
            "params": params.astype(np.float32),
            "nll_hi": np.asarray(hi, np.float32),
            "nll_lo": np.asarray(lo, np.float32),
            "width": width.astype(np.float32),
            "key": np.asarray(jax.random.PRNGKey(seed)),
            "step": np.int64(0),
            "kept": np.zeros((0, npar), np.float32),
            "kept_nll": np.zeros((0,), np.float64),
            "phase_samples": np.zeros((0, npar), np.float32),
        }
    total = int(state["step"])

    phase_bounds = [burnin_steps, 2 * burnin_steps, nsteps] \
        if burnin_steps > 0 else [nsteps]
    sf = metropolis.HAARIO / max(mcmc.nfloat, 1)

    while total < nsteps:
        bound = next(b for b in phase_bounds if total < b)
        n = min(segment_steps, bound - total)

        key = jnp.asarray(state["key"], jnp.uint32)
        key, seg_key = jax.random.split(key)
        params, nll, istep, samples, nlls, acc, swap = \
            tempered_mod.tempered_segment(
                mcmc, jnp.asarray(state["params"]),
                (jnp.asarray(state["nll_hi"]),
                 jnp.asarray(state["nll_lo"])),
                jnp.asarray(state["width"]),
                jnp.int32(total), rb, dd, seg_key, n, debug_mode,
                betas, sampler.swap_every)

        samples = np.asarray(samples)
        nlls = metropolis.nll_history_to_f64(nlls)
        in_burnin = bound != nsteps
        if in_burnin:
            state["phase_samples"] = np.concatenate(
                [state["phase_samples"], samples])
            if debug_mode:
                state["kept"] = np.concatenate([state["kept"], samples])
                state["kept_nll"] = np.concatenate(
                    [state["kept_nll"], nlls])
        else:
            state["kept"] = np.concatenate([state["kept"], samples])
            state["kept_nll"] = np.concatenate([state["kept_nll"], nlls])

        total += n
        width = np.asarray(state["width"])
        if in_burnin and total == bound:
            # Cold-chain RMS retune shared down the ladder (same rule
            # as _run_tempered).
            rms = state["phase_samples"].std(axis=0)
            new = np.where(rms > 0, sf * rms, width)
            width = np.where(mcmc.parameter_fixed[None, :], -1.0,
                             new).astype(np.float32)
            state["phase_samples"] = np.zeros((0, npar), np.float32)

        state.update({
            "params": np.asarray(params, np.float32),
            "nll_hi": np.asarray(nll[0], np.float32),
            "nll_lo": np.asarray(nll[1], np.float32),
            "width": width, "key": np.asarray(key),
            "step": np.int64(total),
        })
        save_chain_state(checkpoint_path, state)
        if verbose:
            print(f"checkpoint(tempered): step {total}/{nsteps} "
                  f"(accept {float(acc):.2f}, swap {float(swap):.2f}) "
                  f"-> {checkpoint_path}")

    return LikelihoodSpace.from_arrays(
        state["kept"], state["kept_nll"], mcmc.parameter_names)
