"""Parallel-tempered (replica-exchange) Metropolis.

A ladder of ``ntemps`` replicas samples the posterior annealed by
inverse temperatures beta_k (beta_0 = 1 is the physical posterior;
hotter replicas see a flattened landscape and cross likelihood barriers
freely).  Adjacent replicas periodically propose state swaps with the
detailed-balance probability

    min(1, exp((beta_i - beta_j) * (NLL_i - NLL_j)))

so mode-hopping moves discovered by hot replicas propagate down to the
cold chain.  Only the cold chain's samples are returned.

This is impossible in the reference (single serial chain,
mcmc.cpp:261-378) and a natural fit for the batched machinery: the
ladder advances in LOCK-STEP, so every step's ``ntemps`` PDF rebuilds
are one batched (temps x signals) rebuild (PdfStack.evaluate_batch).

Proposal widths scale as 1/sqrt(beta) (the annealed posterior is
~1/beta wider), and each replica retunes from its own burn-in RMS like
the plain sampler (mcmc.cpp:273-311 semantics, per temperature).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sxmc_jax.mcmc import metropolis
from sxmc_jax.mcmc.metropolis import MCMC, HAARIO
from sxmc_jax.ops.nll import df_diff, nll_pair as nll_pair_fn
from sxmc_jax.signal import Observable, Signal, Source, Systematic
from sxmc_jax.stats.likelihood import LikelihoodSpace


def temperature_ladder(ntemps: int, tmax: float) -> np.ndarray:
    """Geometric inverse-temperature ladder: beta_0 = 1 .. 1/tmax."""
    if ntemps == 1:
        return np.ones(1, np.float32)
    return np.asarray(
        tmax ** (-np.arange(ntemps) / (ntemps - 1)), np.float32)


class TemperedMCMC:
    """Replica-exchange wrapper around the Metropolis machinery.

    Same constructor and call signature as :class:`MCMC`, plus the
    ladder geometry.  ``__call__`` returns the cold chain's likelihood
    space; ``last_swap_rate`` records the mean swap acceptance.
    """

    def __init__(
        self,
        sources: Sequence[Source],
        signals: Sequence[Signal],
        systematics: Sequence[Systematic],
        observables: Sequence[Observable],
        ntemps: int = 8,
        tmax: float = 32.0,
        swap_every: int = 10,
        binned: bool = False,
    ):
        self.mcmc = MCMC(sources, signals, systematics, observables,
                         binned=binned)
        self.ntemps = int(ntemps)
        self.tmax = float(tmax)
        self.swap_every = int(swap_every)
        self.betas = temperature_ladder(self.ntemps, self.tmax)
        # Delegate fit metadata.
        self.stack = self.mcmc.stack
        self.nparameters = self.mcmc.nparameters
        self.nsources = self.mcmc.nsources
        self.parameter_names = self.mcmc.parameter_names
        self.static = self.mcmc.static

    def __call__(
        self,
        data: np.ndarray,
        nsteps: int,
        burnin_fraction: float = 0.1,
        debug_mode: bool = False,
        seed: int = 0,
        nchains: int = 1,  # accepted for driver compat; ladder != chains
        key: Optional[jax.Array] = None,
    ) -> LikelihoodSpace:
        self.stack.set_data(np.asarray(data, np.float32))
        burnin_steps = int(nsteps * burnin_fraction)
        if burnin_steps > 0 and nsteps <= 2 * burnin_steps \
                and not debug_mode:
            raise ValueError(
                f"nsteps={nsteps} leaves no post-burn-in samples "
                f"(two burn-in phases of {burnin_steps}); lower "
                f"burnin_fraction below 0.5 or raise nsteps")
        if key is None:
            key = jax.random.PRNGKey(seed)

        samples, nlls, accept, swap = _run_tempered(
            self.mcmc, key, self.stack._read_bins,
            self.stack.device_data, nsteps, burnin_steps, debug_mode,
            tuple(float(b) for b in self.betas), self.swap_every)

        self.last_accept_rate = float(np.asarray(accept).mean())
        self.last_swap_rate = float(np.asarray(swap))
        cold = np.asarray(samples)  # (nkeep, nparams) already cold-only
        nll64 = metropolis.nll_history_to_f64(nlls)
        return LikelihoodSpace.from_arrays(
            cold.reshape(-1, self.nparameters), nll64.reshape(-1),
            self.parameter_names)


def _make_tempered_step(mcmc: MCMC, read_bins, device_data,
                        debug_mode: bool, betas, swap_every: int):
    """Step closure over carry (params, (hi, lo), width, istep)."""
    ntemps = len(betas)
    beta = jnp.asarray(betas, jnp.float32)
    batch_nll = metropolis._chain_nll_batch(mcmc, read_bins,
                                            device_data, ntemps)

    # Precomputed swap partners for the two alternating pairings
    # (numpy: embeds as constants).  Pairing 0: (0,1)(2,3)...; pairing
    # 1: (1,2)(3,4)... with the boundary replicas unpaired.
    idx = np.arange(ntemps)
    p0 = idx ^ 1
    p0[p0 >= ntemps] = idx[p0 >= ntemps]
    p1 = np.where(idx == 0, 0, ((idx - 1) ^ 1) + 1)
    p1[p1 >= ntemps] = idx[p1 >= ntemps]
    if ntemps == 2:
        # Only one adjacent pair exists: the odd pairing would attempt
        # nothing (halving both the swap cadence and the reported
        # rate), so both parities use the (0,1) pairing.
        p1 = p0
    partners = jnp.asarray(np.stack([p0, p1]), jnp.int32)

    def step(carry, xs):
        params, (cur_hi, cur_lo), width, istep = carry
        keys_c, k_swap = xs
        kp = keys_c[:, 0]
        ka = keys_c[:, 1]
        # --- per-replica Metropolis move (annealed accept) -----------
        noise = jax.vmap(
            lambda k, p: jax.random.normal(k, p.shape))(kp, params)
        # Hot replicas walk wider: the beta-annealed posterior scales
        # ~1/sqrt(beta) in every direction.
        noise = noise * jnp.maximum(width, 0.0) / jnp.sqrt(
            beta)[:, None]
        proposed = jnp.where(width > 0, params + noise, params)
        prop_hi, prop_lo = batch_nll(proposed)
        u = jax.vmap(lambda k: jax.random.uniform(k, ()))(ka)
        delta = beta * df_diff(cur_hi, cur_lo, prop_hi, prop_lo)
        accept = debug_mode | (delta > 0) | (u <= jnp.exp(delta))
        params = jnp.where(accept[:, None], proposed, params)
        cur_hi = jnp.where(accept, prop_hi, cur_hi)
        cur_lo = jnp.where(accept, prop_lo, cur_lo)

        # --- replica exchange (masked; every swap_every steps) --------
        do_swap = (istep % swap_every) == (swap_every - 1)
        pairing = (istep // swap_every) % 2
        partner = partners[pairing]
        # One uniform per PAIR: key on the lower index of the pair.
        pair_u = jax.random.uniform(k_swap, (ntemps,))
        low = jnp.minimum(jnp.arange(ntemps), partner)
        u_pair = pair_u[low]
        nll_d = df_diff(cur_hi, cur_lo, cur_hi[partner],
                        cur_lo[partner])
        log_a = (beta - beta[partner]) * nll_d
        ok = (partner != jnp.arange(ntemps)) & do_swap & (
            (log_a >= 0) | (u_pair <= jnp.exp(log_a)))
        swapped = jnp.where(ok[:, None], params[partner], params)
        sw_hi = jnp.where(ok, cur_hi[partner], cur_hi)
        sw_lo = jnp.where(ok, cur_lo[partner], cur_lo)
        # Count each accepted pair once (at its lower index).
        nswaps = (ok & (jnp.arange(ntemps) < partner)).sum()
        npairs = jnp.maximum(
            (partners[pairing] > jnp.arange(ntemps)).sum(), 1)
        swap_frac = jnp.where(do_swap,
                              nswaps.astype(jnp.float32) / npairs, 0.0)

        out = (swapped[0], (sw_hi[0], sw_lo[0]),
               accept[0].astype(jnp.float32),
               (swap_frac, do_swap.astype(jnp.float32)))
        return ((swapped, (sw_hi, sw_lo), width, istep + 1), out)

    def phase_keys(k, n):
        ks = jax.random.split(k, n * (2 * ntemps + 1))
        ks = ks.reshape(n, 2 * ntemps + 1, -1)
        return ks[:, :2 * ntemps].reshape(n, ntemps, 2, -1), ks[:, -1]

    return step, phase_keys, batch_nll


@functools.partial(
    jax.jit,
    static_argnames=("mcmc", "nsteps", "debug_mode", "betas",
                     "swap_every"))
def tempered_segment(mcmc: MCMC, params, cur_nll, width, istep,
                     read_bins, device_data, key, nsteps: int,
                     debug_mode: bool, betas, swap_every: int):
    """Run one fixed-width tempered segment from explicit ladder state.

    Mirrors metropolis.run_segment for checkpointing: the full carry
    (per-replica params, compensated NLL pairs, widths, global step
    index — the step index drives the swap cadence and pairing parity)
    is explicit, so a killed run resumes exactly.
    Returns (params, nll, istep, cold samples, cold nlls, accept,
    swap_rate).
    """
    step, phase_keys, _ = _make_tempered_step(
        mcmc, read_bins, device_data, debug_mode, betas, swap_every)
    carry = (params, cur_nll, width, istep)
    carry, (samples, nlls, accepts, (fr, att)) = jax.lax.scan(
        step, carry, phase_keys(key, nsteps))
    swap_rate = fr.sum() / jnp.maximum(att.sum(), 1.0)
    return (carry[0], carry[1], carry[3], samples, nlls,
            accepts.mean(), swap_rate)


@functools.partial(
    jax.jit,
    static_argnames=("mcmc", "nsteps", "burnin_steps", "debug_mode",
                     "betas", "swap_every"))
def _run_tempered(mcmc: MCMC, key, read_bins, device_data, nsteps: int,
                  burnin_steps: int, debug_mode: bool, betas,
                  swap_every: int):
    """Lock-step tempered walk; returns cold-chain history.

    History: (samples, (nll_hi, nll_lo), accept, swap_rate) with
    samples/nlls the COLD replica's post-step state per recorded step.
    """
    ntemps = len(betas)
    fixed = jnp.asarray(mcmc.parameter_fixed)
    sf = HAARIO / max(mcmc.nfloat, 1)
    step, phase_keys, batch_nll = _make_tempered_step(
        mcmc, read_bins, device_data, debug_mode, betas, swap_every)

    def run_phase(carry, k, n):
        return jax.lax.scan(step, carry, phase_keys(k, n))

    def retune(width, cold_samples):
        # Every replica shares the COLD chain's RMS scale (hot replicas
        # get the additional 1/sqrt(beta) factor in the step); this
        # keeps the ladder's proposal geometry aligned with the
        # physical posterior the way mcmc.cpp:279-305 does for one
        # chain.
        rms = jnp.std(cold_samples, axis=0)
        new = jnp.where(rms > 0, sf * rms, width)
        return jnp.where(fixed[None, :], -1.0,
                         jnp.broadcast_to(new, width.shape))

    params0 = jnp.broadcast_to(
        jnp.asarray(mcmc.parameter_means, jnp.float32),
        (ntemps, mcmc.nparameters))
    nll0 = batch_nll(params0)
    width0 = jnp.broadcast_to(jnp.asarray(mcmc.initial_jump_widths()),
                              (ntemps, mcmc.nparameters))
    carry = (params0, nll0, width0, jnp.int32(0))

    k1, k2, k3 = jax.random.split(key, 3)
    outs = []
    if burnin_steps > 0:
        carry, (s1, n1, a1, w1) = run_phase(carry, k1, burnin_steps)
        p, c, w, i = carry
        carry = (p, c, retune(w, s1), i)
        carry, (s2, n2, a2, w2) = run_phase(carry, k2, burnin_steps)
        p, c, w, i = carry
        carry = (p, c, retune(w, s2), i)
        if debug_mode:
            outs += [(s1, n1, a1, w1), (s2, n2, a2, w2)]

    remaining = max(nsteps - (2 * burnin_steps if burnin_steps > 0
                              else 0), 0)
    if remaining > 0:
        carry, (s3, n3, a3, w3) = run_phase(carry, k3, remaining)
        outs.append((s3, n3, a3, w3))

    samples = jnp.concatenate([o[0] for o in outs], axis=0)
    nlls = (jnp.concatenate([o[1][0] for o in outs], axis=0),
            jnp.concatenate([o[1][1] for o in outs], axis=0))
    accepts = jnp.concatenate([o[2] for o in outs], axis=0)
    swap_fracs = jnp.concatenate([o[3][0] for o in outs], axis=0)
    attempts = jnp.concatenate([o[3][1] for o in outs], axis=0)
    # Mean swap acceptance over steps where swaps were attempted.
    swap_rate = swap_fracs.sum() / jnp.maximum(attempts.sum(), 1.0)
    return samples, nlls, accepts.mean(), swap_rate
