"""Adaptive Metropolis MCMC, fully device-resident.

JAX re-design of reference src/mcmc.{h,cpp} + the step kernels in
src/nll_kernels.cpp:191-271.  The reference keeps the chain on the GPU
with a ring buffer flushed to a host ntuple every 10k steps
(mcmc.cpp:350-377); here the whole walk is a ``jax.lax.scan`` inside one
jit — the chain history is the scan output, and there is no host
round-trip at all.  ``vmap`` over chains gives vectorized Metropolis
ensembles; the same function pjit-shards over a device mesh.

Semantics preserved:
  * parameter vector = source rates then systematic coefficients, with
    means/sigmas/fixed flattened identically (mcmc.cpp:47-81);
  * initial jump widths 0.1 * width * (2.4^2 / nfloat) with the same
    per-parameter width heuristic (mcmc.cpp:197-228, Haario 2001);
  * proposals are independent Gaussians per parameter; fixed parameters
    are pinned (jump width -1, nll_kernels.cpp:38-52);
  * Metropolis accept: np < nc or u <= exp(nc - np); debug mode accepts
    everything (nll_kernels.cpp:66-77);
  * PDFs are re-histogrammed every step iff any systematic floats
    (mcmc.cpp:264-271);
  * jump widths retuned from the sample RMS at burnin_steps and
    2*burnin_steps, discarding prior samples unless debug
    (mcmc.cpp:273-311).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sxmc_jax.ops.nll import (NLLStatic, binned_nll_pair, df_diff,
                              nll as nll_fn, nll_pair as nll_pair_fn)
from sxmc_jax.pdf.stack import PdfStack
from sxmc_jax.signal import Observable, Signal, Source, Systematic
from sxmc_jax.stats.likelihood import LikelihoodSpace

HAARIO = 2.4 * 2.4  # Haario et al. 2001 proposal scaling (mcmc.cpp:199)


def nll_history_to_f64(nll_pair_hist) -> np.ndarray:
    """Chain NLL history (hi, lo) pair -> f64 values on the host.

    The chain carries the NLL as compensated f32 pairs (the f32
    stand-in for the reference's double accumulators); summing the
    parts in host f64 recovers the full ~48-bit precision, so interval
    dNLL cuts stay exact even when |NLL| ~ 10^7.
    """
    hi, lo = nll_pair_hist
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


class MCMC:
    """MCMC fit driver (reference: mcmc.h:41-77)."""

    def __init__(
        self,
        sources: Sequence[Source],
        signals: Sequence[Signal],
        systematics: Sequence[Systematic],
        observables: Sequence[Observable],
        binned: bool = False,
    ):
        """``binned=True`` switches every NLL evaluation to the exact
        binned regrouping (ops.nll.binned_nll_pair): with histogram
        PDFs the unbinned extended likelihood is ALGEBRAICALLY equal
        to the binned one, and the per-step event term drops from
        O(nevents * nsignals) to O(ndatasets * nbins) — the lever at
        the 10^7-event scale.  A constructor flag (not a __call__
        kwarg) on purpose: the jitted runners key their trace cache on
        the MCMC object, so the mode must be immutable per instance.
        """
        self.binned = bool(binned)
        self.nsources = len(sources)
        self.nsignals = len(signals)
        self.sources = list(sources)
        self.signals = list(signals)
        self.systematics = list(systematics)
        self.observables = list(observables)

        npars_syst = sum(s.npars for s in systematics)
        self.nparameters = self.nsources + npars_syst

        means = np.zeros(self.nparameters, np.float32)
        sigmas = np.zeros(self.nparameters, np.float32)
        fixed = np.zeros(self.nparameters, bool)
        names = []
        for i, src in enumerate(sources):
            means[i], sigmas[i], fixed[i] = src.mean, src.sigma, src.fixed
            names.append(src.name)
        k = self.nsources
        self.systematics_fixed = True
        for syst in systematics:
            if not syst.fixed:
                self.systematics_fixed = False
            for j in range(syst.npars):
                means[k], sigmas[k] = syst.means[j], syst.sigmas[j]
                fixed[k] = syst.fixed
                names.append(f"{syst.name}_{j}")
                k += 1
        self.parameter_means = means
        self.parameter_sigma = sigmas
        self.parameter_fixed = fixed
        self.parameter_names = names
        self.nfloat = int((~fixed).sum())
        self.nsystematics = len(systematics)

        self.stack = PdfStack(signals, observables, systematics)
        if self.binned and getattr(self.stack, "_kde_exact", ()):
            raise ValueError(
                "binned likelihood is incompatible with exact-LUT KDE "
                "signals (their density lives at the event positions, "
                "not on the bin grid); drop kde_exact or run unbinned")
        # NLLStatic holds HOST (numpy) arrays on purpose: they embed as
        # true XLA constants when closed over in jit.
        self.static = NLLStatic(
            nexpected=np.asarray([s.nexpected for s in signals],
                                 np.float32),
            n_mc=np.asarray([s.n_mc for s in signals], np.float32),
            source_id=np.asarray([s.source.index for s in signals],
                                 np.int32),
            means=np.asarray(means),
            sigmas=np.asarray(sigmas),
            nsources=self.nsources,
        )

    # ------------------------------------------------------------------

    def initial_jump_widths(self) -> np.ndarray:
        """0.1 * width * 2.4^2/nfloat; fixed -> -1 (mcmc.cpp:197-228)."""
        sf = HAARIO / max(self.nfloat, 1)
        w = np.empty(self.nparameters, np.float32)
        for i in range(self.nparameters):
            if self.parameter_fixed[i]:
                w[i] = -1.0
                continue
            mean = self.parameter_means[i]
            sigma = self.parameter_sigma[i]
            if sigma > 0:
                width = sigma
            elif i < self.nsources:
                m = max(mean, 10.0)
                width = np.sqrt(m) / m
            else:
                width = np.sqrt(max(mean, 1.0))
            w[i] = 0.1 * width * sf
        return w

    # ------------------------------------------------------------------

    def __call__(
        self,
        data: np.ndarray,
        nsteps: int,
        burnin_fraction: float = 0.1,
        debug_mode: bool = False,
        seed: int = 0,
        nchains: int = 1,
        key: Optional[jax.Array] = None,
        pool_adaptation: bool = False,
        rate_substeps: int = 0,
        proposal: str = "diagonal",
    ) -> LikelihoodSpace:
        """Run the random walk; returns the likelihood space.

        ``data`` is ``(nevents, nobservables + 1)`` with dataset tags.
        With ``nchains > 1`` independent chains run vmapped and their
        post-burn-in samples are pooled.  ``pool_adaptation`` pools the
        burn-in jump-width retuning statistics ACROSS chains (the
        cross-chain ``pmean`` pattern of SURVEY.md section 5): every
        chain then walks with identical, better-estimated widths, at the
        price of a barrier between burn-in phases.

        ``rate_substeps > 0`` enables blocked Metropolis-within-Gibbs
        updates: each recorded step is one systematic-block move (PDF
        rebuild — the per-step throughput wall, mcmc.cpp:264-271)
        followed by that many rate-block moves that reuse the carried
        LUT at zero rebuild cost.  Same posterior, ~(1 + substeps) x
        more parameter updates per rebuild.  ``nsteps`` then counts
        recorded cycles.

        ``proposal="full_cov"`` switches to Haario full-covariance
        adaptive proposals (correlated Gaussian moves from the burn-in
        sample covariance) — dramatically better mixing on
        anticorrelated rate posteriors; incompatible with
        ``rate_substeps`` and ``pool_adaptation``.
        """
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
        chain_keys = jax.random.split(key, nchains)

        if proposal not in ("diagonal", "full_cov"):
            raise ValueError(f"unknown proposal {proposal!r}")
        if proposal == "full_cov":
            if rate_substeps or pool_adaptation:
                raise ValueError(
                    "proposal='full_cov' is incompatible with "
                    "rate_substeps / pool_adaptation")
            runner = _run_chains_fullcov
        elif pool_adaptation and nchains > 1:
            runner = _run_chains_pooled
        elif nchains > 1:
            # Lock-step chains: the nchains PDF rebuilds of each step
            # are one batched (chains x signals) rebuild.
            runner = _run_chains_batched
        else:
            runner = _run_chains
        samples, nlls, accept_rate = runner(
            self, chain_keys, self.stack._read_bins,
            self.stack.device_data, nsteps, burnin_steps, debug_mode,
            rate_substeps=rate_substeps)

        # Pool chains: (nchains, nkeep, npar) -> (nchains * nkeep, npar).
        samples = np.asarray(samples).reshape(-1, self.nparameters)
        nlls = nll_history_to_f64(nlls).reshape(-1)
        self.last_accept_rate = float(np.mean(np.asarray(accept_rate)))
        return LikelihoodSpace.from_arrays(
            samples, nlls, self.parameter_names)

    def nll(self, data: np.ndarray, params) -> float:
        """Standalone NLL evaluation (reference: mcmc.cpp:390-415)."""
        self.stack.set_data(np.asarray(data, np.float32))
        params = jnp.asarray(params, jnp.float32)
        lut, norms = self.stack.evaluate(params[self.nsources:],
                                         use_exact_kde=True)
        return float(nll_fn(params, lut, norms, self.static))

    @property
    def device_data(self):
        return self.stack.device_data


# ----------------------------------------------------------------------
# jitted chain runner


@functools.partial(
    jax.jit,
    static_argnames=("mcmc", "nsteps", "debug_mode", "rate_substeps"))
def run_segment(mcmc: MCMC, params, cur_nll, width, read_bins,
                device_data, key, nsteps: int, debug_mode: bool = False,
                rate_substeps: int = 0):
    """Run one fixed-width chain segment; returns carry + history.

    ``cur_nll`` and the returned NLL history are compensated (hi, lo)
    f32 pairs (see :func:`nll_history_to_f64`).

    Building block for mid-chain checkpointing (sxmc_jax.checkpoint):
    the chain state (params, nll, width, key) is explicit, so a killed
    run resumes exactly where the last segment ended — a capability the
    reference lacks entirely (SURVEY.md section 5, checkpoint/resume).
    With ``rate_substeps > 0`` the blocked stepper's (lut, norms) extras
    are reconstructed from ``params`` at segment start, so checkpoint
    state is identical for both modes.
    """
    step, init_extras, m = _make_stepper(mcmc, read_bins, device_data,
                                         debug_mode, rate_substeps)
    keys = jax.random.split(key, nsteps)
    xs = _presample(keys, mcmc.nparameters, m)
    carry = (params, cur_nll, width) + tuple(init_extras(params))
    carry, (samples, nlls, accepts) = jax.lax.scan(step, carry, xs)
    params, cur_nll = carry[0], carry[1]
    return params, cur_nll, samples, nlls, accepts.mean()


@functools.partial(jax.jit, static_argnames=("mcmc",))
def initial_state(mcmc: MCMC, read_bins, device_data):
    """Initial (params, nll_pair, width) for a chain."""
    params0 = jnp.asarray(mcmc.parameter_means, jnp.float32)
    nll0 = _chain_nll(mcmc, read_bins, device_data)(params0)
    width0 = jnp.asarray(mcmc.initial_jump_widths())
    return params0, nll0, width0


def retune_width(mcmc: MCMC, width, phase_samples):
    """Jump-width rescale from a burn-in phase (mcmc.cpp:279-305)."""
    sf = HAARIO / max(mcmc.nfloat, 1)
    fixed = jnp.asarray(mcmc.parameter_fixed)
    rms = jnp.std(phase_samples, axis=0)
    new = jnp.where(rms > 0, sf * rms, width)
    return jnp.where(fixed, -1.0, new)


def _nll_backend(mcmc: MCMC, read_bins, device_data):
    """Likelihood-mode dispatch shared by every sampler.

    Returns ``(evaluate, evaluate_batch, pair)``:
      * ``evaluate(theta) -> (lutlike, norms)`` — the theta-dependent
        PDF state (the per-event LUT, or the raw histograms in binned
        mode);
      * ``evaluate_batch(thetas)`` — its batched multi-chain form;
      * ``pair(params, lutlike, norms, st) -> (hi, lo)`` — the
        compensated NLL from that state.

    In binned mode the per-dataset data counts are derived from
    ``read_bins`` inside the trace (PdfStack.counts_from_read_bins),
    so callers thread exactly the same arguments either way and the
    blocked/checkpoint steppers carry ``(lutlike, norms)`` unchanged.
    """
    stack = mcmc.stack
    if not getattr(mcmc, "binned", False):
        def evaluate(theta):
            return stack.evaluate(theta, read_bins, device_data,
                                  use_exact_kde=True)

        def evaluate_batch(thetas):
            return stack.evaluate_batch(thetas, read_bins, device_data,
                                        use_exact_kde=True)

        return evaluate, evaluate_batch, nll_pair_fn

    counts = stack.counts_from_read_bins(read_bins)
    mask = stack.dataset_mask
    bv = stack.bin_volume

    def evaluate(theta):
        return stack.histograms(theta, device_data)

    def evaluate_batch(thetas):
        return stack.histograms_batch(thetas, device_data)

    def pair(params, hists, norms, st):
        return binned_nll_pair(params, hists, norms, st, counts, mask,
                               bv)

    return evaluate, evaluate_batch, pair


def _chain_nll(mcmc: MCMC, read_bins, device_data):
    """theta -> compensated (hi, lo) NLL pair for one chain."""
    st = mcmc.static
    nsources = mcmc.nsources
    evaluate, _, pair = _nll_backend(mcmc, read_bins, device_data)
    syst_float = (mcmc.nsystematics > 0) and not mcmc.systematics_fixed
    if not syst_float:
        theta0 = jnp.asarray(mcmc.parameter_means[nsources:], jnp.float32)
        lut0, norms0 = evaluate(theta0)

    def chain_nll(params):
        if syst_float:
            lut, norms = evaluate(params[nsources:])
        else:
            lut, norms = lut0, norms0
        return pair(params, lut, norms, st)

    return chain_nll


def _presample(keys, npar: int, m: int = 0):
    """Pre-generate the whole segment's proposal noise and accept
    uniforms in ONE batched pass before the scan.

    The per-step key derivation is replicated exactly (split into
    k_prop/k_accept for the joint step, the (m+1, 2) grid for the
    blocked step), so trajectories are BIT-IDENTICAL to in-scan
    generation — but the threefry/normal/uniform kernels run once as
    big batched ops instead of 4-5 small launches inside every loop
    iteration, cutting the fixed per-step overhead.

    Returns xs = (noise, u) with shapes ((n, m+1, npar), (n, m+1)).
    """
    if m == 0:
        ks = jax.vmap(jax.random.split)(keys)
        noise = jax.vmap(lambda k: jax.random.normal(k, (npar,)))(
            ks[:, 0])
        u = jax.vmap(lambda k: jax.random.uniform(k, ()))(ks[:, 1])
        return noise[:, None, :], u[:, None]
    ks = jax.vmap(lambda k: jax.random.split(k, 2 * (m + 1)).reshape(
        m + 1, 2, -1))(keys)
    noise = jax.vmap(jax.vmap(
        lambda k: jax.random.normal(k, (npar,))))(ks[:, :, 0])
    u = jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, ())))(ks[:, :, 1])
    return noise, u


def _make_step(mcmc: MCMC, read_bins, device_data, debug_mode: bool):
    chain_nll = _chain_nll(mcmc, read_bins, device_data)

    def step(carry, xs):
        params, (cur_hi, cur_lo), width = carry
        noise_raw, u = xs
        noise = noise_raw[0] * jnp.maximum(width, 0.0)
        proposed = jnp.where(width > 0, params + noise, params)
        prop_hi, prop_lo = chain_nll(proposed)
        # delta = cur - prop, accurate via the compensated pairs: at
        # NLL ~ 10^7 a plain f32 difference would quantize at ~1 and
        # corrupt the accept ratio (the reference compares doubles,
        # nll_kernels.cpp:66-77).
        delta = df_diff(cur_hi, cur_lo, prop_hi, prop_lo)
        accept = debug_mode | (delta > 0) | (u[0] <= jnp.exp(delta))
        params = jnp.where(accept, proposed, params)
        cur_hi = jnp.where(accept, prop_hi, cur_hi)
        cur_lo = jnp.where(accept, prop_lo, cur_lo)
        return ((params, (cur_hi, cur_lo), width),
                (params, (cur_hi, cur_lo), accept.astype(jnp.float32)))

    return step


def _make_step_cov(mcmc: MCMC, read_bins, device_data,
                   debug_mode: bool):
    """Metropolis step with a full-covariance proposal.

    The carry holds a lower-triangular ``scale_tril`` instead of the
    per-parameter width vector: proposals are ``params + L @ z`` with
    ``z ~ N(0, I)``, i.e. correlated Gaussian moves whose covariance is
    ``L L^T``.  Rows of fixed parameters are zero, which pins them
    exactly.  Axis-aligned proposals (the reference's only mode,
    nll_kernels.cpp:30-53) random-walk across anticorrelated rate
    ridges in tiny steps; Haario-scaled full-covariance proposals walk
    ALONG them.
    """
    chain_nll = _chain_nll(mcmc, read_bins, device_data)

    def step(carry, step_key):
        params, (cur_hi, cur_lo), tril = carry
        k_prop, k_accept = jax.random.split(step_key)
        z = jax.random.normal(k_prop, params.shape)
        # HIGHEST keeps the proposal the same on every backend (TF32
        # would only perturb a symmetric proposal, not the posterior).
        proposed = params + jnp.matmul(
            tril, z, precision=jax.lax.Precision.HIGHEST)
        prop_hi, prop_lo = chain_nll(proposed)
        u = jax.random.uniform(k_accept, ())
        delta = df_diff(cur_hi, cur_lo, prop_hi, prop_lo)
        accept = debug_mode | (delta > 0) | (u <= jnp.exp(delta))
        params = jnp.where(accept, proposed, params)
        cur_hi = jnp.where(accept, prop_hi, cur_hi)
        cur_lo = jnp.where(accept, prop_lo, cur_lo)
        return ((params, (cur_hi, cur_lo), tril),
                (params, (cur_hi, cur_lo), accept.astype(jnp.float32)))

    return step


def _tril_from_cov(mcmc: MCMC, tril, cov):
    """Haario rescale of a sample covariance into a proposal
    scale_tril: L = chol((2.4^2/d) * cov + jitter).

    Fixed parameters get zero rows (pinned); a degenerate covariance
    (parameter stuck during the phase) falls back to the previous L.
    Shared by :func:`retune_scale_tril` (two-pass covariance from the
    phase history) and the sharded ensemble's running-moment retune
    (parallel.ensemble._sharded_retune_cov).
    """
    free = jnp.asarray(~mcmc.parameter_fixed)
    d = max(mcmc.nfloat, 1)
    # Unit diagonal on fixed entries keeps the Cholesky well-posed;
    # their L rows are zeroed below.
    fixed_diag = jnp.diag(jnp.where(free, 0.0, 1.0))
    jitter = 1e-6 * jnp.maximum(jnp.max(jnp.diag(cov)), 1e-20)
    eye = jnp.eye(cov.shape[0], dtype=cov.dtype)
    scaled = (HAARIO / d) * cov + jitter * eye * free[None, :] \
        + fixed_diag
    new = jnp.linalg.cholesky(scaled)
    # Degenerate phase (no accepted move -> cov == 0, like the
    # diagonal retune's rms == 0 case) or a failed factorization keep
    # the previous proposal instead of freezing the chain.
    bad = jnp.isnan(new).any() | (jnp.max(jnp.diag(cov)) <= 0)
    return jnp.where(bad, tril, new * free[:, None])


def retune_scale_tril(mcmc: MCMC, tril, phase_samples):
    """Haario full-covariance retune from a phase's sample history."""
    free = jnp.asarray(~mcmc.parameter_fixed)
    x = phase_samples
    n = x.shape[0]
    mu = x.mean(axis=0)
    xc = (x - mu) * free[None, :]
    cov = jnp.matmul(xc.T, xc, precision=jax.lax.Precision.HIGHEST) \
        / jnp.float32(max(n - 1, 1))
    return _tril_from_cov(mcmc, tril, cov)


def _initial_scale_tril(mcmc: MCMC) -> jnp.ndarray:
    w = jnp.asarray(mcmc.initial_jump_widths())
    return jnp.diag(jnp.maximum(w, 0.0))


def _run_single_chain_fullcov(mcmc: MCMC, key, read_bins, device_data,
                              *, nsteps: int, burnin_steps: int,
                              debug_mode: bool):
    """One chain with full-covariance adaptive proposals (traced).

    Phase structure matches :func:`_run_single_chain`: the first
    burn-in phase walks with the diagonal initial widths (no covariance
    estimate exists yet), each retune replaces the proposal with the
    Haario-scaled sample covariance of the finished phase.
    """
    step = _make_step_cov(mcmc, read_bins, device_data, debug_mode)

    def run_phase(carry, phase_key, n):
        keys = jax.random.split(phase_key, n)
        return jax.lax.scan(step, carry, keys)

    params0, nll0, _ = initial_state(mcmc, read_bins, device_data)
    carry = (params0, nll0, _initial_scale_tril(mcmc))
    k1, k2, k3 = jax.random.split(key, 3)

    outs = []
    if burnin_steps > 0:
        carry, (s1, n1, a1) = run_phase(carry, k1, burnin_steps)
        p, c, t = carry
        carry = (p, c, retune_scale_tril(mcmc, t, s1))
        carry, (s2, n2, a2) = run_phase(carry, k2, burnin_steps)
        p, c, t = carry
        carry = (p, c, retune_scale_tril(mcmc, t, s2))
        if debug_mode:
            outs += [(s1, n1, a1), (s2, n2, a2)]

    remaining = max(nsteps - (2 * burnin_steps if burnin_steps > 0
                              else 0), 0)
    if remaining > 0:
        carry, (s3, n3, a3) = run_phase(carry, k3, remaining)
        outs.append((s3, n3, a3))

    samples = jnp.concatenate([o[0] for o in outs], axis=0)
    nlls = (jnp.concatenate([o[1][0] for o in outs], axis=0),
            jnp.concatenate([o[1][1] for o in outs], axis=0))
    accepts = jnp.concatenate([o[2] for o in outs], axis=0)
    return samples, nlls, accepts.mean()


@functools.partial(
    jax.jit, static_argnames=("mcmc", "nsteps", "debug_mode"))
def run_segment_cov(mcmc: MCMC, params, cur_nll, tril, read_bins,
                    device_data, key, nsteps: int,
                    debug_mode: bool = False):
    """Fixed-proposal full-covariance segment (checkpointing building
    block, the `scale_tril` analog of :func:`run_segment`)."""
    step = _make_step_cov(mcmc, read_bins, device_data, debug_mode)
    keys = jax.random.split(key, nsteps)
    carry, (samples, nlls, accepts) = jax.lax.scan(
        step, (params, cur_nll, tril), keys)
    return carry[0], carry[1], samples, nlls, accepts.mean()


@functools.partial(
    jax.jit,
    static_argnames=("mcmc", "nsteps", "burnin_steps", "debug_mode"))
def _run_chains_fullcov(mcmc: MCMC, chain_keys, read_bins, device_data,
                        nsteps: int, burnin_steps: int,
                        debug_mode: bool, rate_substeps: int = 0):
    """Full-covariance chains (see
    :func:`_run_single_chain_fullcov`), vmapped over the chains.
    ``rate_substeps`` is accepted for signature parity and must be 0
    (blocked updates are a different proposal structure)."""
    del rate_substeps
    run = functools.partial(
        _run_single_chain_fullcov, mcmc, nsteps=nsteps,
        burnin_steps=burnin_steps, debug_mode=debug_mode)
    return jax.vmap(run, in_axes=(0, None, None))(
        chain_keys, read_bins, device_data)


def _blocked_enabled(mcmc: MCMC, rate_substeps: int) -> bool:
    """Blocked (Metropolis-within-Gibbs) updates apply when there is a
    floating systematic (else the LUT never changes and the plain step
    already skips rebuilds) and a rate block to sub-step."""
    syst_float = (mcmc.nsystematics > 0) and not mcmc.systematics_fixed
    return rate_substeps > 0 and syst_float and mcmc.nsources > 0


def _make_blocked_step(mcmc: MCMC, read_bins, device_data,
                       debug_mode: bool, rate_substeps: int):
    """Blocked Metropolis-within-Gibbs step: one systematic-block update
    (PDF rebuild) followed by ``rate_substeps`` rate-block updates that
    REUSE the carried LUT — no rebuild.

    The PDFs depend only on the systematic coefficients, so a move that
    touches only source rates leaves (lut, norms) invariant: the
    throughput-dominating histogram rebuild (mcmc.cpp:264-271) runs once
    per cycle instead of once per parameter update.  Each block update
    is a reversible Metropolis kernel holding the other block fixed;
    their composition leaves the posterior invariant (standard blocked
    MCMC), so the walk targets exactly the same distribution as the
    joint sampler.

    Carry extras: (lut, norms) of the CURRENT state — a pure function
    of the current params, so checkpoints need not store them.
    """
    st = mcmc.static
    ns = mcmc.nsources
    m = rate_substeps
    evaluate, _, pair = _nll_backend(mcmc, read_bins, device_data)
    # numpy constant: embeds in the executable (never a device closure).
    rate_sel = np.arange(mcmc.nparameters) < ns

    def rebuild(params):
        return evaluate(params[ns:])

    def init_extras(params):
        return rebuild(params)

    def step(carry, xs):
        params, (cur_hi, cur_lo), width, lut, norms = carry
        noise_all, u_all = xs  # (m + 1, npar), (m + 1,)

        # --- systematic block: propose + full PDF rebuild ------------
        noise = noise_all[0] * jnp.maximum(width, 0.0)
        move = (width > 0) & ~rate_sel
        proposed = jnp.where(move, params + noise, params)
        plut, pnorms = rebuild(proposed)
        prop_hi, prop_lo = pair(proposed, plut, pnorms, st)
        delta = df_diff(cur_hi, cur_lo, prop_hi, prop_lo)
        accept = debug_mode | (delta > 0) | (u_all[0] <= jnp.exp(delta))
        params = jnp.where(accept, proposed, params)
        cur_hi = jnp.where(accept, prop_hi, cur_hi)
        cur_lo = jnp.where(accept, prop_lo, cur_lo)
        lut = jnp.where(accept, plut, lut)
        norms = jnp.where(accept, pnorms, norms)
        acc0 = accept.astype(jnp.float32)

        # --- rate block: m cheap fixed-LUT updates --------------------
        def sub(c2, xs2):
            nz_raw, uu = xs2
            p, hi, lo, acc = c2
            nz = nz_raw * jnp.maximum(width, 0.0)
            mv = (width > 0) & rate_sel
            prop = jnp.where(mv, p + nz, p)
            phi, plo = pair(prop, lut, norms, st)
            d = df_diff(hi, lo, phi, plo)
            a = debug_mode | (d > 0) | (uu <= jnp.exp(d))
            p = jnp.where(a, prop, p)
            hi = jnp.where(a, phi, hi)
            lo = jnp.where(a, plo, lo)
            return (p, hi, lo, acc + a.astype(jnp.float32)), None

        (params, cur_hi, cur_lo, acc), _ = jax.lax.scan(
            sub, (params, cur_hi, cur_lo, acc0),
            (noise_all[1:], u_all[1:]))
        return ((params, (cur_hi, cur_lo), width, lut, norms),
                (params, (cur_hi, cur_lo), acc / (m + 1)))

    return step, init_extras


def _make_stepper(mcmc: MCMC, read_bins, device_data, debug_mode: bool,
                  rate_substeps: int = 0):
    """Uniform step factory: returns ``(step, init_extras, m)``.

    The scan carry is ``(params, (hi, lo), width, *extras)``; extras is
    empty for the joint step and ``(lut, norms)`` for the blocked step.
    ``step`` consumes pre-generated xs from ``_presample(keys, npar,
    m)`` (noise and accept uniforms); history output is identical for
    both modes: (params, nll pair, accept fraction per recorded step).
    """
    if _blocked_enabled(mcmc, rate_substeps):
        step, init_extras = _make_blocked_step(
            mcmc, read_bins, device_data, debug_mode, rate_substeps)
        return step, init_extras, rate_substeps
    base = _make_step(mcmc, read_bins, device_data, debug_mode)

    def step(carry, xs):
        (p, nl, w) = carry[:3]
        (p, nl, w), out = base((p, nl, w), xs)
        return (p, nl, w), out

    return step, (lambda params: ()), 0


@functools.partial(
    jax.jit,
    static_argnames=("mcmc", "nsteps", "burnin_steps", "debug_mode",
                     "rate_substeps"))
def _run_chains(mcmc: MCMC, chain_keys, read_bins, device_data,
                nsteps: int, burnin_steps: int, debug_mode: bool,
                rate_substeps: int = 0):
    """Run all chains (vmapped) with two burn-in retuning phases."""
    run = functools.partial(_run_single_chain, mcmc, nsteps=nsteps,
                            burnin_steps=burnin_steps,
                            debug_mode=debug_mode,
                            rate_substeps=rate_substeps)
    return jax.vmap(run, in_axes=(0, None, None))(
        chain_keys, read_bins, device_data)


@functools.partial(
    jax.jit,
    static_argnames=("mcmc", "nsteps", "burnin_steps", "debug_mode",
                     "rate_substeps"))
def _run_chains_pooled(mcmc: MCMC, chain_keys, read_bins, device_data,
                       nsteps: int, burnin_steps: int, debug_mode: bool,
                       rate_substeps: int = 0):
    """Vmapped chains with jump widths retuned from the POOLED burn-in
    sample RMS of all chains (cross-chain adaptation, SURVEY.md sec. 5).

    On a chain-sharded mesh the ``phase_samples.std`` below lowers to an
    all-reduce over the chain axis — the pmean/allgather pattern.
    """
    nchains = chain_keys.shape[0]
    stepper, init_extras, m = _make_stepper(mcmc, read_bins,
                                            device_data, debug_mode,
                                            rate_substeps)

    def phase(carry_batch, keys, n):
        def one(carry, k):
            xs = _presample(jax.random.split(k, n), mcmc.nparameters, m)
            return jax.lax.scan(stepper, carry, xs)

        return jax.vmap(one)(carry_batch, keys)

    def init(_k):
        p0, n0, w0 = initial_state(mcmc, read_bins, device_data)
        return (p0, n0, w0) + tuple(init_extras(p0))

    carry = jax.vmap(init)(chain_keys)
    # Independent per-chain phase keys derived from each chain's key.
    keys3 = jax.vmap(lambda k: jax.random.split(k, 3))(chain_keys)

    outs = []
    if burnin_steps > 0:
        carry, (s1, n1, a1) = phase(carry, keys3[:, 0], burnin_steps)
        p, c, w = carry[:3]
        # Pool the RMS over (chain, step) — the better estimate every
        # chain shares.
        pooled = s1.reshape(-1, s1.shape[-1])
        w_new = retune_width(mcmc, w[0], pooled)
        carry = (p, c, jnp.broadcast_to(w_new, w.shape)) + carry[3:]
        carry, (s2, n2, a2) = phase(carry, keys3[:, 1], burnin_steps)
        p, c, w = carry[:3]
        pooled = s2.reshape(-1, s2.shape[-1])
        w_new = retune_width(mcmc, w[0], pooled)
        carry = (p, c, jnp.broadcast_to(w_new, w.shape)) + carry[3:]
        if debug_mode:
            outs += [(s1, n1, a1), (s2, n2, a2)]

    remaining = max(nsteps - (2 * burnin_steps if burnin_steps > 0
                              else 0), 0)
    if remaining > 0:
        carry, (s3, n3, a3) = phase(carry, keys3[:, 2], remaining)
        outs.append((s3, n3, a3))

    samples = jnp.concatenate([o[0] for o in outs], axis=1)
    nlls = (jnp.concatenate([o[1][0] for o in outs], axis=1),
            jnp.concatenate([o[1][1] for o in outs], axis=1))
    accepts = jnp.concatenate([o[2] for o in outs], axis=1)
    return samples, nlls, accepts.mean(axis=1)


def _chain_nll_batch(mcmc: MCMC, read_bins, device_data, nchains: int):
    """(nchains, nparams) -> compensated (hi, lo) arrays of (nchains,).

    With floating systematics the nchains PDF rebuilds run as one
    batched rebuild (PdfStack.evaluate_batch).
    """
    st = mcmc.static
    nsources = mcmc.nsources
    evaluate, evaluate_batch, pair = _nll_backend(mcmc, read_bins,
                                                  device_data)
    syst_float = (mcmc.nsystematics > 0) and not mcmc.systematics_fixed
    if not syst_float:
        theta0 = jnp.asarray(mcmc.parameter_means[nsources:], jnp.float32)
        lut0, norms0 = evaluate(theta0)

        def batch_nll(params):
            return jax.vmap(
                lambda p: pair(p, lut0, norms0, st))(params)
    else:
        def batch_nll(params):
            luts, norms = evaluate_batch(params[:, nsources:])
            return jax.vmap(pair, in_axes=(0, 0, 0, None))(
                params, luts, norms, st)

    return batch_nll


@functools.partial(
    jax.jit,
    static_argnames=("mcmc", "nsteps", "burnin_steps", "debug_mode",
                     "rate_substeps"))
def _run_chains_batched(mcmc: MCMC, chain_keys, read_bins, device_data,
                        nsteps: int, burnin_steps: int,
                        debug_mode: bool, rate_substeps: int = 0):
    """All chains advance in lock-step; each step's nchains PDF
    rebuilds are one batched (chains x signals) build.  Same
    phase/retune semantics as :func:`_run_single_chain`, retuned per
    chain.  With ``rate_substeps > 0`` each cycle is one
    batched systematic-block rebuild plus that many fixed-LUT
    rate-block updates (blocked Metropolis-within-Gibbs, see
    :func:`_make_blocked_step`)."""
    nchains = chain_keys.shape[0]
    batch_nll = _chain_nll_batch(mcmc, read_bins, device_data, nchains)
    fixed = jnp.asarray(mcmc.parameter_fixed)
    sf = HAARIO / max(mcmc.nfloat, 1)
    blocked = _blocked_enabled(mcmc, rate_substeps)
    m = rate_substeps if blocked else 0
    st = mcmc.static
    ns = mcmc.nsources
    _, evaluate_batch, pair = _nll_backend(mcmc, read_bins, device_data)
    rate_sel = np.arange(mcmc.nparameters) < ns

    def rebuild_batch(params):
        return evaluate_batch(params[:, ns:])

    def _accept_update(params, cur_hi, cur_lo, proposed, prop_hi,
                       prop_lo, u):
        delta = df_diff(cur_hi, cur_lo, prop_hi, prop_lo)
        accept = debug_mode | (delta > 0) | (u <= jnp.exp(delta))
        params = jnp.where(accept[:, None], proposed, params)
        cur_hi = jnp.where(accept, prop_hi, cur_hi)
        cur_lo = jnp.where(accept, prop_lo, cur_lo)
        return params, cur_hi, cur_lo, accept

    def step(carry, xs):
        # xs: noise (nchains, 1, npar), u (nchains, 1)
        params, (cur_hi, cur_lo), width = carry
        noise_raw, u = xs
        noise = noise_raw[:, 0] * jnp.maximum(width, 0.0)
        proposed = jnp.where(width > 0, params + noise, params)
        prop_hi, prop_lo = batch_nll(proposed)
        params, cur_hi, cur_lo, accept = _accept_update(
            params, cur_hi, cur_lo, proposed, prop_hi, prop_lo, u[:, 0])
        return ((params, (cur_hi, cur_lo), width),
                (params, (cur_hi, cur_lo), accept.astype(jnp.float32)))

    def blocked_step(carry, xs):
        # xs: noise (nchains, m + 1, npar), u (nchains, m + 1)
        params, (cur_hi, cur_lo), width, lut, norms = carry
        noise_all, u_all = xs
        noise = noise_all[:, 0] * jnp.maximum(width, 0.0)
        move = (width > 0) & ~rate_sel[None, :]
        proposed = jnp.where(move, params + noise, params)
        plut, pnorms = rebuild_batch(proposed)
        prop_hi, prop_lo = jax.vmap(
            pair, in_axes=(0, 0, 0, None))(
                proposed, plut, pnorms, st)
        params, cur_hi, cur_lo, accept = _accept_update(
            params, cur_hi, cur_lo, proposed, prop_hi, prop_lo,
            u_all[:, 0])
        lut = jnp.where(accept[:, None, None], plut, lut)
        norms = jnp.where(accept[:, None], pnorms, norms)
        acc0 = accept.astype(jnp.float32)

        def sub(c2, xs2):
            nz_raw, uu = xs2
            p, hi, lo, acc = c2
            nz = nz_raw * jnp.maximum(width, 0.0)
            mv = (width > 0) & rate_sel[None, :]
            prop = jnp.where(mv, p + nz, p)
            phi, plo = jax.vmap(
                pair, in_axes=(0, 0, 0, None))(prop, lut, norms, st)
            p, hi, lo, a = _accept_update(p, hi, lo, prop, phi, plo, uu)
            return (p, hi, lo, acc + a.astype(jnp.float32)), None

        (params, cur_hi, cur_lo, acc), _ = jax.lax.scan(
            sub, (params, cur_hi, cur_lo, acc0),
            (jnp.moveaxis(noise_all[:, 1:], 1, 0),
             jnp.moveaxis(u_all[:, 1:], 1, 0)))
        return ((params, (cur_hi, cur_lo), width, lut, norms),
                (params, (cur_hi, cur_lo), acc / (m + 1)))

    def phase_xs(ks, n):
        # Per-chain presampled streams, scan-ordered: noise
        # (n, nchains, m+1, npar), u (n, nchains, m+1) — bit-identical
        # to the per-step in-scan key derivation this replaces.
        kpc = 2 * (m + 1)
        split = jax.vmap(lambda k: jax.random.split(k, kpc * n).reshape(
            n, m + 1, 2, -1))(ks)
        noise = jax.vmap(jax.vmap(jax.vmap(
            lambda k: jax.random.normal(k, (mcmc.nparameters,)))))(
                split[:, :, :, 0])
        u = jax.vmap(jax.vmap(jax.vmap(
            lambda k: jax.random.uniform(k, ()))))(split[:, :, :, 1])
        return (jnp.moveaxis(noise, 0, 1), jnp.moveaxis(u, 0, 1))

    def run_phase(carry, ks, n):
        return jax.lax.scan(blocked_step if blocked else step, carry,
                            phase_xs(ks, n))

    def retune(width, phase_samples):
        rms = jnp.std(phase_samples, axis=0)  # (nchains, nparams)
        new = jnp.where(rms > 0, sf * rms, width)
        return jnp.where(fixed[None, :], -1.0, new)

    params0 = jnp.broadcast_to(
        jnp.asarray(mcmc.parameter_means, jnp.float32),
        (nchains, mcmc.nparameters))
    nll0 = batch_nll(params0)
    width0 = jnp.broadcast_to(
        jnp.asarray(mcmc.initial_jump_widths()),
        (nchains, mcmc.nparameters))
    carry = (params0, nll0, width0)
    if blocked:
        carry = carry + tuple(rebuild_batch(params0))

    keys3 = jax.vmap(lambda k: jax.random.split(k, 3))(chain_keys)
    outs = []
    if burnin_steps > 0:
        carry, (s1, n1, a1) = run_phase(carry, keys3[:, 0], burnin_steps)
        p, c, w = carry[:3]
        carry = (p, c, retune(w, s1)) + carry[3:]
        carry, (s2, n2, a2) = run_phase(carry, keys3[:, 1], burnin_steps)
        p, c, w = carry[:3]
        carry = (p, c, retune(w, s2)) + carry[3:]
        if debug_mode:
            outs += [(s1, n1, a1), (s2, n2, a2)]

    remaining = max(nsteps - (2 * burnin_steps if burnin_steps > 0
                              else 0), 0)
    if remaining > 0:
        carry, (s3, n3, a3) = run_phase(carry, keys3[:, 2], remaining)
        outs.append((s3, n3, a3))

    # (nsteps, nchains, ...) -> (nchains, nsteps, ...) to match
    # _run_chains' output convention.
    samples = jnp.moveaxis(
        jnp.concatenate([o[0] for o in outs], axis=0), 0, 1)
    nlls = (jnp.moveaxis(
        jnp.concatenate([o[1][0] for o in outs], axis=0), 0, 1),
        jnp.moveaxis(
            jnp.concatenate([o[1][1] for o in outs], axis=0), 0, 1))
    accepts = jnp.concatenate([o[2] for o in outs], axis=0)
    return samples, nlls, accepts.mean(axis=0)


def run_experiment_batch(mcmc: MCMC, keys, read_bins_batch,
                         device_data, nsteps: int,
                         burnin_steps: int, debug_mode: bool = False,
                         rate_substeps: int = 0):
    """Vmapped ensemble: one chain per experiment, batched datasets.

    The reference runs experiments in a serial host loop
    (sxmc.cpp:59-145); here ``nexperiments`` fake experiments run as one
    batched chain walk.  ``read_bins_batch`` is
    ``(nexperiments, nsignals, nevents)`` — ragged datasets are padded
    with an unknown dataset tag, whose -2 sentinel rows contribute
    nothing to the NLL.  Shard the leading axis over a mesh to fan out
    across devices (see sxmc_jax.parallel.ensemble).
    """
    run = functools.partial(_run_single_chain, mcmc, nsteps=nsteps,
                            burnin_steps=burnin_steps,
                            debug_mode=debug_mode,
                            rate_substeps=rate_substeps)
    return jax.vmap(run, in_axes=(0, 0, None))(
        keys, read_bins_batch, device_data)


def _run_single_chain(mcmc: MCMC, key, read_bins, device_data, *,
                      nsteps: int, burnin_steps: int, debug_mode: bool,
                      rate_substeps: int = 0):
    step, init_extras, m = _make_stepper(
        mcmc, read_bins, device_data, debug_mode, rate_substeps)

    def run_phase(carry, phase_key, n):
        keys = jax.random.split(phase_key, n)
        return jax.lax.scan(step, carry,
                            _presample(keys, mcmc.nparameters, m))

    def retune(width, phase_samples):
        return retune_width(mcmc, width, phase_samples)

    params0, nll0, width0 = initial_state(mcmc, read_bins, device_data)

    k1, k2, k3 = jax.random.split(key, 3)
    carry = (params0, nll0, width0) + tuple(init_extras(params0))

    outs = []
    if burnin_steps > 0:
        carry, (s1, n1, a1) = run_phase(carry, k1, burnin_steps)
        p, c, w = carry[:3]
        carry = (p, c, retune(w, s1)) + carry[3:]
        carry, (s2, n2, a2) = run_phase(carry, k2, burnin_steps)
        p, c, w = carry[:3]
        carry = (p, c, retune(w, s2)) + carry[3:]
        if debug_mode:
            outs += [(s1, n1, a1), (s2, n2, a2)]

    remaining = nsteps - (2 * burnin_steps if burnin_steps > 0 else 0)
    remaining = max(remaining, 0)
    if remaining > 0:
        carry, (s3, n3, a3) = run_phase(carry, k3, remaining)
        outs.append((s3, n3, a3))

    samples = jnp.concatenate([o[0] for o in outs], axis=0)
    nlls = (jnp.concatenate([o[1][0] for o in outs], axis=0),
            jnp.concatenate([o[1][1] for o in outs], axis=0))
    accepts = jnp.concatenate([o[2] for o in outs], axis=0)
    return samples, nlls, accepts.mean()
