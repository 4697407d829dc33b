"""Hamiltonian Monte Carlo over the extended-ML posterior.

The north-star sampler the CUDA reference could never implement:
gradients of the NLL are free under JAX, so the random walk is replaced
by leapfrog trajectories.  Everything is one ``lax.scan`` inside jit,
vmappable over chains and shardable like the Metropolis path.

Design notes:
  * Source rates are sampled in log space (y = log r) with the Jacobian
    correction ``U(y) = nll(r(y)) - sum(y)``, which both enforces r > 0
    (replacing the reference's 1e18 barrier, nll_kernels.cpp:173-177)
    and makes the geometry friendlier near small rates.
  * Systematic-coefficient directions have zero NLL gradient (the
    histogram is piecewise-constant in theta), so leapfrog moves them
    ballistically — an implicit random-walk proposal whose scale is set
    by the adapted mass matrix; accept/reject through the total
    Hamiltonian keeps the chain exact.
  * Warmup: dual-averaging step-size adaptation to a target acceptance
    (Hoffman & Gelman 2014, Algorithm 5) plus diagonal mass-matrix
    estimation from the warmup samples.
  * Exact-LUT KDE signals (kde_exact): like every sampler routed
    through ``metropolis._nll_backend``, the unbinned likelihood
    evaluates those rows at the true event coordinates
    (``stack.evaluate(..., use_exact_kde=True)``) rather than on the
    bin grid — intentional: for KDE rows the grid LUT is the
    approximation and the event-coordinate density is the model, and
    ``jax.grad`` of the potential flows through ``EvalKDE.eval_at``
    (smooth in theta, unlike the piecewise-constant histogram rows).
    Covered by tests/test_kde_fit.py::TestKDEExact::test_hmc_nuts.
"""

from __future__ import annotations

import functools
import types
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.ops.nll import nll as nll_fn
from sxmc_jax.stats.likelihood import LikelihoodSpace


class HMC(MCMC):
    """HMC fit driver with the same call contract as MCMC."""

    def __init__(self, *args, num_leapfrog: int = 16,
                 target_accept: float = 0.8, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_leapfrog = num_leapfrog
        self.target_accept = target_accept

    def __call__(
        self,
        data: np.ndarray,
        nsteps: int,
        burnin_fraction: float = 0.1,
        debug_mode: bool = False,
        seed: int = 0,
        nchains: int = 1,
        key: Optional[jax.Array] = None,
    ) -> LikelihoodSpace:
        self.stack.set_data(np.asarray(data, np.float32))
        warmup = max(int(nsteps * burnin_fraction), 10)
        keep = max(nsteps - warmup, 1)

        if key is None:
            key = jax.random.PRNGKey(seed)
        chain_keys = jax.random.split(key, nchains)

        samples, nlls, accept = _run_hmc_chains(
            self, chain_keys, self.stack._read_bins,
            self.stack.device_data, warmup, keep,
            self.num_leapfrog, self.target_accept)

        samples = np.asarray(samples).reshape(-1, self.nparameters)
        nlls = np.asarray(nlls).reshape(-1)
        self.last_accept_rate = float(np.mean(np.asarray(accept)))
        return LikelihoodSpace.from_arrays(
            samples, nlls, self.parameter_names)


@functools.partial(
    jax.jit,
    static_argnames=("hmc", "warmup", "keep", "num_leapfrog",
                     "target_accept"))
def _run_hmc_chains(hmc: HMC, chain_keys, read_bins, device_data,
                    warmup: int, keep: int, num_leapfrog: int,
                    target_accept: float):
    run = functools.partial(
        _run_hmc_single, hmc, warmup=warmup, keep=keep,
        num_leapfrog=num_leapfrog, target_accept=target_accept)
    return jax.vmap(run, in_axes=(0, None, None))(
        chain_keys, read_bins, device_data)


def _make_hmc_fns(hmc: HMC, read_bins, device_data, num_leapfrog: int,
                  target_accept: float):
    """Shared machinery: (potential, hmc_step, warm_body, q0,
    inv_mass0, to_constrained, jacobian) — used by the fused
    single-chain runner and the checkpointable segment entry points."""
    nsources = hmc.nsources
    st = hmc.static
    stack = hmc.stack
    fixed = jnp.asarray(hmc.parameter_fixed)
    npar = hmc.nparameters
    is_rate = jnp.arange(npar) < nsources
    free = ~fixed

    from sxmc_jax.mcmc.metropolis import _nll_backend

    evaluate, _, pair = _nll_backend(hmc, read_bins, device_data)
    syst_float = (hmc.nsystematics > 0) and not hmc.systematics_fixed
    if not syst_float:
        theta0 = jnp.asarray(hmc.parameter_means[nsources:], jnp.float32)
        lut0, norms0 = evaluate(theta0)

    def params_nll(params):
        if syst_float:
            lut, norms = evaluate(params[nsources:])
        else:
            lut, norms = lut0, norms0
        hi, lo = pair(params, lut, norms, st)
        return hi + lo

    def to_unconstrained(params):
        # y = log r for rates; identity for systematics.
        safe = jnp.maximum(params, 1e-10)
        return jnp.where(is_rate, jnp.log(safe), params)

    def to_constrained(q):
        return jnp.where(is_rate, jnp.exp(q), q)

    def jacobian(q):
        # Flat prior in r-space => subtract sum(log r) Jacobian.
        return jnp.sum(jnp.where(is_rate & free, q, 0.0))

    def potential(q):
        return params_nll(to_constrained(q)) - jacobian(q)

    grad_U = jax.grad(potential)

    q0 = to_unconstrained(jnp.asarray(hmc.parameter_means, jnp.float32))
    # Initial diagonal mass ~ 1 / initial-jump-width^2.
    w0 = jnp.asarray(hmc.initial_jump_widths())
    inv_mass0 = jnp.where(free, jnp.maximum(w0, 1e-4) ** 2, 0.0)

    def leapfrog(q, p, eps, inv_mass):
        g = grad_U(q)
        p = p - 0.5 * eps * g

        def body(_, qp):
            q, p = qp
            q = q + eps * inv_mass * p
            q = jnp.where(free, q, q0)
            g = grad_U(q)
            p = p - eps * g
            return (q, p)

        q, p = jax.lax.fori_loop(0, num_leapfrog - 1, body, (q, p))
        q = q + eps * inv_mass * p
        q = jnp.where(free, q, q0)
        g = grad_U(q)
        p = p - 0.5 * eps * g
        return q, p

    def hmc_step(q, U_q, eps, inv_mass, step_key):
        k_mom, k_acc = jax.random.split(step_key)
        sigma = jnp.sqrt(jnp.where(inv_mass > 0, 1.0 / jnp.maximum(
            inv_mass, 1e-20), 0.0))
        p = jax.random.normal(k_mom, q.shape) * sigma
        K0 = 0.5 * jnp.sum(inv_mass * p * p)
        q_new, p_new = leapfrog(q, p, eps, inv_mass)
        U_new = potential(q_new)
        K_new = 0.5 * jnp.sum(inv_mass * p_new * p_new)
        log_accept = (U_q + K0) - (U_new + K_new)
        accept_prob = jnp.minimum(jnp.exp(jnp.minimum(log_accept, 0.0)),
                                  1.0)
        u = jax.random.uniform(k_acc, ())
        take = (u < accept_prob) & jnp.isfinite(U_new)
        q = jnp.where(take, q_new, q)
        U_q = jnp.where(take, U_new, U_q)
        return q, U_q, accept_prob, take

    # ---- warmup body with dual averaging (target_accept) ----
    mu = jnp.log(10.0 * 0.1)

    def warm_body(carry, step_key):
        q, U_q, log_eps, log_eps_bar, h_bar, t = carry
        eps = jnp.exp(log_eps)
        q, U_q, a_prob, _ = hmc_step(q, U_q, eps, inv_mass0, step_key)
        t = t + 1.0
        # Dual averaging (Hoffman & Gelman 2014, Algorithm 5) with
        # t0=10, kappa=0.75 and a heavily damped gamma (=1 instead of
        # the canonical 0.05): acceptance statistics on f32
        # histogram-LUT posteriors are noisy, and the canonical gain
        # drives the step size into collapse.  Verified empirically
        # (tests/test_hmc.py, test_nuts.py).
        eta = 1.0 / (t + 10.0)
        h_bar = (1.0 - eta) * h_bar + eta * (target_accept - a_prob)
        log_eps = mu - jnp.sqrt(t) * h_bar
        pow_t = t ** (-0.75)
        log_eps_bar = pow_t * log_eps + (1.0 - pow_t) * log_eps_bar
        return (q, U_q, log_eps, log_eps_bar, h_bar, t), (q, a_prob)

    def main_body(eps, inv_mass):
        def body(carry, step_key):
            q, U_q = carry
            q, U_q, a_prob, take = hmc_step(q, U_q, eps, inv_mass,
                                            step_key)
            params = to_constrained(q)
            # Recover the NLL from U without re-evaluating the PDFs:
            # U = nll - sum(log r) over free rates.
            return ((q, U_q),
                    (params, U_q + jacobian(q),
                     take.astype(jnp.float32)))
        return body

    return types.SimpleNamespace(
        potential=potential, hmc_step=hmc_step, warm_body=warm_body,
        main_body=main_body, q0=q0, inv_mass0=inv_mass0, free=free,
        to_constrained=to_constrained, jacobian=jacobian)


def _run_hmc_single(hmc: HMC, key, read_bins, device_data, *,
                    warmup: int, keep: int,
                    num_leapfrog: int, target_accept: float):
    fns = _make_hmc_fns(hmc, read_bins, device_data, num_leapfrog,
                        target_accept)
    eps0 = jnp.float32(0.1)

    U0 = fns.potential(fns.q0)
    k_warm, k_main = jax.random.split(key)
    warm_keys = jax.random.split(k_warm, warmup)
    carry, (warm_qs, warm_accepts) = jax.lax.scan(
        fns.warm_body,
        (fns.q0, U0, jnp.log(eps0), jnp.log(eps0), 0.0, 0.0),
        warm_keys)
    q, U_q, _, log_eps_bar, _, _ = carry
    eps = jnp.exp(log_eps_bar)

    # Diagonal mass from warmup variance (second half).
    half = warm_qs[warmup // 2:]
    var = jnp.var(half, axis=0)
    inv_mass = jnp.where(fns.free, jnp.maximum(var, 1e-8), 0.0)

    # ---- sampling ----
    main_keys = jax.random.split(k_main, keep)
    _, (samples, nlls, accepts) = jax.lax.scan(
        fns.main_body(eps, inv_mass), (q, U_q), main_keys)
    return samples, nlls, accepts.mean()


@functools.partial(
    jax.jit,
    static_argnames=("hmc", "nsteps", "num_leapfrog", "target_accept"))
def warmup_segment(hmc: HMC, carry, read_bins, device_data, key,
                   nsteps: int, num_leapfrog: int,
                   target_accept: float):
    """One checkpointable slice of HMC warmup.

    ``carry`` is the explicit dual-averaging state
    (q, U, log_eps, log_eps_bar, h_bar, t); returns (carry, warm_qs)
    so a killed warmup resumes exactly (sxmc_jax.checkpoint).
    """
    fns = _make_hmc_fns(hmc, read_bins, device_data, num_leapfrog,
                        target_accept)
    keys = jax.random.split(key, nsteps)
    carry, (warm_qs, _) = jax.lax.scan(fns.warm_body, carry, keys)
    return carry, warm_qs


@functools.partial(
    jax.jit, static_argnames=("hmc", "nsteps", "num_leapfrog"))
def main_segment(hmc: HMC, q, U_q, eps, inv_mass, read_bins,
                 device_data, key, nsteps: int, num_leapfrog: int):
    """One checkpointable slice of HMC sampling; returns
    ((q, U), (samples, nlls, accept_mean))."""
    fns = _make_hmc_fns(hmc, read_bins, device_data, num_leapfrog, 0.8)
    keys = jax.random.split(key, nsteps)
    (q, U_q), (samples, nlls, accepts) = jax.lax.scan(
        fns.main_body(eps, inv_mass), (q, U_q), keys)
    return (q, U_q), (samples, nlls, accepts.mean())


def initial_warm_carry(hmc: HMC, read_bins, device_data,
                       num_leapfrog: int, target_accept: float):
    """Fresh dual-averaging warmup carry for segment-mode HMC."""
    fns = _make_hmc_fns(hmc, read_bins, device_data, num_leapfrog,
                        target_accept)
    eps0 = jnp.float32(0.1)
    U0 = fns.potential(fns.q0)
    return (fns.q0, U0, jnp.log(eps0), jnp.log(eps0), jnp.float32(0.0),
            jnp.float32(0.0))


def mass_from_warmup(hmc: HMC, warm_qs):
    """Diagonal inverse mass from warmup samples (second half)."""
    free = ~jnp.asarray(hmc.parameter_fixed)
    half = warm_qs[warm_qs.shape[0] // 2:]
    var = jnp.var(half, axis=0)
    return jnp.where(free, jnp.maximum(var, 1e-8), 0.0)
