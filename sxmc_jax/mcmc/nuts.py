"""No-U-Turn Sampler (multinomial NUTS) over the extended-ML posterior.

Completes the BASELINE north star ("jit-compiled NUTS/HMC"): trajectory
lengths self-tune by doubling until the path turns back on itself
(Hoffman & Gelman 2014), with multinomial state selection (Betancourt
2017) and the same log-rate reparameterization, dual-averaging step
size, and mass adaptation as :mod:`sxmc_jax.mcmc.hmc`.

Implementation notes:
  * The doubling loop is statically unrolled over ``max_depth`` levels
    (each level runs 2^d leapfrog steps in a ``fori_loop``), with a
    ``done`` flag short-circuiting later levels via ``lax.cond`` — all
    compiler-friendly control flow.
  * Termination uses the generalized U-turn criterion evaluated between
    the overall trajectory endpoints after each doubling (the
    symmetric "outer" criterion) plus per-subtree endpoint checks and
    a divergence guard; state selection within and across subtrees is
    progressive multinomial with weights exp(H0 - H).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sxmc_jax.mcmc.hmc import HMC
from sxmc_jax.stats.likelihood import LikelihoodSpace

DIVERGENCE = 1000.0


class NUTS(HMC):
    """NUTS fit driver with the same call contract as MCMC/HMC."""

    def __init__(self, *args, max_depth: int = 8, **kwargs):
        kwargs.setdefault("target_accept", 0.8)
        super().__init__(*args, **kwargs)
        self.max_depth = max_depth

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

        samples, nlls, accept = _run_nuts_chains(
            self, chain_keys, self.stack._read_bins,
            self.stack.device_data, warmup, keep, self.max_depth,
            self.target_accept)

        samples = np.asarray(samples).reshape(-1, self.nparameters)
        nlls = np.asarray(nlls).reshape(-1)
        self.last_accept_rate = float(np.mean(np.asarray(accept)))
        return LikelihoodSpace.from_arrays(
            samples, nlls, self.parameter_names)


@functools.partial(
    jax.jit,
    static_argnames=("nuts", "warmup", "keep", "max_depth",
                     "target_accept"))
def _run_nuts_chains(nuts: NUTS, chain_keys, read_bins, device_data,
                     warmup: int, keep: int, max_depth: int,
                     target_accept: float):
    run = functools.partial(
        _run_nuts_single, nuts, warmup=warmup, keep=keep,
        max_depth=max_depth, target_accept=target_accept)
    return jax.vmap(run, in_axes=(0, None, None))(
        chain_keys, read_bins, device_data)


def _make_nuts_fns(nuts: NUTS, read_bins, device_data, max_depth: int,
                   target_accept: float):
    """Shared machinery (mirrors hmc._make_hmc_fns): warm/main scan
    bodies with explicit carries, used by the fused runner and the
    checkpointable segment entry points."""
    import types

    from sxmc_jax.ops.nll import nll as nll_fn

    nsources = nuts.nsources
    st = nuts.static
    stack = nuts.stack
    fixed = jnp.asarray(nuts.parameter_fixed)
    npar = nuts.nparameters
    is_rate = jnp.arange(npar) < nsources
    free = ~fixed

    from sxmc_jax.mcmc.metropolis import _nll_backend

    evaluate, _, pair = _nll_backend(nuts, read_bins, device_data)
    syst_float = (nuts.nsystematics > 0) and not nuts.systematics_fixed
    if not syst_float:
        theta0 = jnp.asarray(nuts.parameter_means[nsources:], jnp.float32)
        lut0, norms0 = evaluate(theta0)

    def params_nll(params):
        if syst_float:
            lut, norms = evaluate(params[nsources:])
        else:
            lut, norms = lut0, norms0
        hi, lo = pair(params, lut, norms, st)
        return hi + lo

    def to_unconstrained(params):
        safe = jnp.maximum(params, 1e-10)
        return jnp.where(is_rate, jnp.log(safe), params)

    def to_constrained(q):
        return jnp.where(is_rate, jnp.exp(q), q)

    def potential(q):
        params = to_constrained(q)
        jac = jnp.sum(jnp.where(is_rate & free, q, 0.0))
        return params_nll(params) - jac

    grad_U = jax.grad(potential)
    q0 = to_unconstrained(jnp.asarray(nuts.parameter_means, jnp.float32))
    w0 = jnp.asarray(nuts.initial_jump_widths())
    inv_mass0 = jnp.where(free, jnp.maximum(w0, 1e-4) ** 2, 0.0)

    def kinetic(p, inv_mass):
        return 0.5 * jnp.sum(inv_mass * p * p)

    def leapfrog1(q, p, g, eps, inv_mass):
        p = p - 0.5 * eps * g
        q = q + eps * inv_mass * p
        q = jnp.where(free, q, q0)
        g = grad_U(q)
        p = p - 0.5 * eps * g
        return q, p, g

    def uturn(q_left, p_left, q_right, p_right, inv_mass):
        dq = q_right - q_left
        return (jnp.sum(dq * inv_mass * p_left) < 0) | \
               (jnp.sum(dq * inv_mass * p_right) < 0)

    def nuts_step(q, U_q, eps, inv_mass, step_key):
        k_mom, k_loop = jax.random.split(step_key)
        sigma = jnp.sqrt(jnp.where(inv_mass > 0,
                                   1.0 / jnp.maximum(inv_mass, 1e-20),
                                   0.0))
        p0 = jax.random.normal(k_mom, q.shape) * sigma
        g0 = grad_U(q)
        H0 = U_q + kinetic(p0, inv_mass)

        # Trajectory state. logW is log sum of exp(H0 - H_i) over all
        # accepted states (the initial point has weight 1 -> logW = 0).
        state = dict(
            ql=q, pl=p0, gl=g0, qr=q, pr=p0, gr=g0,
            q_prop=q, U_prop=U_q,
            logW=jnp.float32(0.0),
            done=jnp.bool_(False),
            alpha_sum=jnp.float32(0.0), alpha_n=jnp.float32(0.0),
            depth=jnp.int32(0),
        )

        def build_subtree(q, p, g, direction, nsteps_static, eps,
                          inv_mass, key):
            """Run 2^d leapfrogs; progressive multinomial within."""
            def body(i, c):
                (q, p, g, logW, qp, Up, start_q, start_p, turn, div,
                 a_sum, key) = c
                q, p, g = leapfrog1(q, p, g, direction * eps, inv_mass)
                U = potential(q)
                H = U + kinetic(p, inv_mass)
                dH = H0 - H
                div = div | ~jnp.isfinite(H) | (-dH > DIVERGENCE)
                w = jnp.where(div, -jnp.inf, dH)
                new_logW = jnp.logaddexp(logW, w)
                key, k = jax.random.split(key)
                take = jnp.log(jax.random.uniform(k, ())) < (w - new_logW)
                qp = jnp.where(take, q, qp)
                Up = jnp.where(take, U, Up)
                a_sum = a_sum + jnp.minimum(jnp.exp(dH), 1.0)
                turn = turn | uturn(
                    jnp.where(direction > 0, start_q, q),
                    jnp.where(direction > 0, start_p, p),
                    jnp.where(direction > 0, q, start_q),
                    jnp.where(direction > 0, p, start_p), inv_mass)
                return (q, p, g, new_logW, qp, Up, start_q, start_p,
                        turn, div, a_sum, key)

            init = (q, p, g, -jnp.inf, q, jnp.float32(0.0), q, p,
                    jnp.bool_(False), jnp.bool_(False), jnp.float32(0.0),
                    key)
            out = jax.lax.fori_loop(0, nsteps_static, body, init)
            (q, p, g, logW, qp, Up, _, _, turn, div, a_sum, _) = out
            return q, p, g, logW, qp, Up, turn, div, a_sum

        def level(d, state, key):
            k_dir, k_sub, k_merge = jax.random.split(key, 3)
            direction = jnp.where(
                jax.random.bernoulli(k_dir, 0.5), 1.0, -1.0)
            start_q = jnp.where(direction > 0, state["qr"], state["ql"])
            start_p = jnp.where(direction > 0, state["pr"], state["pl"])
            start_g = jnp.where(direction > 0, state["gr"], state["gl"])

            (eq, ep, eg, sub_logW, sub_q, sub_U, sub_turn, sub_div,
             a_sum) = build_subtree(start_q, start_p, start_g, direction,
                                    2 ** d, eps, inv_mass, k_sub)

            new = dict(state)
            new["alpha_sum"] = state["alpha_sum"] + a_sum
            new["alpha_n"] = state["alpha_n"] + 2.0 ** d

            stop_now = sub_turn | sub_div
            # Multinomial merge of the subtree proposal (only if the
            # subtree is valid).
            total = jnp.logaddexp(state["logW"], sub_logW)
            take = (~stop_now) & (
                jnp.log(jax.random.uniform(k_merge, ())) <
                (sub_logW - total))
            new["q_prop"] = jnp.where(take, sub_q, state["q_prop"])
            new["U_prop"] = jnp.where(take, sub_U, state["U_prop"])
            new["logW"] = jnp.where(stop_now, state["logW"], total)

            new["ql"] = jnp.where((direction < 0) & ~stop_now, eq,
                                  state["ql"])
            new["pl"] = jnp.where((direction < 0) & ~stop_now, ep,
                                  state["pl"])
            new["gl"] = jnp.where((direction < 0) & ~stop_now, eg,
                                  state["gl"])
            new["qr"] = jnp.where((direction > 0) & ~stop_now, eq,
                                  state["qr"])
            new["pr"] = jnp.where((direction > 0) & ~stop_now, ep,
                                  state["pr"])
            new["gr"] = jnp.where((direction > 0) & ~stop_now, eg,
                                  state["gr"])

            overall_turn = uturn(new["ql"], new["pl"], new["qr"],
                                 new["pr"], inv_mass)
            new["done"] = state["done"] | stop_now | overall_turn
            new["depth"] = state["depth"] + jnp.where(state["done"], 0, 1)
            return new

        keys = jax.random.split(k_loop, max_depth)
        for d in range(max_depth):
            state = jax.lax.cond(
                state["done"], lambda s: s,
                lambda s: level(d, s, keys[d]), state)

        alpha = state["alpha_sum"] / jnp.maximum(state["alpha_n"], 1.0)
        return state["q_prop"], state["U_prop"], alpha

    # ---- warmup with dual averaging ----
    mu = jnp.log(10.0 * 0.1)
    eps0 = jnp.float32(0.1)

    def warm_body(carry, step_key):
        q, U_q, log_eps, log_eps_bar, h_bar, t = carry
        eps = jnp.exp(log_eps)
        q, U_q, a_prob = nuts_step(q, U_q, eps, inv_mass0, step_key)
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

    def jacobian(q):
        return jnp.sum(jnp.where(is_rate & free, q, 0.0))

    def main_body(eps, inv_mass):
        def body(carry, step_key):
            q, U_q = carry
            q, U_q, alpha = nuts_step(q, U_q, eps, inv_mass, step_key)
            params = to_constrained(q)
            return (q, U_q), (params, U_q + jacobian(q), alpha)
        return body

    return types.SimpleNamespace(
        potential=potential, warm_body=warm_body, main_body=main_body,
        q0=q0, inv_mass0=inv_mass0, free=free,
        to_constrained=to_constrained, jacobian=jacobian)


def _run_nuts_single(nuts: NUTS, key, read_bins, device_data, *,
                     warmup: int, keep: int, max_depth: int,
                     target_accept: float):
    fns = _make_nuts_fns(nuts, read_bins, device_data, max_depth,
                         target_accept)
    eps0 = jnp.float32(0.1)

    U0 = fns.potential(fns.q0)
    k_warm, k_main = jax.random.split(key)
    warm_keys = jax.random.split(k_warm, warmup)
    carry, (warm_qs, _) = jax.lax.scan(
        fns.warm_body,
        (fns.q0, U0, jnp.log(eps0), jnp.log(eps0), 0.0, 0.0),
        warm_keys)
    q, U_q, _, log_eps_bar, _, _ = carry
    eps = jnp.exp(log_eps_bar)

    half = warm_qs[warmup // 2:]
    var = jnp.var(half, axis=0)
    inv_mass = jnp.where(fns.free, jnp.maximum(var, 1e-8), 0.0)

    # ---- sampling ----
    main_keys = jax.random.split(k_main, keep)
    _, (samples, nlls, alphas) = jax.lax.scan(
        fns.main_body(eps, inv_mass), (q, U_q), main_keys)
    return samples, nlls, alphas.mean()


@functools.partial(
    jax.jit,
    static_argnames=("nuts", "nsteps", "max_depth", "target_accept"))
def warmup_segment(nuts: NUTS, carry, read_bins, device_data, key,
                   nsteps: int, max_depth: int, target_accept: float):
    """One checkpointable slice of NUTS warmup (explicit
    dual-averaging carry, see sxmc_jax.checkpoint)."""
    fns = _make_nuts_fns(nuts, read_bins, device_data, max_depth,
                         target_accept)
    keys = jax.random.split(key, nsteps)
    carry, (warm_qs, _) = jax.lax.scan(fns.warm_body, carry, keys)
    return carry, warm_qs


@functools.partial(
    jax.jit, static_argnames=("nuts", "nsteps", "max_depth"))
def main_segment(nuts: NUTS, q, U_q, eps, inv_mass, read_bins,
                 device_data, key, nsteps: int, max_depth: int):
    """One checkpointable slice of NUTS sampling."""
    fns = _make_nuts_fns(nuts, read_bins, device_data, max_depth, 0.8)
    keys = jax.random.split(key, nsteps)
    (q, U_q), (samples, nlls, alphas) = jax.lax.scan(
        fns.main_body(eps, inv_mass), (q, U_q), keys)
    return (q, U_q), (samples, nlls, alphas.mean())


def initial_warm_carry(nuts: NUTS, read_bins, device_data,
                       max_depth: int, target_accept: float):
    """Fresh dual-averaging warmup carry for segment-mode NUTS."""
    fns = _make_nuts_fns(nuts, read_bins, device_data, max_depth,
                         target_accept)
    eps0 = jnp.float32(0.1)
    U0 = fns.potential(fns.q0)
    return (fns.q0, U0, jnp.log(eps0), jnp.log(eps0), jnp.float32(0.0),
            jnp.float32(0.0))
