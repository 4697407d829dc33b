"""Extended maximum-likelihood NLL.

JAX re-design of the reference 3-stage kernel pipeline
(reference: src/nll_kernels.cpp:89-188): grid-stride partial sums +
shared-memory tree reduction + scalar constraint kernel collapse into one
fused jitted expression; XLA emits the reduction, and on an event-sharded
mesh a ``psum`` finishes it.

The math, term for term:
  event term (nll_event_chunks, :89-116):
      s_i = sum_j pars[source_id_j] * nexpected_j * (norms_j / n_mc_j)
                  * lut[j, i]          (NaN lut values count as 0)
      sum_events = sum_i log(s_i)      (only where s_i > 0)
  total (nll_total, :149-188):
      nll = -sum_events
            + sum_j pars[source_id_j] * nexpected_j * norms_j / n_mc_j
            + sum_i 0.5 * ((p_i - mu_i) / sigma_i)^2   (where sigma_i > 0)
      barrier: 1e18 if any source rate is negative or the event term is
      non-finite.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

BARRIER = 1e18


# ---------------------------------------------------------------------------
# Compensated (double-float) accumulation.
#
# The reference accumulates the event log-sum and the total NLL in
# ``double`` (nll_kernels.cpp:89-116, 149-188).  Accelerators run f64
# far slower than f32, so the equivalent here is an error-free-transform
# tree: sums are
# carried as (hi, lo) f32 pairs with ~48 effective mantissa bits.  At the
# 10^7-event scale the NLL is ~10^7 where the plain-f32 quantum (~1) is
# larger than the dNLL = 0.5 interval scale; the compensated sum keeps
# per-evaluation error ~1e-6, so Metropolis accept ratios and interval
# crossings stay exact.  Cost: ~12 flops per element — invisible next
# to the log() itself.


def two_sum(a: jnp.ndarray, b: jnp.ndarray):
    """Branch-free Knuth TwoSum: a + b = s + err exactly (in f32)."""
    s = a + b
    bv = s - a
    err = (a - (s - bv)) + (b - bv)
    return s, err


@jax.custom_jvp
def df_sum(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Compensated sum of all elements: returns (hi, lo) with
    hi + lo ~= exact sum to ~2^-48 relative error.

    Implemented as ONE variadic ``lax.reduce`` whose monoid is TwoSum
    on (sum, compensation) pairs: XLA fuses the producer (the log
    stream of the NLL) straight into the reduction, so this costs the
    same as a plain ``jnp.sum`` (measured ~134 vs ~136 us on the
    vmapped NLL batch; a slice-based TwoSum tree broke fusion and was
    4x slower).  The compensation terms are ~ulp-sized, so their
    plain-f32 accumulation inside the monoid is exact to second order
    regardless of the reduction tree XLA picks.
    """
    s = x.reshape(-1)
    zero = jnp.zeros((), s.dtype)

    def monoid(a, b):
        hi, err = two_sum(a[0], b[0])
        return hi, a[1] + b[1] + err

    n = s.shape[0]
    lanes = 1024
    if n > 4 * lanes:
        # Two-stage: reduce rows into a (lanes,) pair vector first, so
        # no compensation chain exceeds ~n/lanes adds even under a
        # sequential (CPU) lowering — the second-order rounding of the
        # compensation itself stays ~1e-3 at 10^7 elements.  Both
        # stages are lax.reduce, so the producer still fuses.
        m = -(-n // lanes)
        pad = m * lanes - n
        if pad:
            s = jnp.concatenate([s, jnp.zeros((pad,), s.dtype)])
        sb = s.reshape(m, lanes)
        hi_v, lo_v = jax.lax.reduce((sb, jnp.zeros_like(sb)),
                                    (zero, zero), monoid, (0,))
        return jax.lax.reduce((hi_v, lo_v), (zero, zero), monoid, (0,))

    return jax.lax.reduce((s, jnp.zeros_like(s)), (zero, zero),
                          monoid, (0,))


@df_sum.defjvp
def _df_sum_jvp(primals, tangents):
    # d(hi + lo)/dx_i = 1: the tangent is a plain sum (the
    # compensation machinery is value-only), which also keeps
    # gradients of the NLL on the cheap fused path.
    (x,), (dx,) = primals, tangents
    hi, lo = df_sum(x)
    return (hi, lo), (jnp.sum(dx), jnp.zeros_like(lo))


def df_add(hi_a, lo_a, hi_b, lo_b):
    """Double-float addition of two (hi, lo) pairs, renormalized."""
    hi, err = two_sum(hi_a, hi_b)
    lo = lo_a + lo_b + err
    hi2, lo2 = two_sum(hi, lo)
    return hi2, lo2


def df_diff(hi_a, lo_a, hi_b, lo_b):
    """Accurate (a - b) as a plain f32 scalar.

    For nearby values (|a - b| << |a|, the Metropolis case) the hi
    subtraction is exact by Sterbenz's lemma, so the result carries the
    full compensated precision of both operands.
    """
    return (hi_a - hi_b) + (lo_a - lo_b)


def log_sum(s: jnp.ndarray, weights: jnp.ndarray = None):
    """Compensated ``sum_i weights_i * log(s_i)`` over ``s_i > 0``.

    Returns (hi, lo) like :func:`df_sum`.  Terms with s <= 0 (events
    no signal can produce) contribute nothing.
    """
    logs = jnp.where(s > 0, jnp.log(jnp.where(s > 0, s, 1.0)), 0.0)
    if weights is not None:
        logs = logs * weights
    return df_sum(logs)


class NLLStatic(NamedTuple):
    """Per-fit constants for the NLL.

    Store HOST (numpy) arrays here when the struct is closed over by
    jitted functions: numpy constants embed in the executable.

    Attributes:
        nexpected: ``(nsignals,)`` expected events per signal at unit rate.
        n_mc: ``(nsignals,)`` MC sample counts per signal.
        source_id: ``(nsignals,)`` int32 index into the source block of the
            parameter vector (reference: mcmc.cpp:93-98).
        means: ``(nparams,)`` parameter means / expectations.
        sigmas: ``(nparams,)`` Gaussian constraint widths (0 = none).
        nsources: static count of rate parameters at the head of the
            parameter vector.
    """

    nexpected: jnp.ndarray
    n_mc: jnp.ndarray
    source_id: jnp.ndarray
    means: jnp.ndarray
    sigmas: jnp.ndarray
    nsources: int


def signal_weights(pars: jnp.ndarray, norms: jnp.ndarray,
                   st: NLLStatic) -> jnp.ndarray:
    """Per-signal event weight: rate * nexpected * efficiency.

    efficiency = norms / n_mc, with norms the current in-domain counts
    from the histogram build (nll_kernels.cpp:105-107).
    """
    rates = pars[st.source_id]
    return rates * st.nexpected * norms / st.n_mc


def finish_nll(pars: jnp.ndarray, ev_hi, ev_lo, w,
               st: "NLLStatic") -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Shared NLL epilogue: event pair + expected-count term +
    constraints + barrier -> compensated (hi, lo).

    Shared by :func:`nll_pair` and :func:`binned_nll_pair`.
    """
    w_hi, w_lo = df_sum(w)

    constrained = st.sigmas > 0
    z = (pars - st.means) / jnp.where(constrained, st.sigmas, 1.0)
    con = 0.5 * jnp.sum(jnp.where(constrained, z * z, 0.0))

    hi, lo = df_add(-ev_hi, -ev_lo, w_hi, w_lo)
    hi, lo = df_add(hi, lo, con, jnp.zeros_like(con))

    neg_rate = jnp.any(pars[:st.nsources] < 0)
    bad = neg_rate | ~jnp.isfinite(ev_hi)
    hi = jnp.where(bad, jnp.float32(BARRIER), hi)
    lo = jnp.where(bad, jnp.float32(0.0), lo)
    return hi, lo


def mix_density(w: jnp.ndarray, lut0: jnp.ndarray) -> jnp.ndarray:
    """Per-event mixture density ``s_i = sum_j w_j lut0[j, i]``.

    HIGHEST precision: on the GPU an f32 dot may otherwise run in TF32
    (~3 significant digits), which would spoil the compensated event
    sum the Metropolis accept relies on.
    """
    return jnp.einsum("j,ji->i", w, lut0,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)


def nll_pair(pars: jnp.ndarray, lut: jnp.ndarray, norms: jnp.ndarray,
             st: NLLStatic, weights: jnp.ndarray = None
             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full extended-ML NLL with compensated (double-float) accumulation.

    The event log-sum, expected-count term, and constraint sum are
    accumulated as (hi, lo) f32 pairs (the f32 stand-in for the
    reference's ``double`` accumulators, nll_kernels.cpp:89-188), so
    the result resolves dNLL << 0.5 even when NLL ~ 10^7.

    Args:
        pars: ``(nparams,)`` parameter vector — ``nsources`` rates then
            systematic coefficients.
        lut: ``(nsignals, nevents)`` PDF values at the data points (NaN for
            out-of-domain points).
        norms: ``(nsignals,)`` in-domain MC counts at current systematics.
        st: fit constants.
        weights: optional ``(nevents,)`` per-event weights on the log
            term (sum_i w_i log s_i).  A weight of k is exactly k
            identical events; non-integer weights make Asimov datasets
            expressible as weighted events (stats.asimov).  The
            reference has no weighted-data concept.

    Returns:
        (hi, lo) f32 pair; hi + lo is the NLL (1e18 barrier applied).
    """
    pars = jnp.asarray(pars)
    w = signal_weights(pars, norms, st)
    lut0 = jnp.nan_to_num(lut, nan=0.0, posinf=0.0, neginf=0.0)
    nsig = lut.shape[0]
    if nsig <= 32:
        # Unrolled elementwise mix: the (nsignals, nevents) "dot" is
        # memory-bound at these shapes, and keeping it elementwise lets
        # XLA fuse mix -> log -> compensated-reduce into ONE pass.  Wide
        # mixes take the dot, fenced from the variadic reduce.
        s = w[0] * lut0[0]
        for j in range(1, nsig):
            s = s + w[j] * lut0[j]
    else:
        s = jax.lax.optimization_barrier(mix_density(w, lut0))
    ev_hi, ev_lo = log_sum(s, weights)
    return finish_nll(pars, ev_hi, ev_lo, w, st)


def nll(pars: jnp.ndarray, lut: jnp.ndarray, norms: jnp.ndarray,
        st: NLLStatic, weights: jnp.ndarray = None) -> jnp.ndarray:
    """Full extended-ML NLL as a scalar f32 (see :func:`nll_pair`).

    The value is computed with compensated accumulation and then
    rounded once to f32; callers that must resolve dNLL at the
    10^7-event scale should use :func:`nll_pair` directly (the MCMC
    step does).
    """
    hi, lo = nll_pair(pars, lut, norms, st, weights)
    return hi + lo


# ---------------------------------------------------------------------------
# Binned form of the same likelihood.
#
# The PDFs are piecewise constant on the bin grid, so the unbinned
# extended NLL regroups EXACTLY by (dataset, bin):
#
#   sum_i log s(x_i)  ==  sum_{d,b} n_{d,b} * log s_{d,b}
#
# with n_{d,b} the data counts and s_{d,b} the mixture density in bin b
# of dataset d.  This is not an approximation — it is the identical
# likelihood, with the per-step event term collapsed from
# O(nevents * nsignals) to O(ndatasets * nbins): at the 10^7-event
# scale the dominant per-step cost becomes the histogram build alone.
# (The reference has no binned mode; its eval_pdf LUT walk is always
# per-event, pdfz.cpp:411-436.)


def binned_nll_pair(pars: jnp.ndarray, hists: jnp.ndarray,
                    norms: jnp.ndarray, st: NLLStatic,
                    data_counts: jnp.ndarray, ds_mask: jnp.ndarray,
                    bin_volume: float
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Extended-ML NLL from binned data counts (exact regrouping).

    Args:
        pars: ``(nparams,)`` parameter vector (rates then systematics).
        hists: ``(nsignals, total_nbins)`` MC counts at the current
            systematics (PdfStack.histograms output — no LUT needed).
        norms: ``(nsignals,)`` in-domain MC counts.
        st: fit constants.
        data_counts: ``(ndatasets, total_nbins)`` data (or weighted /
            Asimov) event counts per dataset bin, from
            ``PdfStack.data_bin_counts``.  Out-of-domain and
            unknown-tag events are excluded there, matching the
            unbinned path's -1/-2 sentinels.
        ds_mask: ``(ndatasets, nsignals)`` 0/1 — signal j contributes
            to dataset row d (the binned analog of the -2 dataset
            sentinel).
        bin_volume: volume of one bin.

    Returns:
        (hi, lo) compensated f32 pair; identical semantics to
        :func:`nll_pair` (same barrier, constraints, accumulation).
    """
    pars = jnp.asarray(pars)
    w = signal_weights(pars, norms, st)
    # Per-signal density rows; zero-norm rows are all-zero counts, so
    # the guard divisor is never observed through a nonzero value.
    dens = hists / (jnp.where(norms > 0, norms, 1.0)[:, None]
                    * jnp.float32(bin_volume))
    # Masked per-dataset mixture.  Mirrors nll_pair: nsignals is small,
    # so unroll the mix elementwise; wide mixes take the fenced
    # HIGHEST-precision einsum (a default-precision f32 matmul may run
    # in TF32 on the GPU, which would break the compensated-NLL
    # accuracy invariant: exact accept ratios at NLL ~ 1e7).
    mw = jnp.asarray(ds_mask, jnp.float32) * w[None, :]
    nsig = hists.shape[0]
    if nsig <= 32:
        s = mw[:, 0, None] * dens[0][None, :]
        for j in range(1, nsig):
            s = s + mw[:, j, None] * dens[j][None, :]
    else:
        s = jnp.einsum("dj,jb->db", mw, dens,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)
        s = jax.lax.optimization_barrier(s)
    ev_hi, ev_lo = log_sum(s, data_counts)
    return finish_nll(pars, ev_hi, ev_lo, w, st)


def binned_nll(pars: jnp.ndarray, hists: jnp.ndarray, norms: jnp.ndarray,
               st: NLLStatic, data_counts: jnp.ndarray,
               ds_mask: jnp.ndarray, bin_volume: float) -> jnp.ndarray:
    """Scalar f32 form of :func:`binned_nll_pair`."""
    hi, lo = binned_nll_pair(pars, hists, norms, st, data_counts,
                             ds_mask, bin_volume)
    return hi + lo
