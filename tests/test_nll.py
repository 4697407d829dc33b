"""NLL unit tests against closed-form Poisson/Gaussian cases.

The reference has no NLL tests (SURVEY.md section 4); these pin the math
of nll_kernels.cpp:89-188 analytically.
"""

import numpy as np
import jax.numpy as jnp

from sxmc_jax.ops.nll import BARRIER, NLLStatic, nll, signal_weights


def make_static(nexpected, n_mc, source_id, means, sigmas, nsources):
    return NLLStatic(
        nexpected=jnp.asarray(nexpected, jnp.float32),
        n_mc=jnp.asarray(n_mc, jnp.float32),
        source_id=jnp.asarray(source_id, jnp.int32),
        means=jnp.asarray(means, jnp.float32),
        sigmas=jnp.asarray(sigmas, jnp.float32),
        nsources=nsources)


class TestClosedForm:
    def test_flat_pdf_poisson(self):
        # One signal, flat unit PDF on its domain, n events:
        # NLL(r) = -n log(r N) + r N.
        n, N = 50, 100.0
        st = make_static([N], [1000], [0], [1.0], [0.0], 1)
        lut = jnp.ones((1, n))
        norms = jnp.array([1000.0])
        for r in [0.5, 1.0, 2.0]:
            got = float(nll(jnp.array([r]), lut, norms, st))
            want = -n * np.log(r * N) + r * N
            np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_gaussian_constraint(self):
        n, N = 10, 20.0
        st = make_static([N], [100], [0], [1.0], [0.1], 1)
        lut = jnp.ones((1, n))
        norms = jnp.array([100.0])
        r = 1.25
        got = float(nll(jnp.array([r]), lut, norms, st))
        want = -n * np.log(r * N) + r * N + 0.5 * ((r - 1.0) / 0.1) ** 2
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_efficiency_factor(self):
        # norms/n_mc scales both the event weights and expectation
        # (nll_kernels.cpp:105-107, 168-171).
        n, N = 10, 20.0
        st = make_static([N], [100], [0], [1.0], [0.0], 1)
        lut = jnp.ones((1, n))
        norms = jnp.array([50.0])  # efficiency 0.5
        got = float(nll(jnp.array([1.0]), lut, norms, st))
        want = -n * np.log(0.5 * N) + 0.5 * N
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_source_shared_rate(self):
        # Two signals sharing one source: weights both read pars[0]
        # (nll_kernels.cpp:106-107, mcmc.cpp:93-98).
        st = make_static([10.0, 20.0], [100, 100], [0, 0], [1.0], [0.0], 1)
        w = signal_weights(jnp.array([2.0]), jnp.array([100.0, 100.0]), st)
        np.testing.assert_allclose(np.asarray(w), [20.0, 40.0], rtol=1e-6)

    def test_negative_rate_barrier(self):
        st = make_static([10.0], [100], [0], [1.0], [0.0], 1)
        lut = jnp.ones((1, 5))
        got = float(nll(jnp.array([-0.01]), lut, jnp.array([100.0]), st))
        assert got == float(np.float32(BARRIER))

    def test_nan_lut_treated_as_zero(self):
        # NaN PDF values (empty hists) count as zero density
        # (nll_kernels.cpp:107).
        st = make_static([10.0, 10.0], [100, 100], [0, 1],
                         [1.0, 1.0], [0.0, 0.0], 2)
        lut = jnp.array([[1.0, jnp.nan], [1.0, 1.0]])
        norms = jnp.array([100.0, 100.0])
        got = float(nll(jnp.array([1.0, 1.0]), lut, norms, st))
        want = (-np.log(10 + 10) - np.log(0 + 10)) + 20.0
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_zero_density_event_skipped(self):
        # s_i <= 0 contributes nothing to the log sum
        # (nll_kernels.cpp:110-112).
        st = make_static([10.0], [100], [0], [1.0], [0.0], 1)
        lut = jnp.array([[1.0, 0.0]])
        norms = jnp.array([100.0])
        got = float(nll(jnp.array([1.0]), lut, norms, st))
        want = -np.log(10.0) + 10.0
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_systematic_constraint_only(self):
        # Constraints apply to systematic coefficients too
        # (nll_kernels.cpp:180-184); no rate barrier for them.
        st = make_static([10.0], [100], [0], [1.0, 0.0], [0.0, 0.5], 1)
        lut = jnp.ones((1, 3))
        norms = jnp.array([100.0])
        base = float(nll(jnp.array([1.0, 0.0]), lut, norms, st))
        shifted = float(nll(jnp.array([1.0, -1.0]), lut, norms, st))
        np.testing.assert_allclose(shifted - base, 0.5 * (1.0 / 0.5) ** 2,
                                   rtol=1e-4)
