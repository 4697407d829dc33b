"""Compensated-accumulation NLL at the 10^7-event scale.

The reference accumulates the event log-sum and total NLL in double
(reference: src/nll_kernels.cpp:89-116, 149-188).  At 10^7 events the
NLL is ~10^7, where the plain-f32 quantum (~1) exceeds the dNLL = 0.5
interval scale; sxmc_jax carries the sums as TwoSum (hi, lo) f32 pairs
(ops/nll.py) instead.  These tests pin that behavior against host-f64
references:

  * df_sum matches an f64 sum to ~1e-3 absolute at 10^7 elements where
    the plain f32 sum is off by O(1);
  * nll_pair resolves dNLL between nearby parameter points to well
    under the 0.5 interval scale;
  * the Metropolis accept decision (sign of delta) agrees with the f64
    reference.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sxmc_jax.ops.nll import NLLStatic, df_diff, df_sum, nll_pair

N_EVENTS = 10_000_000


@pytest.fixture(scope="module")
def big_logs():
    rng = np.random.default_rng(77)
    # Typical per-event log-density magnitudes for an extended-ML fit.
    return (rng.normal(1.0, 0.7, N_EVENTS)).astype(np.float32)


class TestDfSum:
    def test_matches_f64_at_1e7(self, big_logs):
        hi, lo = jax.jit(df_sum)(jnp.asarray(big_logs))
        got = float(np.float64(hi) + np.float64(lo))
        want = float(np.sum(big_logs.astype(np.float64)))
        assert abs(got - want) < 1e-3, (got, want)

    def test_plain_f32_actually_loses(self, big_logs):
        # Sanity: the problem df_sum solves is real at this scale — a
        # strictly sequential f32 sum is off by O(1) or worse.
        s = np.float32(0.0)
        chunk = big_logs[:200_000]
        for block in chunk.reshape(-1, 1000):
            s = np.float32(s + np.float32(block.sum(dtype=np.float32)))
        wide = chunk.sum(dtype=np.float64)
        seq_err = abs(float(s) - wide)
        hi, lo = jax.jit(df_sum)(jnp.asarray(chunk))
        df_err = abs(float(np.float64(hi) + np.float64(lo)) - wide)
        assert df_err < 1e-4
        assert df_err < seq_err or seq_err < 1e-4

    def test_exact_on_small_input(self):
        x = jnp.asarray([1.0, 2.0, 3.0, 4.5], jnp.float32)
        hi, lo = df_sum(x)
        assert float(hi) + float(lo) == 10.5

    def test_odd_lengths(self):
        rng = np.random.default_rng(3)
        for n in (1, 2, 3, 17, 1001):
            x = rng.normal(0, 1, n).astype(np.float32)
            hi, lo = df_sum(jnp.asarray(x))
            want = x.sum(dtype=np.float64)
            assert abs(float(np.float64(hi) + np.float64(lo)) - want) \
                < 1e-5


def _host_f64_nll(pars, lut, norms, st):
    """f64 reference of the NLL pipeline (f32 lut/einsum, f64 sums)."""
    pars = np.asarray(pars, np.float64)
    rates = pars[np.asarray(st.source_id)]
    w32 = (rates * st.nexpected * norms / st.n_mc).astype(np.float32)
    s = (w32[None, :].astype(np.float32) @ lut).ravel().astype(np.float32)
    logs = np.log(s.astype(np.float64), where=s > 0,
                  out=np.zeros(len(s)))
    total = -logs.sum() + w32.astype(np.float64).sum()
    con = st.sigmas > 0
    z = (pars - st.means) / np.where(con, st.sigmas, 1.0)
    return total + 0.5 * np.sum(np.where(con, z * z, 0.0))


class TestNllPairAtScale:
    @pytest.fixture(scope="class")
    def fit(self):
        rng = np.random.default_rng(41)
        nev = 2_000_000  # NLL ~ 5e6: f32 quantum 0.5 — already fatal
        lut = rng.uniform(0.2, 1.8, (2, nev)).astype(np.float32)
        st = NLLStatic(
            nexpected=np.asarray([0.6 * nev, 0.4 * nev], np.float32),
            n_mc=np.asarray([1e6, 1e6], np.float32),
            source_id=np.asarray([0, 1], np.int32),
            means=np.asarray([1.0, 1.0], np.float32),
            sigmas=np.asarray([0.0, 0.1], np.float32),
            nsources=2)
        norms = np.asarray([1e6, 1e6], np.float32)
        return lut, norms, st

    def test_absolute_value(self, fit):
        lut, norms, st = fit
        pars = np.asarray([1.0, 1.0], np.float32)
        hi, lo = jax.jit(lambda p, l: nll_pair(p, l, norms, st))(
            pars, jnp.asarray(lut))
        got = float(np.float64(hi) + np.float64(lo))
        want = _host_f64_nll(pars, lut, norms, st)
        # Tolerance budget: per-event f32 log rounding accumulates as
        # ~sqrt(n) * eps ~ 2e-4; accumulation itself is ~exact.
        assert abs(got - want) < 0.05 * max(1.0, abs(want) * 1e-6), \
            (got, want)
        assert abs(got - want) < 0.05

    def test_dnll_resolves_interval_scale(self, fit):
        """dNLL between nearby points is exact to << 0.5 at NLL ~ 5e6."""
        lut, norms, st = fit
        f = jax.jit(lambda p, l: nll_pair(p, l, norms, st))
        lutj = jnp.asarray(lut)
        p0 = np.asarray([1.0, 1.0], np.float32)
        deltas_got, deltas_want = [], []
        for eps in (1e-4, 3e-4, 1e-3):
            p1 = np.asarray([1.0 + eps, 1.0], np.float32)
            hi0, lo0 = f(p0, lutj)
            hi1, lo1 = f(p1, lutj)
            got = float(np.float64(hi1) + np.float64(lo1)
                        - np.float64(hi0) - np.float64(lo0))
            want = (_host_f64_nll(p1, lut, norms, st)
                    - _host_f64_nll(p0, lut, norms, st))
            deltas_got.append(got)
            deltas_want.append(want)
            assert abs(got - want) < 0.02, (eps, got, want)
        # The deltas themselves are O(0.01..10): they must be resolved,
        # not rounded to the f32 quantum (~0.5 at this NLL scale).
        assert all(abs(g) > 0 for g in deltas_got)

    def test_df_diff_matches_f64(self, fit):
        """The in-chain accept statistic delta = cur - prop is exact."""
        lut, norms, st = fit
        f = jax.jit(lambda p, l: nll_pair(p, l, norms, st))
        lutj = jnp.asarray(lut)
        rng = np.random.default_rng(7)
        for _ in range(5):
            pa = np.asarray([1.0, 1.0], np.float32)
            pb = (pa + rng.normal(0, 3e-4, 2)).astype(np.float32)
            ha, la = f(pa, lutj)
            hb, lb = f(pb, lutj)
            delta = float(df_diff(ha, la, hb, lb))
            want = (_host_f64_nll(pa, lut, norms, st)
                    - _host_f64_nll(pb, lut, norms, st))
            assert abs(delta - want) < 0.02, (delta, want)
            if abs(want) > 0.05:  # acceptance sign must agree
                assert np.sign(delta) == np.sign(want)
