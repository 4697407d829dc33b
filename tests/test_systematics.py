"""Golden-value tests for systematic transforms.

Replicates reference test/test_pdfz_syst.cpp exactly: each systematic's
expected densities AND the in-domain norm changes as events migrate across
the domain boundary.
"""

import numpy as np
import pytest

from sxmc_jax.ops.transforms import (
    SHIFT, SCALE, CTSCALE, RESOLUTION_SCALE, SystematicDesc,
    apply_systematics, systematic_type_from_name)
from sxmc_jax.pdf.evalhist import EvalHist

import jax.numpy as jnp


SAMPLES_1F = [0.1, 0.2, 0.3, 0.4, 0.5, 1.1, -0.1]
EVAL_POINTS = [[-0.1, 0], [0.0, 0], [0.25, 0], [0.5, 0], [0.75, 0], [1.0, 0]]


def run(ev, param):
    values, norm = ev.eval_points(EVAL_POINTS, params=[param])
    return np.asarray(values), float(norm)


def check(values, norm, exp_values, exp_norm):
    assert norm == exp_norm
    assert np.isnan(values[0]) and np.isnan(values[5])
    np.testing.assert_allclose(values[1:5], exp_values, rtol=1e-5)


class TestShift:
    """test_pdfz_syst.cpp:39-87."""

    def make(self):
        ev = EvalHist(SAMPLES_1F, 1, 1, [0.0], [1.0], [2])
        ev.add_systematic(SystematicDesc(SHIFT, obs=0, par_indices=(0,)))
        return ev

    def test_zero_shift(self):
        check(*run(self.make(), 0.0), [1.6, 1.6, 0.4, 0.4], 5)

    def test_neg_shift(self):
        check(*run(self.make(), -0.25), [1.5, 1.5, 0.5, 0.5], 4)

    def test_pos_shift(self):
        check(*run(self.make(), 0.25), [1.0, 1.0, 1.0, 1.0], 6)


class TestScale:
    """test_pdfz_syst.cpp:109-157."""

    def make(self):
        ev = EvalHist(SAMPLES_1F, 1, 1, [0.0], [1.0], [2])
        ev.add_systematic(SystematicDesc(SCALE, obs=0, par_indices=(0,)))
        return ev

    def test_zero_scale(self):
        check(*run(self.make(), 0.0), [1.6, 1.6, 0.4, 0.4], 5)

    def test_neg_scale(self):
        check(*run(self.make(), -0.1),
              [5.0 / 3, 5.0 / 3, 1.0 / 3, 1.0 / 3], 6)

    def test_pos_scale(self):
        check(*run(self.make(), 1.0), [1.0, 1.0, 1.0, 1.0], 4)


class TestResolutionScale:
    """test_pdfz_syst.cpp:162-272: truth field fixed at 0.7."""

    def make(self):
        samples = np.array(
            [[x, 0.7] for x in SAMPLES_1F], np.float32)
        ev = EvalHist(samples, 2, 1, [0.0], [1.0], [2])
        ev.add_systematic(SystematicDesc(
            RESOLUTION_SCALE, obs=0, par_indices=(0,), extra_field=1))
        return ev

    def test_zero(self):
        check(*run(self.make(), 0.0), [1.6, 1.6, 0.4, 0.4], 5)

    def test_neg(self):
        check(*run(self.make(), -0.30),
              [2.0 * 5 / 7, 2.0 * 5 / 7, 2.0 * 2 / 7, 2.0 * 2 / 7], 7)

    def test_pos(self):
        check(*run(self.make(), 0.30), [2.0, 2.0, 0.0, 0.0], 4)


class TestTransformMath:
    def test_ctscale(self):
        # x' = 1 + (x - 1)(1 + p)   (pdfz.cpp:323-325)
        x = jnp.array([[0.5], [-0.5], [1.0]])
        out = apply_systematics(
            x, jnp.array([0.2]),
            [SystematicDesc(CTSCALE, obs=0, par_indices=(0,))])
        np.testing.assert_allclose(
            np.asarray(out[:, 0]), [1 + (-0.5) * 1.2, 1 + (-1.5) * 1.2, 1.0],
            rtol=1e-6)

    def test_power_series(self):
        # p = p0 + p1 * x (pdfz.cpp:310-314); shift by p.
        x = jnp.array([[2.0]])
        out = apply_systematics(
            x, jnp.array([0.5, 0.25]),
            [SystematicDesc(SHIFT, obs=0, par_indices=(0, 1))])
        np.testing.assert_allclose(np.asarray(out[0, 0]),
                                   2.0 + 0.5 + 0.25 * 2.0, rtol=1e-6)

    def test_sequential_composition(self):
        # Later systematics see earlier transforms (pdfz.cpp:382-385).
        x = jnp.array([[1.0]])
        descs = [
            SystematicDesc(SHIFT, obs=0, par_indices=(0,)),
            SystematicDesc(SCALE, obs=0, par_indices=(1,)),
        ]
        out = apply_systematics(x, jnp.array([1.0, 0.5]), descs)
        np.testing.assert_allclose(np.asarray(out[0, 0]), (1 + 1) * 1.5,
                                   rtol=1e-6)

    def test_type_names(self):
        assert systematic_type_from_name("shift") == SHIFT
        assert systematic_type_from_name("scale") == SCALE
        assert systematic_type_from_name("ctscale") == CTSCALE
        assert systematic_type_from_name("resolution_scale") == \
            RESOLUTION_SCALE
        with pytest.raises(ValueError):
            systematic_type_from_name("bogus")
