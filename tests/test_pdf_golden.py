"""Golden-value tests for the binned PDF evaluator.

These replicate the reference gtest suite numerically:
  * 1-D fixtures and expected densities: test/test_pdfz.cpp:79-126,
    test/test_pdfz_fixtures.h:12-30
  * constructor validation: test/test_pdfz.cpp:42-73
  * histogram export with unit integral: test/test_pdfz.cpp:128-140
The numbers are backend-independent math and must match exactly.
"""

import numpy as np
import pytest

from sxmc_jax.pdf.evalhist import EvalHist, PdfError


SAMPLES = [0.1, 0.2, 0.3, 0.4, 0.5, 1.1, -0.1]
LOWER = [0.0]
UPPER = [1.0]
NBINS = [2]
# Eval points carry a dataset tag column (dataset 0).
EVAL_POINTS = [[-0.1, 0], [0.0, 0], [0.25, 0], [0.5, 0], [0.75, 0], [1.0, 0]]


def make_evaluator(**kw):
    return EvalHist(SAMPLES, 1, 1, LOWER, UPPER, NBINS, **kw)


class TestConstructor:
    def test_wrong_sample_size(self):
        with pytest.raises(PdfError):
            EvalHist(SAMPLES, 2, 1, LOWER, UPPER, NBINS)

    def test_nobs_larger_than_nfields(self):
        with pytest.raises(PdfError):
            EvalHist(SAMPLES, 1, 7, LOWER, UPPER, NBINS)

    def test_wrong_lower_size(self):
        with pytest.raises(PdfError):
            EvalHist(SAMPLES, 1, 1, [0.0, 0.0], UPPER, NBINS)

    def test_wrong_upper_size(self):
        with pytest.raises(PdfError):
            EvalHist(SAMPLES, 1, 1, LOWER, [1.0, 2.0], NBINS)

    def test_wrong_nbins_size(self):
        with pytest.raises(PdfError):
            EvalHist(SAMPLES, 1, 1, LOWER, UPPER, [2, 2])

    def test_zero_bins(self):
        with pytest.raises(PdfError):
            EvalHist(SAMPLES, 1, 1, LOWER, UPPER, [0])

    def test_zero_observables(self):
        with pytest.raises(PdfError):
            EvalHist(SAMPLES, 1, 0, [], [], [])


class TestEvaluation:
    def test_evaluation(self):
        # Reference: test_pdfz.cpp:79-96. 5 of 7 samples in [0,1);
        # bin0 holds {0.1..0.4} -> 4/(5*0.5)=1.6, bin1 holds {0.5} -> 0.4.
        ev = make_evaluator()
        values, norm = ev.eval_points(EVAL_POINTS)
        assert float(norm) == 5.0
        values = np.asarray(values)
        assert np.isnan(values[0])
        np.testing.assert_allclose(values[1:5], [1.6, 1.6, 0.4, 0.4],
                                   rtol=1e-6)
        assert np.isnan(values[5])

    def test_dataset_mismatch_gives_zero(self):
        # read_bins == -2 -> 0.0 (pdfz.cpp:289-293, 424-426).
        ev = make_evaluator(dataset=1)
        values, norm = ev.eval_points(EVAL_POINTS)
        values = np.asarray(values)
        assert np.isnan(values[0])  # out-of-domain still NaN
        np.testing.assert_array_equal(values[1:5], 0.0)
        assert np.isnan(values[5])

    def test_histogram_unit_integral(self):
        # Reference: test_pdfz.cpp:128-140.
        ev = make_evaluator()
        dens = ev.density_histogram()
        assert dens.shape == (2,)
        np.testing.assert_allclose(dens, [1.6, 0.4], rtol=1e-6)
        width = 0.5
        np.testing.assert_allclose(dens.sum() * width, 1.0, rtol=1e-6)

    def test_weighted_samples(self):
        # Weights were a planned reference feature
        # (test_pdfz_fixtures.h:46-47): doubling one sample's weight.
        ev = EvalHist(SAMPLES, 1, 1, LOWER, UPPER, NBINS,
                      weights=[2, 1, 1, 1, 1, 1, 1])
        values, norm = ev.eval_points(EVAL_POINTS)
        assert float(norm) == 6.0
        values = np.asarray(values)
        np.testing.assert_allclose(values[1], 5 / (6 * 0.5), rtol=1e-6)
        np.testing.assert_allclose(values[3], 1 / (6 * 0.5), rtol=1e-6)

    def test_get_samples(self):
        ev = make_evaluator(dataset=3)
        sv = ev.get_samples()
        assert sv.shape == (7, 2)
        np.testing.assert_array_equal(sv[:, 1], 3.0)
        np.testing.assert_allclose(sv[:, 0], SAMPLES, rtol=1e-6)


class TestEvaluation2D:
    """2-D fixtures: test/test_pdfz_2d.cpp + test_pdfz_fixtures_2d.h.

    Seven (x, y) samples on [0,1)x[0,2) with 2x3 bins; bin area
    0.5 * (2/3); 6 samples in-domain.
    """

    def setup_method(self):
        # Hand-built 2-D fixture with the same structure as the reference:
        # row-major layout, one sample out of domain.
        self.samples = np.array([
            [0.1, 0.1],
            [0.2, 0.7],
            [0.3, 0.7],
            [0.6, 1.5],
            [0.7, 1.5],
            [0.8, 1.5],
            [1.5, 0.5],   # out of domain in x
        ], np.float32)
        self.ev = EvalHist(self.samples, 2, 2, [0.0, 0.0], [1.0, 2.0],
                           [2, 3])

    def test_norm_and_density(self):
        pts = np.array([
            [0.1, 0.1, 0],   # bin (0,0): 1 sample
            [0.2, 0.8, 0],   # bin (0,1): 2 samples
            [0.7, 1.5, 0],   # bin (1,2): 3 samples
            [0.7, 0.1, 0],   # bin (1,0): 0 samples
            [-1., 0.1, 0],   # out of domain -> NaN
        ], np.float32)
        values, norm = self.ev.eval_points(pts)
        assert float(norm) == 6.0
        area = 0.5 * (2.0 / 3.0)
        values = np.asarray(values)
        np.testing.assert_allclose(
            values[:4], np.array([1, 2, 3, 0]) / (6 * area), rtol=1e-6)
        assert np.isnan(values[4])

    def test_row_major_layout(self):
        # Flat id = ix * 3 + iy (pdfz.cpp:207-215).
        bins, norm = self.ev.histogram()
        bins = np.asarray(bins).reshape(2, 3)
        np.testing.assert_array_equal(bins, [[1, 2, 0], [0, 0, 3]])
