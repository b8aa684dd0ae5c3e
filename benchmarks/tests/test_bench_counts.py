"""The operation and byte counts (benchmarks/counts/) against a hand
count at a tiny shape."""

import pytest

from fitbench import peaks, spec

SHAPE = {"G": 2, "n": 3, "P": 2, "K": 2}


def test_kernel_bytes_are_each_operand_once():
    # K1: Q (K x K), b, z in and x out per system; K5: Lam, M, EYt (K
    # each), yty, g in and ps, sse out per feature
    assert spec.counts("chol_sample").nbytes(SHAPE) == 4 * 4 * (4 + 6)
    assert spec.counts("sse_ps").nbytes(SHAPE) == 4 * 4 * (6 + 4)
    # the repo's north-star reckoning: K1 3.54 MB, K5 1.13 MB at B = 10,048
    ns = {"G": 64, "n": 500, "P": 157, "K": 8}
    assert spec.counts("chol_sample").nbytes(ns) == 3_536_896
    assert spec.counts("sse_ps").nbytes(ns) == 1_125_376


def test_kernel_flops_by_hand():
    # K = 2: Cholesky 1 + 1 (sqrt, divide) + 2 + 1 (update, sqrt) = 5;
    # forward 1 + 3 = 4; two backward solves 7 + 3 = 10; the sum 2
    assert spec.counts("chol_sample").flops(SHAPE) == 4 * (5 + 4 + 10 + 2)
    assert spec.counts("sse_ps").flops(SHAPE) == 4 * (4 * 2 + 6)


def test_combine_counts_by_hand():
    c = spec.counts("combine")
    # 3 upper pairs of 2 x 2 panels, read and written once, plus
    # Lambda (8), ps (4), Z (12) and X (6) read once
    assert c.nbytes(SHAPE) == 2 * 3 * 4 * 4 + 4 * (8 + 4 + 12 + 6)
    # H: 4 pairs x K^2 x n multiply-adds; panels: 3 x (2 P K^2 + 2 P^2 K);
    # the diagonal's 1/ps and the add
    assert c.flops(SHAPE) == (2 * 4 * 3 * 4 + 3 * (2 * 2 * 4 + 2 * 4 * 2)
                              + 4 + 3 * 4)


def test_sweep_flops_lead_with_the_products():
    f = spec.counts("sweep").flops
    big = {"G": 64, "n": 500, "P": 157, "K": 8}
    gemm = 2.0 * 64 * 500 * 157 * 8
    assert 5 * gemm < f(big) < 6 * gemm
    assert f(SHAPE) > 0


def test_roofline_takes_the_larger_bound():
    assert peaks.roofline_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.roofline_s(0, 67e12) == pytest.approx(1.0)
    assert peaks.roofline_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
