"""The byte counts reproduce the bounds the port's kernels were held to
on the card (3.35 TB/s, the data sheet's)."""
import pytest

from perfbench.cost import k1, k5, pe, peaks, swe

SWE = {"sim": {"grid_width": 2048, "grid_height": 2048}}
PE4 = {"sim": {"grid_width": 512, "grid_height": 512, "num_levels": 20}}


def test_k1_at_2048():
    assert k1.launch_bound_s(SWE) * 1e3 == pytest.approx(0.0300, abs=5e-5)
    assert k1.bound_s(SWE, 1000) == pytest.approx(
        1000 * k1.launch_bound_s(SWE))


def test_k5_at_512x20():
    assert k5.launch_bound_s(PE4, 3, 116) * 1e3 == pytest.approx(0.0761,
                                                                  abs=5e-5)
    assert k5.launch_bound_s(PE4, 5, 140) * 1e3 == pytest.approx(0.1268,
                                                                  abs=5e-5)
    # a step: 2 + 3 + 3 + 5 states
    assert k5.step_bound_s(PE4) == pytest.approx(
        13 * pe.state_bytes(PE4) / peaks.HBM_BYTES_PER_S)
    assert k5.bound_s(PE4, 400) == pytest.approx(100 * k5.step_bound_s(PE4))


def test_step_functions_are_bound_by_bytes():
    assert swe.step_bound_s(SWE) == pytest.approx(
        24 * 2048 ** 2 / peaks.HBM_BYTES_PER_S)
    assert pe.step_bound_s(PE4) == pytest.approx(
        2 * 81 * 512 ** 2 * 4 / peaks.HBM_BYTES_PER_S)
