"""The copied operation count of the decode."""
import pytest

import flops

WIDTH = dict(channels=64, depth=7, n_bits=60)


def test_extractor_flops_at_the_serve_width():
    assert flops.extractor_flops(1, 64, **WIDTH) / 1e9 == pytest.approx(
        2.126, abs=5e-4)
    assert flops.extractor_flops(32, 64, **WIDTH) / 1e9 == pytest.approx(
        68.03, abs=5e-3)


def test_least_time_is_operation_bound_at_both_rungs():
    peaks = flops.PEAKS["NVIDIA H100 80GB HBM3"]
    ex = dict(WIDTH)
    fp32 = flops.least_seconds(32, 64, ex, "fp32", peaks)
    assert fp32 * 1e3 == pytest.approx(1.0154, abs=1e-4)
    int8 = flops.least_seconds(32, 64, ex, "int8", peaks)
    assert int8 * 1e3 == pytest.approx(0.0344, abs=1e-4)
    assert flops.decode_bytes(32, 64, dtype="int8", **WIDTH) / \
        peaks["bytes_s"] < int8
