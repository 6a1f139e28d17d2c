"""Test-session set-up shared by every test under this directory.

Every JAX pipeline of a test process shares one on-device RS decoder per
RS code (``tests/shared_rs.py``).  Only the attribute ``StageRegistry``
reads is patched: ``repro.core.detect.make_device_rs`` stays the
original, and a test's own ``MonkeyPatch`` of ``stages.make_device_rs``
still overrides this one within its scope.  Where JAX is not installed
(a machine that runs only the PyTorch port) nothing is patched.
"""
import sys
from pathlib import Path

import pytest

TESTS = str(Path(__file__).resolve().parent / "tests")
if TESTS not in sys.path:
    sys.path.insert(0, TESTS)

from shared_rs import memoized  # noqa: E402


@pytest.fixture(scope="session", autouse=True)
def _one_device_rs_per_code():
    try:
        from repro.core import stages
    except ImportError:
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stages, "make_device_rs", memoized(stages.make_device_rs))
        yield
