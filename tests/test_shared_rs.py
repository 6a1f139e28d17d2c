"""The per-process RS decoder memo that the repository's root
``conftest.py`` installs (``tests/shared_rs.py``): every JAX pipeline of a
test process shares one on-device decoder per code, and it decodes every
word exactly as a decoder that ``make_device_rs`` builds directly does
(the Pallas kernel for the default code, ``jax_rs`` for any other).  The
conftest also imports, and its fixture runs, on a machine without JAX."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import detect, stages
from repro.core.detect import DetectionConfig, DetectionPipeline
from repro.core.extractor import init_extractor
from repro.core.rs.codec import DEFAULT_CODE, RSCode
from test_torch_rs_codes import _words

CODES = {"default": DEFAULT_CODE, "k11": RSCode(m=4, n=15, k=11)}
FIELDS = ("ok", "message_bits", "n_corrected")


@pytest.fixture(scope="module", params=list(CODES))
def shared(request):
    """The decoder two pipelines of this process got for the code."""
    code = CODES[request.param]
    params = init_extractor(jax.random.key(0),
                            n_bits=code.codeword_bits, channels=8, depth=2)
    cfg = DetectionConfig(tile=16, img_size=32, resize_src=40, code=code,
                          rs_mode="device")
    a = DetectionPipeline(cfg, params)
    b = DetectionPipeline(cfg, params)
    return code, a.stages._device_rs, b.stages._device_rs


def test_pipelines_share_one_decoder(shared):
    _, a, b = shared
    assert a is not None
    assert a is b


def test_shared_decoder_equals_a_direct_one(shared):
    """Clean codewords, 1..t+2 symbol errors and uniform words."""
    code, dev, _ = shared
    _, words = _words((code.m, code.n, code.k), np.random.default_rng(42),
                      per=8)
    bits = jnp.asarray(words)
    out = dev(bits)
    ref = detect.make_device_rs(code)(bits)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(out[f]), np.asarray(ref[f]),
                                      err_msg=f)


def test_only_the_registrys_factory_is_shared():
    """``repro.core.detect.make_device_rs`` (a re-export bound at import)
    stays the original, so tests of it build their own decoder."""
    assert detect.make_device_rs is not stages.make_device_rs
    code = CODES["k11"]
    assert stages.make_device_rs(code) is stages.make_device_rs(code)


def test_conftest_runs_without_jax(tmp_path):
    """With ``jax`` unimportable, the conftest imports, its fixture runs
    and installs nothing, and a test of the port's CUDA kernels is
    collected and run (it skips without a card, and passes with one)."""
    (tmp_path / "no_jax.py").write_text(
        "import sys\nsys.modules['jax'] = None\n")
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no_jax", "-rs",
         "tests/test_torch_cuda.py::test_rs_kernel_rejects_misaligned_bits"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={**{k: v for k, v in os.environ.items()
                if not k.startswith("PYTEST_")},
             "PYTHONPATH": f"{tmp_path}:{root / 'src'}"})
    out = f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert r.returncode == 0, out
    assert "1 passed" in r.stdout or "1 skipped" in r.stdout, out
    assert "error" not in r.stdout.lower(), out
