"""Builds the port's CUDA kernels and binds them through ctypes.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), the objects are linked into
one shared library with a plain C interface, and the library is loaded
with ``ctypes``.  Sources include no PyTorch headers, so a build takes
seconds rather than the minutes of ``torch.utils.cpp_extension.load``.

The build runs at first use, from the sources in this checkout, into
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``).  The library's file name carries a hash of the sources
and flags, so an edited source never loads a stale library.  Nothing
here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: argument types (every pointer and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints); each returns the
# cudaGetLastError() of its launch.
SIGNATURES: Dict[str, List] = {
    "qr_tile_preprocess": [_P] * 9 + [_I] * 6 + [_P],
    "qr_conv3x3_norm_relu": [_P] * 4 + [_I] * 4 + [_P],
    "qr_conv3x3_gap_corr": [_P] * 7 + [_I] * 5 + [_P],
    "qr_extractor_head": [_P] * 7 + [_I] * 4 + [_P],
    "qr_rs_decode": [_P] * 5 + [_I] + [_P],
}

# Launches per kernel wrapper: each wrapper adds one where it launches
# its kernel, and nowhere else (a CPU tensor takes the plain version and
# counts nothing).
launch_counts: Dict[str, int] = {
    "fused_tile_preprocess": 0, "fused_extractor": 0, "rs_decode": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + \
            [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the CUDA kernels cannot be built")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _tag(sources: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_parallel(cmds: List[List[str]]) -> List[str]:
    """Start every command at once, wait for all; raise with the
    compiler's output if any failed.  Returns each command's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"kernel build failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return outs


def build() -> Path:
    """Compile the sources into the shared library (if this exact
    source set is not built yet) and return its path."""
    sources = _sources()
    lib_path = BUILD_DIR / f"libqrmark_kernels_{_tag(sources)}.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        logs = _run_parallel([[compiler, *NVCC_FLAGS, "-c", str(s), "-o",
                               str(o)] for s, o in zip(sources, objs)])
        tmp_lib = Path(tmp) / lib_path.name
        _run_parallel([[compiler, "-shared", "-o", str(tmp_lib),
                        *map(str, objs)]])
        os.replace(tmp_lib, lib_path)
    build_info.update(path=str(lib_path), cached=False,
                      seconds=time.perf_counter() - t0,
                      log="".join(logs))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(name: str, err: int):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
