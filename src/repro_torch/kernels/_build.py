"""Builds the port's CUDA kernels and binds them through ctypes.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together; ``*.cuh`` are their shared
headers), the objects are linked into
one shared library with a plain C interface, and the library is loaded
with ``ctypes``.  Sources include no PyTorch headers, so a build takes
seconds rather than the minutes of ``torch.utils.cpp_extension.load``.

The build runs at first use, from the sources in this checkout, into
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), or into the directory :func:`use_build_dir` names (the
serve launcher's ``--compilation-cache``).  The library's file name carries a hash of the sources
and flags, so an edited source never loads a stale library.  Nothing
here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

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
    "qr_tile_preprocess": [_P] * 4 + [_I] * 6 + [_P],
    "qr_preprocess": [_P] * 3 + [_I] * 4 + [_P],
    "qr_conv3x3_norm_relu": [_P] * 4 + [_I] * 5 + [_P],
    "qr_conv3x3_norm_relu_blocked": [_P] * 4 + [_I] * 8 + [_P],
    "qr_conv3x3_gap_corr": [_P] * 7 + [_I] * 6 + [_P],
    "qr_extractor_head": [_P] * 7 + [_I] * 5 + [_P],
    "qr_conv3x3_imma": [_P] * 7 + [_I] * 4 + [_P],
    "qr_conv3x3_imma_blocked": [_P] * 8 + [_I] * 7 + [_P],
    "qr_conv3x3_gap_corr_imma": [_P] * 9 + [_I] * 5 + [_P],
    "qr_rs_decode": [_P] * 5 + [_I] + [_P],
    "qr_escalation_plan": [_P] * 3 + [_I] * 8 + [_P],
}

# Launches per kernel wrapper: each wrapper adds one where it launches
# its kernel, and nowhere else (a CPU tensor takes the plain version and
# counts nothing).  Lanes launch from several threads at once, so every
# increment and reset holds ``count_lock`` (``count``, ``count_kernel``).
launch_counts: Dict[str, int] = {
    "fused_tile_preprocess": 0, "fused_preprocess": 0, "fused_extractor": 0,
    "fused_extractor_blocked": 0, "rs_decode": 0, "escalation_plan": 0}

# Launches per CUDA kernel of the decode ops, by the kernel's name as
# ``ptxas`` and the profiler print it without spaces (for example
# ``conv_regtile_kernel<qr::RF32,64,64>``): the per-layer launchers of
# ``fused_extractor`` each add one where they launch their kernel.
kernel_launches: Dict[str, int] = {}
count_lock = threading.Lock()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def count(op: str):
    """Count one launch of the kernel wrapper ``op``."""
    with count_lock:
        launch_counts[op] += 1


def count_kernel(name: str):
    """Count one launch of the decode's CUDA kernel ``name``."""
    with count_lock:
        kernel_launches[name] = kernel_launches.get(name, 0) + 1


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
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
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


def use_build_dir(path) -> Path:
    """Build (and look for) the kernel library in ``path`` instead of
    ``BUILD_DIR``'s default: a library built there by an earlier process
    of the same sources is loaded without compiling.  Takes effect only
    before the library is loaded in this process; returns the directory
    the loaded (or next) library lives in."""
    global BUILD_DIR
    with _lock:
        if _lib is None:
            BUILD_DIR = Path(path).resolve()
            return BUILD_DIR
        return Path(build_info["path"]).parent


def load(path, names=tuple(SIGNATURES)) -> ctypes.CDLL:
    """A built kernel library with the C entry points ``names`` bound."""
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def build_variants(dirs: Dict[str, Path]) -> Dict[str, Tuple[Path, str]]:
    """Build each directory's ``*.cu`` sources (with the headers beside
    them) into a library of its own, ``<dir>/libvariant.so``: every
    source of every directory in one parallel round of ``nvcc``.  For
    measuring variants of the sources; returns {name: (library path,
    ``ptxas -v`` log)}."""
    compiler = nvcc()
    jobs = [(name, src) for name, d in dirs.items()
            for src in sorted(Path(d).glob("*.cu"))]
    logs = _run_parallel([[compiler, *NVCC_FLAGS, "-c", str(src), "-o",
                           str(src.with_suffix(".o"))] for _, src in jobs])
    out = {}
    for name, d in dirs.items():
        objs = [str(src.with_suffix(".o")) for n, src in jobs if n == name]
        lib = Path(d) / "libvariant.so"
        _run_parallel([[compiler, "-shared", "-o", str(lib), *objs]])
        out[name] = (lib, "".join(log for (n, _), log in zip(jobs, logs)
                                  if n == name))
    return out


def demangle(names: List[str]) -> List[str]:
    """Kernel names as ``c++filt`` prints them, without the ``void``
    before them and the argument list after (as given where ``c++filt``
    is not there)."""
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
    return [_without_args(n).removeprefix("void ") for n in names]


def _without_args(name: str) -> str:
    """A demangled name without its trailing argument list (the name
    itself may hold parentheses: ``(anonymous namespace)::f``)."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += (name[i] == ")") - (name[i] == "(")
        if depth == 0:
            return name[:i] if name.endswith(")") else name
    return name


def kernel_registers(log: str) -> Dict[str, Tuple[int, ...]]:
    """``ptxas -v`` per kernel: {name: (registers, spill stores, spill
    loads, stack frame bytes, cumulative stack bytes)}, names as
    :func:`demangle` gives them.  A kernel's frame and spills are its own
    ("Function properties for" it); the cumulative stack adds the frames
    of the functions it calls."""
    rows, frames, name, props = [], {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props:
            frames[props] = (int(m.group(2)), int(m.group(3)),
                             int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            cum = re.search(r"(\d+) bytes cumulative stack size", line)
            rows.append((name, int(m.group(1))) +
                        frames.get(name, (0, 0, 0)) +
                        (int(cum.group(1)) if cum else 0,))
            name = None
    return {n: r[1:] for n, r in zip(demangle([r[0] for r in rows]), rows)}


def registers_of(regs: Dict[str, Tuple[int, ...]], kernel: str):
    """The :func:`kernel_registers` row of the one kernel whose name,
    without spaces, holds ``kernel`` (``None`` unless exactly one)."""
    hits = [v for k, v in regs.items() if kernel in k.replace(" ", "")]
    return hits[0] if len(hits) == 1 else None


def current_stream(device) -> int:
    """The raw handle of PyTorch's current stream on the CUDA ``device``
    (what ``torch.cuda.current_stream(device).cuda_stream`` gives, read
    without making a Stream object)."""
    import torch
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check(name: str, err: int):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
