"""One on-device RS decoder per RS code per process, for the JAX reference.

Every ``StageRegistry`` with ``rs_mode="device"`` calls
``repro.core.stages.make_device_rs``, which wraps the Pallas
Berlekamp-Welch kernel in a fresh ``jax.jit``.  On the CPU the kernel
runs in interpret mode, and each fresh jit traces and lowers it again for
every batch shape it sees (about 15 s a shape), so a test that builds
eight pipelines paid that eight times.  The decoder is a pure function:
sharing one per code shares only its trace and compile, never what a
pipeline decodes.  The default code still gets the Pallas kernel and any
other code ``jax_rs``, since the original ``make_device_rs`` builds each
decoder the first time its code is asked for.

Installed for every test process by the ``conftest.py`` at the root of
the repository.  Not named test_*.py on purpose — pytest must not
collect it.
"""
from __future__ import annotations

from typing import Callable


def memoized(make: Callable) -> Callable:
    """``make`` returning the same decoder for the same ``(m, n, k)``;
    keyed on the code's parameters so ``RSCode`` need not be hashable."""
    made = {}

    def make_shared(code):
        key = (code.m, code.n, code.k)
        if key not in made:
            made[key] = make(code)
        return made[key]

    return make_shared
