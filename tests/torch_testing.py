"""Set-up shared by the port's tests: every ``tests/test_torch_*.py``
imports this module first.

On import it

  * runs the whole worker process on ONE intra-op thread
    (``torch.set_num_threads(1)``). The plain path's eager operations are
    small, and the test run puts several workers on the machine's cores at
    once: at torch's default thread count each worker oversubscribes them,
    and a graph test runs many times slower than alone. Nothing restores
    the default afterwards;
  * installs ``jax.experimental.enable_x64`` where JAX no longer has it
    (JAX 0.9): the reference's modules call it, and the shim forwards to
    ``jax.enable_x64``. A machine without JAX (the card's, which runs only
    the card tests) skips the shim.

It also exports ``reference_in_float64``, which runs reference modules with
their ``jnp.float32`` casts read as float64 (and, with ``wide_ints``, their
``jnp.int32`` as int64), so that a float64 port computation can be held to
the reference within 1e-9.
"""
from __future__ import annotations

import contextlib

import torch

torch.set_num_threads(1)

try:
    import jax
    import jax.experimental
except ImportError:   # the card's machine: no JAX, no reference
    jax = None

if jax is not None and not hasattr(jax.experimental, "enable_x64"):
    @contextlib.contextmanager
    def _enable_x64(new_val: bool = True):
        with jax.enable_x64(new_val):
            yield

    jax.experimental.enable_x64 = _enable_x64


class Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``; with
    ``wide_ints``, ``int32`` read as ``int64`` too (under x64 the LM loss's
    chunk scan sums an int64 mask count into its ``jnp.int32(0)`` carry,
    which JAX refuses)."""

    def __init__(self, wide_ints: bool = False):
        import jax.numpy as jnp

        self._jnp = jnp
        self._wide = {"float32": jnp.float64}
        if wide_ints:
            self._wide["int32"] = jnp.int64

    def __getattr__(self, name):
        return self._wide.get(name) or getattr(self._jnp, name)


@contextlib.contextmanager
def reference_in_float64(*modules, wide_ints: bool = False):
    """The reference modules' float32 casts made float64, under x64."""
    saved = [m.jnp for m in modules]
    for m in modules:
        m.jnp = Float64Numpy(wide_ints)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        for m, j in zip(modules, saved):
            m.jnp = j
