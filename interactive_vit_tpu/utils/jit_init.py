"""Jit model parameter initializers into ONE device program.

Eager random init dispatches one tiny program per leaf — dozens to
hundreds of device dispatches per model, each paying launch latency and
a host round trip. A serving worker registers every model at boot, so
that cost repeats per model and per recycled generation
(serving/recycle.py).

``@jitted_init`` wraps an ``init_params(key, *static...)`` so the whole
initializer traces into one XLA program: one dispatch per boot, and the
program lands in the persistent compilation cache so later boots pay
only the execution. Values match the eager path to within a few ULP of
the target dtype, not bit for bit: ``jax.random`` is functional, but XLA
may fuse the random-bits -> normal-transform -> scale chain differently
from the eager per-op programs (pinned by
``tests/test_utils.py::test_jitted_init_values_match_eager``).

Everything after the leading PRNG key is treated as STATIC (configs are
frozen dataclasses — hashable; dtypes and ints likewise), so each
(cfg, dtype) combination compiles once.
"""

from __future__ import annotations

import functools
import inspect


def jitted_init(fn):
    import os

    import jax

    sig = inspect.signature(fn)
    names = list(sig.parameters)
    jf = jax.jit(fn, static_argnames=tuple(names[1:]))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        # Accelerator backends only: that is where the per-dispatch
        # cost lives, and on the CPU backend two full-suite runs
        # segfaulted inside a LATER unrelated XLA:CPU compile (swin
        # sharded-remat train) with the extra init executables in the
        # process — reproducible only with ~600 tests of accumulated
        # state, native frame unknown, module/standalone always green.
        # Eager on CPU restores the previously stable suite exactly;
        # IVT_JIT_INIT=1 forces the jitted path (the parity test).
        if (jax.default_backend() == "cpu"
                and os.environ.get("IVT_JIT_INIT") != "1"):
            return fn(*args, **kwargs)
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        kw = dict(bound.arguments)
        key = kw.pop(names[0])
        return jf(key, **kw)

    wrapper.__wrapped_eager__ = fn  # tests compare against the original
    return wrapper
