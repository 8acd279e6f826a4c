"""``climjit`` and ``climjit_chain`` with the reference's names and call
signatures (reference: xclim_tpu/core/jit_wrapper.py).

The JAX package traces a whole index pipeline into one XLA program and
keeps fingerprints, a trace cache and a compile-capacity bisection for its
compiler. PyTorch runs the same pipeline eagerly, op by op, each op on the
device of its data, so both wrappers only call through:
``climjit(fn)(*args)`` is ``fn(*args)``, and ``climjit_chain(steps)(*args)``
is the tuple of every step's outputs in order.
"""

from __future__ import annotations

import functools

__all__ = ["climjit", "climjit_chain"]


def climjit(fn, on_capacity_error: str = "eager"):
    """``fn`` itself, run eagerly. ``on_capacity_error`` is accepted for
    the reference's signature; no compile step can fail here."""
    if on_capacity_error not in ("eager", "raise"):
        raise ValueError(f"on_capacity_error must be 'eager' or 'raise', "
                         f"got {on_capacity_error!r}")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return fn(*args, **kwargs)

    return wrapped


def climjit_chain(steps):
    """Run a list of index/indicator calls sharing one argument signature;
    returns the tuple of their outputs in order (a step that returns a
    tuple or list contributes each of its items).

    ``wrapped.partition`` lists the (start, stop) step ranges run as one
    program, as the reference's does; the whole chain is one eager pass,
    so it is ``[(0, len(steps))]``."""
    steps = list(steps)

    def wrapped(*args, **kwargs):
        outs = []
        for step in steps:
            o = step(*args, **kwargs)
            outs.extend(o if isinstance(o, (list, tuple)) else (o,))
        return tuple(outs)

    wrapped.partition = [(0, len(steps))]
    return wrapped
