"""The modules a run may not load: JAX and the JAX package the port was
made from. Names are compared by their top-level part (before the first
dot) as a whole, since the port's own name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "plonky2_tpu"})


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
