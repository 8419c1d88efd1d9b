"""The check that a run measured the port alone: no module of the JAX
package, of JAX or of flax is loaded in the process that prints the
result. Names are compared by their top-level part, whole: the port's
``zkfhe_tpu_torch`` begins with the JAX package's name and is allowed.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "zkfhe_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """Sorted names of loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
