"""The check that no module of JAX or of the JAX package is loaded.

Names are compared by their whole top-level part (before the first dot), so
`frieda_tpu_torch`, the port, is not `frieda_tpu`, the JAX package.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "frieda_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among `modules` (default: sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
