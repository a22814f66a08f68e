"""The check that a run loaded no JAX: whole top-level module names."""

from __future__ import annotations

import sys

# top-level names that must never be loaded in a run: JAX itself, its
# compiled half, Flax, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "pluto_gps_sim_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Sorted loaded module names whose top-level name (the part before
    the first dot) is one of FORBIDDEN, compared whole: the port's
    ``pluto_gps_sim_tpu_torch`` starts with the JAX package's name and
    is not one."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
