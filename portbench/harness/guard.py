"""What the benchmark's process may not hold: jax, its libraries, or the
JAX package. Names are compared by their top-level part (before the
first dot) whole: the port `hackathonopticalflow_tpu_torch` begins with the
JAX package's name and is not it."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "hackathonopticalflow_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if top_level(m) in FORBIDDEN)
