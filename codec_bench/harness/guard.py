"""The check that nothing of JAX or of the JAX package is loaded.

Names are compared whole at their first dot, because the port's name
(`jpezy_tpu_torch`) begins with the JAX package's (`jpezy_tpu`)."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "jpezy_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """Sorted keys of `modules` (default sys.modules) whose top-level name
    is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in list(names) if n.split(".", 1)[0] in FORBIDDEN)


class ForbiddenImport(RuntimeError):
    pass


def check(when: str) -> None:
    """Raise ForbiddenImport naming what is loaded."""
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"{when}: forbidden modules loaded: "
                              + ", ".join(found))
