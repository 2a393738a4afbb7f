"""The benchmark measures the port alone: neither JAX nor the JAX
package (``repro``) may be imported, by the harness or by anything it
loads.  Names are compared by their top-level part, whole, so the port
``repro_torch`` passes."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def top(name: str) -> str:
    return name.split(".")[0]


def forbidden_loaded(modules=None) -> list:
    """Forbidden modules present in ``sys.modules`` (or ``modules``)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if top(m) in FORBIDDEN)


def imports_of(path: Path):
    """Absolute module names a source file imports."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def forbidden_imports(root: Path) -> list:
    """(file, module) for every forbidden import under ``root``."""
    return [(str(p), m) for p in sorted(root.rglob("*.py"))
            for m in imports_of(p) if top(m) in FORBIDDEN]
