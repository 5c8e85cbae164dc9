"""What the benchmark must not load: JAX, and the JAX package that the port
(graphvite_tpu_torch) was made from. Names are compared whole, by the
part before the first dot: graphvite_tpu_torch starts with graphvite_tpu
and is not that package."""
from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "graphvite_tpu")
PROGRAM = ("graphvite_tpu_torch",) + FORBIDDEN
HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCE_DIR = os.path.join(HERE, "reference")


def top(name):
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None):
    """Top-level names of loaded modules that are forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({top(n) for n in modules} & set(FORBIDDEN))


def imported_names(path):
    """Top-level names of every module that the file imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(top(node.module))
    return out


def reference_files(directory=REFERENCE_DIR):
    """The references' files, and init.py, which they read."""
    return ([os.path.join(directory, n) for n in sorted(os.listdir(directory))
             if n.endswith(".py")] + [os.path.join(HERE, "init.py")])


def reference_imports_program(files=None):
    """Names of the reference files that import the program or JAX."""
    files = reference_files() if files is None else files
    return [os.path.basename(p) for p in files
            if imported_names(p) & set(PROGRAM)]
