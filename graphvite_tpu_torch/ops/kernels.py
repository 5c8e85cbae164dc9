"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source is one kernel with a plain C interface. `build()` compiles
every source that is not built yet with nvcc for sm_90a, one nvcc process
per source, all started together, into BUILD_DIR (inside the checkout, in
a directory .gitignore lists), keyed by a digest of the source, the shared
headers and the flags. `library(name)` loads one with ctypes; the wrapper
modules (ops/scatter.py, ops/gather.py) declare its functions' types.
Nothing here runs when a module is imported: the first launch builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

from graphvite_tpu_torch.utils import tracing

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build",
                         "graphvite_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def sources():
    """Kernel names: the csrc/*.cu files without their extension."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def library_path(name):
    """Where `name`'s library lives once built (the digest covers the
    source, every csrc/*.cuh header and the flags)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, "libgv_%s-%s.so" % (name,
                                                        h.hexdigest()[:16]))


@tracing.setup_stage(tracing.KERNELS_BUILD)
def build(verbose=False):
    """Compile every kernel whose library is missing (every kernel with
    `verbose`, which adds -Xptxas -v) in parallel; raise if any nvcc
    fails. Returns {name: library path}, and with `verbose` also {name:
    compiler report}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: library_path(name) for name in sources()}
    reports = {}
    failed = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = {}
        for name, path in paths.items():
            if os.path.exists(path) and not verbose:
                continue
            tmp_so = os.path.join(tmp, name + ".so")
            cmd = ([_nvcc()] + NVCC_FLAGS
                   + (["-Xptxas", "-v"] if verbose else [])
                   + ["-o", tmp_so, os.path.join(CSRC, name + ".cu")])
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp_so)
        for name, (proc, tmp_so) in jobs.items():
            out, _ = proc.communicate()
            reports[name] = out
            if proc.returncode != 0:
                failed.append("%s (%d):\n%s" % (name, proc.returncode, out))
            else:
                os.replace(tmp_so, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return (paths, reports) if verbose else paths


@functools.lru_cache(maxsize=None)
def library(name):
    """The ctypes library of kernel `name` (building what is missing
    first), with its error-string function typed."""
    lib = ctypes.CDLL(build()[name])
    lib.gv_error_string.argtypes = [ctypes.c_int]
    lib.gv_error_string.restype = ctypes.c_char_p
    return lib


def aligned(*tensors):
    """Every pointer aligned for the kernels' 4-column vectors: 16 bytes
    for float32 rows, 8 for bfloat16 rows."""
    return all(t.data_ptr() % (8 if t.element_size() == 2 else 16) == 0
               for t in tensors)


def check_launch(lib, rc, what):
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: %s (%d)"
                           % (what, lib.gv_error_string(rc).decode(), rc))
