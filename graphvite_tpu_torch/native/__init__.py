"""ctypes loader for the native host alias construction, the cuckoo
membership table of node2vec's walks and the graph's CSR counting sort
(sampler.cpp).

Compiled with g++ at first use into a per-user cache directory of the
port's own (`~/.cache/graphvite_tpu_torch`, or GRAPHVITE_TPU_TORCH_CACHE_DIR).
`load()` returns None when the build fails: alias construction is host
code, and callers then take the numpy construction, which gives the same
arrays.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile

import numpy as np

from graphvite_tpu_torch.utils import tracing

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sampler.cpp")


@tracing.setup_stage(tracing.NATIVE_BUILD)
def _build() -> str:
    with open(_SRC, "rb") as f:
        src_digest = hashlib.sha256(f.read()).hexdigest()[:16]
    # -march=native output is host-CPU specific: key the artifact by the
    # host's CPU flags as well as the source, so a shared cache directory
    # never serves a .so built for another CPU
    try:
        with open("/proc/cpuinfo") as f:
            cpu_flags = "".join(l for l in f if l.startswith("flags"))[:4096]
    except OSError:
        cpu_flags = ""
    host = "%s-%s" % (platform.machine(),
                      hashlib.sha256(cpu_flags.encode()).hexdigest()[:8])
    cache_dir = os.environ.get(
        "GRAPHVITE_TPU_TORCH_CACHE_DIR",
        os.path.expanduser("~/.cache/graphvite_tpu_torch"))
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir,
                           "libgvsampler-%s-%s.so" % (src_digest, host))
    if os.path.exists(so_path):
        return so_path
    with tempfile.TemporaryDirectory(dir=cache_dir) as tmp:
        tmp_so = os.path.join(tmp, "libgvsampler.so")
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread", _SRC, "-o", tmp_so],
            check=True, capture_output=True)
        os.replace(tmp_so, so_path)
    return so_path


@functools.lru_cache(maxsize=None)
def load():
    """The built library, or None when g++ is unavailable or fails."""
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.CalledProcessError):
        return None
    i64 = ctypes.c_int64
    pd = ctypes.POINTER(ctypes.c_double)
    pi = ctypes.POINTER(i64)
    lib.gv_build_alias.argtypes = [pd, i64, pd, pi]
    lib.gv_build_alias.restype = ctypes.c_int
    lib.gv_build_alias_packed.argtypes = [pd, pi, i64, pd, pi]
    lib.gv_build_alias_packed.restype = ctypes.c_int
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.gv_build_cuckoo.argtypes = [p32, p32, i64, p32, i64]
    lib.gv_build_cuckoo.restype = ctypes.c_int
    for name, ptr in (("gv_csr_i32", p32), ("gv_csr_i64", pi)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i64, i64, pi, ptr, pi, i64]
        fn.restype = ctypes.c_int
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_alias(weights):
    """Native ops.alias.build_alias on contiguous float64 weights."""
    n = weights.shape[0]
    prob = np.empty(n, dtype=np.float64)
    alias = np.empty(n, dtype=np.int64)
    rc = load().gv_build_alias(_ptr(weights, ctypes.c_double), n,
                               _ptr(prob, ctypes.c_double),
                               _ptr(alias, ctypes.c_int64))
    if rc != 0:
        raise ValueError("alias table requires positive finite weights")
    return prob, alias


def build_alias_packed(weights, offsets):
    """Native per-table alias build over flat `weights` cut by `offsets`."""
    m = offsets.shape[0] - 1
    prob = np.empty(weights.shape[0], dtype=np.float64)
    alias = np.empty(weights.shape[0], dtype=np.int64)
    rc = load().gv_build_alias_packed(
        _ptr(weights, ctypes.c_double), _ptr(offsets, ctypes.c_int64), m,
        _ptr(prob, ctypes.c_double), _ptr(alias, ctypes.c_int64))
    if rc != 0:
        raise ValueError("alias table requires positive finite weights")
    return prob, alias


def build_cuckoo(us, vs, num_buckets):
    """Bucketized cuckoo table over the directed edges (us[i] -> vs[i]),
    contiguous int32 arrays: the [num_buckets, 4] int32 table (bucket b
    holds up to two (u, v) pairs, empty slots -1), or None when an
    insertion failed at this size (the caller doubles num_buckets and
    retries). Its hash is ops/device_sampler.py:_cuckoo_buckets, bit for
    bit."""
    table = np.full((num_buckets, 4), -1, dtype=np.int32)
    rc = load().gv_build_cuckoo(
        _ptr(us, ctypes.c_int32), _ptr(vs, ctypes.c_int32), us.shape[0],
        _ptr(table, ctypes.c_int32), num_buckets)
    return table if rc == 0 else None


def csr_by_head(heads, tails, num_vertex, with_indices=True,
                with_order=False):
    """The CSR over sources of the directed edges (heads[i] -> tails[i]),
    contiguous int32 or int64 arrays of one dtype, stable by head, by a
    counting sort on the host's cores: (indptr int64 [V + 1], indices in
    the tails' dtype or None, order int64 or None), `order[k]` the flat
    edge id at CSR position k."""
    n = heads.shape[0]
    ctype = ctypes.c_int32 if heads.dtype == np.int32 else ctypes.c_int64
    fn = load().gv_csr_i32 if heads.dtype == np.int32 else load().gv_csr_i64
    indptr = np.empty(num_vertex + 1, dtype=np.int64)
    indices = np.empty(n, dtype=heads.dtype) if with_indices else None
    order = np.empty(n, dtype=np.int64) if with_order else None
    null = ctypes.POINTER(ctypes.c_int64)()
    rc = fn(_ptr(heads, ctype), _ptr(tails, ctype), n, num_vertex,
            _ptr(indptr, ctypes.c_int64),
            _ptr(indices, ctype) if with_indices
            else ctypes.POINTER(ctype)(),
            _ptr(order, ctypes.c_int64) if with_order else null,
            len(os.sched_getaffinity(0)))
    if rc != 0:
        raise ValueError("an edge's head lies outside [0, %d)" % num_vertex)
    return indptr, indices, order
