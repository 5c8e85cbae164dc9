"""Row scatter-add: table[ids[j]] += upd[j], duplicates summed.

The port of the TPU kernel graphvite_tpu/ops/pallas_scatter.py:
sweep_scatter_add (with its argsort front end sweep_scatter_add_unsorted).
Every table update of the banded walk steps goes through `scatter_add_`:
the fused (vertex|context) arena update and both SGD branches of
`optim.apply_row_updates`.

Contract (plus the XLA `mode="drop"` rule the callers rely on):
* ids outside [0, V) are dropped (steps route dead slots to the sentinel V);
* the table is float32 or bfloat16, contiguous, [V, W] for any W;
* each row's updates are summed in float32 and the row is written once,
  cast to the table's type; the table is updated in place.

On a CUDA tensor `scatter_add_` launches the hand-written kernel in
graphvite_tpu_torch/csrc/scatter_add.cu (built with nvcc for sm_90a at
first use, bound with ctypes) or raises; on a CPU tensor it runs the plain
version below. The front end (a stable sort of the ids and a permute of
the update rows) runs as torch ops, as the TPU front end ran as XLA ops.
What bounds the kernel and what its design does about it: see the note at
the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import torch

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE, "csrc", "scatter_add.cu")
# inside the checkout, in a directory .gitignore lists
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build",
                         "graphvite_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build(verbose=False):
    """Compile csrc/scatter_add.cu into BUILD_DIR (once per source digest)
    and return the library path. `verbose` adds -Xptxas -v and returns the
    compiler's report as a second value."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, "libgv_scatter_add-%s.so" % digest)
    report = ""
    if not os.path.exists(so_path) or verbose:
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_so = os.path.join(tmp, "lib.so")
            cmd = ([_nvcc()] + NVCC_FLAGS
                   + (["-Xptxas", "-v"] if verbose else [])
                   + ["-o", tmp_so, SOURCE])
            out = subprocess.run(cmd, capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError("nvcc failed (%d):\n%s%s"
                                   % (out.returncode, out.stdout, out.stderr))
            report = out.stdout + out.stderr
            os.replace(tmp_so, so_path)
    return (so_path, report) if verbose else so_path


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build())
    vp = ctypes.c_void_p
    ll = ctypes.c_longlong
    lib.gv_scatter_add.argtypes = [vp, ctypes.c_int, vp, vp, ll, ll, ll,
                                   ctypes.c_int, vp]
    lib.gv_scatter_add.restype = ctypes.c_int
    lib.gv_error_string.argtypes = [ctypes.c_int]
    lib.gv_error_string.restype = ctypes.c_char_p
    return lib


def _check(table, ids, upd):
    if table.dim() != 2 or ids.dim() != 1 or upd.dim() != 2:
        raise ValueError("expected table [V, W], ids [N], upd [N, W]; got "
                         "%s, %s, %s" % (tuple(table.shape), tuple(ids.shape),
                                         tuple(upd.shape)))
    if upd.shape != (ids.shape[0], table.shape[1]):
        raise ValueError("upd %s does not match ids [%d] and width %d"
                         % (tuple(upd.shape), ids.shape[0], table.shape[1]))
    if table.dtype not in _DTYPE_CODES:
        raise TypeError("table must be float32 or bfloat16, got %s"
                        % table.dtype)
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError("ids must be int32 or int64, got %s" % ids.dtype)
    if not (table.device == ids.device == upd.device):
        raise ValueError("table, ids and upd must be on one device")


def scatter_add_plain(table, ids, upd):
    """The same function as torch index ops (the CPU path and the
    reference the kernel is held against). Sums each row's updates in
    float32 in stable-sorted order, then writes the row once."""
    _check(table, ids, upd)
    v, w = table.shape
    ids = ids.long()
    keep = (ids >= 0) & (ids < v)
    sid, order = torch.sort(ids[keep], stable=True)
    supd = upd[keep].float()[order]
    rows, inverse = torch.unique_consecutive(sid, return_inverse=True)
    acc = torch.zeros((rows.numel(), w), dtype=torch.float32,
                      device=table.device).index_add_(0, inverse, supd)
    table[rows] = (table[rows].float() + acc).to(table.dtype)
    return table


def scatter_add_(table, ids, upd):
    """In place: table[ids[j]] += upd[j] for every j, duplicates summed,
    ids outside [0, V) dropped. Returns `table`.

    The kernel takes int32 ids: int64 ids are clamped to [-1, V] (which
    keeps every dropped id dropped) and converted once. `upd` is float32
    (other float types are converted)."""
    _check(table, ids, upd)
    if table.device.type == "cpu":
        return scatter_add_plain(table, ids, upd)
    if table.device.type != "cuda":
        raise ValueError("scatter_add_ runs on CUDA or CPU tensors, not %s"
                         % table.device)
    if not table.is_contiguous():
        raise ValueError("scatter_add_ needs a contiguous table")
    v, w = table.shape
    if v >= 2 ** 31:
        raise ValueError("table has %d rows; the kernel takes int32 ids" % v)
    n = ids.shape[0]
    if n == 0 or w == 0:
        return table
    with torch.cuda.device(table.device):
        if ids.dtype == torch.int64:
            ids = ids.clamp(-1, v).to(torch.int32)
        sid, order = torch.sort(ids, stable=True)
        supd = upd.float().index_select(0, order)
        align = 16 if table.dtype == torch.float32 else 8
        vec = int(w % 4 == 0 and table.data_ptr() % align == 0
                  and supd.data_ptr() % 16 == 0)
        lib = _library()
        rc = lib.gv_scatter_add(
            table.data_ptr(), _DTYPE_CODES[table.dtype], sid.data_ptr(),
            supd.data_ptr(), n, v, w, vec,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("scatter_add kernel launch failed: %s (%d)"
                           % (lib.gv_error_string(rc).decode(), rc))
    scatter_add_.launches += 1
    return table


# kernel launches since the last reset (chip_smoke.py reads it to show the
# main path went through the kernel); the CPU path does not count
scatter_add_.launches = 0
