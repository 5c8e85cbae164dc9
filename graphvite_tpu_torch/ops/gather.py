"""Row gather of sorted ids: out[j] = table[ids[j]].

The port of the TPU kernel graphvite_tpu/ops/pallas_scatter.py:
sweep_gather_sorted, which the edge route's pool step runs on its sorted
heads. Contract:
* table [V, D] float32 or bfloat16; ids [N] int32 or int64, ascending in
  the caller (any order gives the same rows; ascending keeps the reads
  near each other);
* ids outside [0, V) clamp to the nearest row (JAX clamps an out-of-range
  gather the same way; it would wrap a negative one, which no caller
  passes);
* `out_dtype` (default: the table's) is float32 or bfloat16; the
  conversion happens in the kernel, which saves the step a separate cast.

On a CUDA tensor `gather_sorted` launches the hand-written kernel in
graphvite_tpu_torch/csrc/gather_sorted.cu (built with nvcc for sm_90a at
first use, bound with ctypes) or raises; on a CPU tensor it runs
`gather_sorted_plain`. What bounds the kernel and what its design does
about it: see the note at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from graphvite_tpu_torch.ops import kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library():
    lib = kernels.library("gather_sorted")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gv_gather_sorted.argtypes = [vp, i, vp, vp, i, ll, ll, ll, i, vp]
    lib.gv_gather_sorted.restype = i
    return lib


def _check(table, ids, out_dtype):
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError("expected table [V, D] and ids [N]; got %s, %s"
                         % (tuple(table.shape), tuple(ids.shape)))
    if table.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError("table and out_dtype must be float32 or bfloat16, "
                        "got %s, %s" % (table.dtype, out_dtype))
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError("ids must be int32 or int64, got %s" % ids.dtype)
    if table.device != ids.device:
        raise ValueError("table and ids must be on one device")
    if table.shape[0] == 0:
        raise ValueError("cannot gather from an empty table")


def gather_sorted_plain(table, ids, out_dtype=None):
    """The same function as a torch index op (the CPU path and the
    reference the kernel is held against)."""
    out_dtype = out_dtype or table.dtype
    _check(table, ids, out_dtype)
    return table[ids.long().clamp(0, table.shape[0] - 1)].to(out_dtype)


def gather_sorted(table, ids, out_dtype=None):
    """out[j] = table[clamp(ids[j], 0, V - 1)] as `out_dtype` (default the
    table's type), a new [N, D] tensor."""
    out_dtype = out_dtype or table.dtype
    _check(table, ids, out_dtype)
    if table.device.type == "cpu":
        return gather_sorted_plain(table, ids, out_dtype)
    if table.device.type != "cuda":
        raise ValueError("gather_sorted runs on CUDA or CPU tensors, not %s"
                         % table.device)
    if not table.is_contiguous():
        raise ValueError("gather_sorted needs a contiguous table")
    v, d = table.shape
    if v >= 2 ** 31:
        raise ValueError("table has %d rows; the kernel takes int32 ids" % v)
    n = ids.shape[0]
    with torch.cuda.device(table.device):
        if ids.dtype == torch.int64:
            ids = ids.clamp(0, v - 1).to(torch.int32)
        ids = ids.contiguous()
        out = torch.empty((n, d), dtype=out_dtype, device=table.device)
        if n == 0 or d == 0:
            return out
        vec = int(d % 4 == 0 and kernels.aligned(table, out))
        lib = _library()
        rc = lib.gv_gather_sorted(
            table.data_ptr(), _DTYPE_CODES[table.dtype], ids.data_ptr(),
            out.data_ptr(), _DTYPE_CODES[out_dtype], n, v, d, vec,
            torch.cuda.current_stream().cuda_stream)
    kernels.check_launch(lib, rc, "gather_sorted")
    gather_sorted.launches += 1
    return out


# kernel launches since the last reset (chip_smoke.py reads it to show the
# main path went through the kernel); the CPU path does not count
gather_sorted.launches = 0
