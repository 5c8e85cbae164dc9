"""Random row access on float32 tables: the ports of the three TPU kernels
of tools/pallas_bench.py, which the row-access bench
(graphvite_tpu_torch/tools/row_access_bench.py) runs.

* `gather_rows(table, ids)`: out[j] = table[ids[j]] (make_pallas_gather);
* `rmw_rows_(table, ids, upd)`: table[ids[j]] += upd[j] in place, ids
  unique within the call (make_pallas_rmw);
* `sweep_add_sorted_(table, sorted_ids, upd)`: table[sorted_ids[j]] +=
  upd[j] in place, repeated ids summed in sorted order (make_pallas_sweep).

Contract: table [V, D] float32 (any other type raises), contiguous on the
card; ids [N] int32 or int64; upd [N, D]. gather_rows clamps ids outside
[0, V) to the nearest row; the adds drop them. rmw_rows_ loses updates to
a repeated id, as the reference's kernel does; `check_unique=True` raises
on one instead (a host sync). sweep_add_sorted_ needs ascending ids; on
the card it does not check them (a host sync), on the CPU it does.

Unlike the reference's kernels these do the whole job: every row of N is
gathered or updated (the reference's grid covers N // chunk chunks), the
sweep covers ceil(V / SWEEP_TILE_ROWS) tiles (the reference's V //
tile_rows drops the rows of a partial last tile) and has no cap on a tile's
updates.

On a CUDA tensor each wrapper launches its hand-written kernel in
graphvite_tpu_torch/csrc/row_access.cu (built with nvcc for sm_90a at first
use, bound with ctypes) or raises; on a CPU tensor it runs the plain
version beside it (`*_plain`, which chip_smoke.py also holds the kernels
against on the card). The sweep's per-tile position bounds come from
torch.searchsorted on the card, as the reference computes its per-tile
lo and cnt outside its kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from graphvite_tpu_torch.ops import kernels

# table rows per tile of the sweep (the reference experiment's 8192)
SWEEP_TILE_ROWS = 8192


@functools.lru_cache(maxsize=None)
def _library():
    lib = kernels.library("row_access")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gv_gather_rows.argtypes = [vp, vp, i, vp, ll, ll, ll, i, vp]
    lib.gv_rmw_rows.argtypes = [vp, vp, i, vp, ll, ll, ll, i, vp]
    lib.gv_sweep_add_sorted.argtypes = [vp, vp, i, vp, vp, ll, ll, ll, i, vp]
    for fn in (lib.gv_gather_rows, lib.gv_rmw_rows, lib.gv_sweep_add_sorted):
        fn.restype = i
    return lib


def _check(table, ids, upd=None):
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError("expected table [V, D] and ids [N]; got %s, %s"
                         % (tuple(table.shape), tuple(ids.shape)))
    if table.dtype != torch.float32:
        raise TypeError("the row-access kernels take float32 tables, not %s"
                        % table.dtype)
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError("ids must be int32 or int64, got %s" % ids.dtype)
    if upd is not None:
        if upd.shape != (ids.shape[0], table.shape[1]):
            raise ValueError("upd %s does not match ids [%d] and width %d"
                             % (tuple(upd.shape), ids.shape[0],
                                table.shape[1]))
        if upd.dtype != torch.float32:
            raise TypeError("upd must be float32, got %s" % upd.dtype)
    if any(t.device != table.device
           for t in ((ids,) if upd is None else (ids, upd))):
        raise ValueError("table, ids and upd must be on one device")
    if table.shape[0] == 0:
        raise ValueError("empty table")


def _on_card(table, name):
    """True for a CUDA table the kernels take, False for a CPU table;
    raises for anything else."""
    if table.device.type == "cpu":
        return False
    if table.device.type != "cuda":
        raise ValueError("%s runs on CUDA or CPU tensors, not %s"
                         % (name, table.device))
    if not table.is_contiguous():
        raise ValueError("%s needs a contiguous table" % name)
    return True


def _args(table, ids, *rows):
    """(ids, 1 for int64, vec) as the C functions take them."""
    ids = ids.contiguous()
    vec = int(table.shape[1] % 4 == 0 and kernels.aligned(table, *rows))
    return ids, int(ids.dtype == torch.int64), vec


def _stream(table):
    return torch.cuda.current_stream(table.device).cuda_stream


def _check_unique(ids):
    if ids.numel() > 1 and torch.unique(ids).numel() != ids.numel():
        raise ValueError("rmw_rows_ needs unique ids; a repeated id would "
                         "lose updates")


def _check_sorted(ids):
    if ids.numel() > 1 and not bool((ids[1:] >= ids[:-1]).all()):
        raise ValueError("sweep_add_sorted_ needs ascending ids")


# ---------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------

def gather_rows_plain(table, ids):
    """out[j] = table[clamp(ids[j], 0, V - 1)] by indexing (the CPU path
    and what the kernel is held against)."""
    _check(table, ids)
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def gather_rows(table, ids):
    """A new [N, D] tensor: out[j] = table[ids[j]], ids outside [0, V)
    clamped to the nearest row."""
    _check(table, ids)
    if not _on_card(table, "gather_rows"):
        return gather_rows_plain(table, ids)
    n, (v, d) = ids.shape[0], table.shape
    out = torch.empty((n, d), dtype=torch.float32, device=table.device)
    if n == 0 or d == 0:
        return out
    with torch.cuda.device(table.device):
        ids, wide, vec = _args(table, ids, out)
        lib = _library()
        rc = lib.gv_gather_rows(table.data_ptr(), ids.data_ptr(), wide,
                                out.data_ptr(), n, v, d, vec, _stream(table))
    kernels.check_launch(lib, rc, "gather_rows")
    gather_rows.launches += 1
    return out


# ---------------------------------------------------------------------------
# read-modify-write of unique rows
# ---------------------------------------------------------------------------

def rmw_rows_plain(table, ids, upd, check_unique=False):
    """table[ids[j]] = table[ids[j]] + upd[j] by indexing, ids outside [0,
    V) dropped (the CPU path and what the kernel is held against). With a
    repeated id one of its updates wins, as in the kernel."""
    _check(table, ids, upd)
    if check_unique:
        _check_unique(ids)
    ids = ids.long()
    keep = (ids >= 0) & (ids < table.shape[0])
    rows = ids[keep]
    table[rows] = table[rows] + upd[keep]
    return table


def rmw_rows_(table, ids, upd, check_unique=False):
    """In place: table[ids[j]] += upd[j], one read, add and write per
    entry; ids must be unique (`check_unique` raises on a repeat) and
    those outside [0, V) are dropped. Returns `table`."""
    _check(table, ids, upd)
    if not _on_card(table, "rmw_rows_"):
        return rmw_rows_plain(table, ids, upd, check_unique)
    if check_unique:
        _check_unique(ids)
    n, (v, d) = ids.shape[0], table.shape
    if n == 0 or d == 0:
        return table
    with torch.cuda.device(table.device):
        upd = upd.contiguous()
        ids, wide, vec = _args(table, ids, upd)
        lib = _library()
        rc = lib.gv_rmw_rows(table.data_ptr(), ids.data_ptr(), wide,
                             upd.data_ptr(), n, v, d, vec, _stream(table))
    kernels.check_launch(lib, rc, "rmw_rows")
    rmw_rows_.launches += 1
    return table


# ---------------------------------------------------------------------------
# tile sweep of sorted updates
# ---------------------------------------------------------------------------

def tile_bounds(sorted_ids, v):
    """[T + 1] int64 positions, T = ceil(V / SWEEP_TILE_ROWS): tile t's ids
    lie at [bounds[t], bounds[t + 1]) of the ascending `sorted_ids`."""
    tiles = -(-v // SWEEP_TILE_ROWS)
    edges = torch.arange(tiles + 1, dtype=sorted_ids.dtype,
                         device=sorted_ids.device) * SWEEP_TILE_ROWS
    return torch.searchsorted(sorted_ids, edges)


def sweep_add_sorted_plain(table, sorted_ids, upd):
    """The sweep by indexing (the CPU path and what the kernel is held
    against): each run of equal ids summed in float32 from zero in sorted
    order, one update row per step of a loop over the position in the
    run, then added to its row once; ids outside [0, V) dropped. The same
    adds in the same order as the kernel, on any device."""
    _check(table, sorted_ids, upd)
    v, d = table.shape
    ids = sorted_ids.long()
    keep = (ids >= 0) & (ids < v)
    ids, upd = ids[keep], upd[keep]
    if ids.numel() == 0:
        return table
    rows, counts = torch.unique_consecutive(ids, return_counts=True)
    run = torch.repeat_interleave(
        torch.arange(rows.numel(), device=ids.device), counts)
    pos = (torch.arange(ids.numel(), device=ids.device)
           - (torch.cumsum(counts, 0) - counts)[run])
    acc = torch.zeros((rows.numel(), d), dtype=torch.float32,
                      device=table.device)
    for k in range(int(counts.max())):
        at = torch.nonzero(pos == k).squeeze(1)
        acc[run[at]] = acc[run[at]] + upd[at]
    table[rows] = table[rows] + acc
    return table


def sweep_add_sorted_(table, sorted_ids, upd):
    """In place: table[sorted_ids[j]] += upd[j] for ascending ids, each
    run of equal ids summed in float32 in sorted order and its row written
    once; ids outside [0, V) dropped. One CTA per tile of SWEEP_TILE_ROWS
    table rows. Returns `table`."""
    _check(table, sorted_ids, upd)
    if not _on_card(table, "sweep_add_sorted_"):
        _check_sorted(sorted_ids)
        return sweep_add_sorted_plain(table, sorted_ids, upd)
    if sorted_ids.shape[0] and table.shape[1]:
        with torch.cuda.device(table.device):
            ids = sorted_ids.contiguous()
            _launch_sweep(table, ids, upd.contiguous(),
                          tile_bounds(ids, table.shape[0]))
        sweep_add_sorted_.launches += 1
    return table


def _launch_sweep(table, sorted_ids, upd, bounds):
    """The sweep kernel alone, on contiguous ids and updates and the tiles'
    position bounds (tile_bounds)."""
    v, d = table.shape
    _, wide, vec = _args(table, sorted_ids, upd)
    lib = _library()
    rc = lib.gv_sweep_add_sorted(
        table.data_ptr(), sorted_ids.data_ptr(), wide, upd.data_ptr(),
        bounds.data_ptr(), bounds.numel() - 1, v, d, vec, _stream(table))
    kernels.check_launch(lib, rc, "sweep_add_sorted")


# kernel launches since the last reset (chip_smoke.py reads them to show a
# path went through the kernels); the CPU path does not count
gather_rows.launches = 0
rmw_rows_.launches = 0
sweep_add_sorted_.launches = 0
