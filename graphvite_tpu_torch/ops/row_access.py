"""Random row access on float32 tables: the ports of the three TPU kernels
of tools/pallas_bench.py, which the row-access bench
(graphvite_tpu_torch/tools/row_access_bench.py) runs.

* `gather_rows(table, ids)`: out[j] = table[ids[j]] (make_pallas_gather);
* `rmw_rows_(table, ids, upd)`: table[ids[j]] += upd[j] in place, ids
  unique within the call (make_pallas_rmw);
* `sweep_add_sorted_(table, sorted_ids, upd)`: table[sorted_ids[j]] +=
  upd[j] in place for ascending ids, repeats summed in a fixed order
  (make_pallas_sweep).

Contract: table [V, D] float32 (any other type raises), contiguous on the
card; ids [N] int32 or int64; upd [N, D]. gather_rows clamps ids outside
[0, V) to the nearest row; the adds drop them. rmw_rows_ loses updates to
a repeated id, as the reference's kernel does; `check_unique=True` raises
on one instead (a host sync). sweep_add_sorted_ needs ascending ids; on
the card it does not check them (a host sync), on the CPU it does.

The sweep's order of sums: the N positions are cut into chunks of
chunk_rows(D) (64 at D = 128); a run of equal ids is cut at the chunks'
edges into parts; each part is summed in float32 from zero in sorted
order, the parts are combined in chunk order, and the total is added to
its row once. The order depends on the shape alone, so the result is a
pure function of the inputs, and the kernel is bit-equal to
sweep_add_sorted_plain, which does the same adds in the same order.
Against the reference's sweep (which adds a run's updates to the row one
by one) it is bit-equal where ids are unique (each row one add) and
within 1e-6 of the largest magnitude where they repeat.

Unlike the reference's kernels these do the whole job: every row of N is
gathered or updated (the reference's grid covers N // chunk chunks), and
the sweep applies every update (the reference's V // tile_rows tiles drop
the rows of a partial last tile, and its slab caps a tile's updates).

On a CUDA tensor each wrapper launches its hand-written kernels in
graphvite_tpu_torch/csrc/row_access.cu (built with nvcc for sm_90a at first
use, bound with ctypes) or raises; on a CPU tensor it runs the plain
version beside it (`*_plain`, which chip_smoke.py also holds the kernels
against on the card). The sweep needs no bounds from the host: its CTAs
split the sorted positions, and its scratch (sweep_scratch) is allocated
by the wrapper.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from graphvite_tpu_torch.ops import kernels


@functools.lru_cache(maxsize=None)
def _library():
    lib = kernels.library("row_access")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gv_gather_rows.argtypes = [vp, vp, i, vp, ll, ll, ll, i, vp]
    lib.gv_rmw_rows.argtypes = [vp, vp, i, vp, ll, ll, ll, i, vp]
    lib.gv_sweep_add_sorted.argtypes = [vp, vp, i, vp, vp, vp, ll, ll, ll,
                                        i, i, vp]
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
# sweep of sorted updates
# ---------------------------------------------------------------------------

# update bytes one chunk stages in shared memory, at most (a stage of the
# kernel's ring)
SWEEP_STAGE_BYTES = 32768


def chunk_rows(d):
    """Positions per chunk of the sweep at width D: the largest of 256,
    128, 64, 32 whose update rows (min(D, 128) columns, one pass) fit in
    SWEEP_STAGE_BYTES. It depends on the shape alone, so the order of
    every sum is fixed: 64 at D = 128, 256 at D <= 32."""
    cols = min(d, 128)
    c = 256
    while c > 32 and c * cols * 4 > SWEEP_STAGE_BYTES:
        c //= 2
    return c


def sweep_scratch(table, n):
    """Uninitialized scratch for one sweep over N positions: the head and
    tail slots' ids [chunks, 2] int32 and partial sums [chunks, 2, D]
    float32 (the kernel writes every slot's id, so nothing is zeroed)."""
    d = table.shape[1]
    chunks = -(-n // chunk_rows(d))
    return (torch.empty((chunks, 2), dtype=torch.int32, device=table.device),
            torch.empty((chunks, 2, d), dtype=torch.float32,
                        device=table.device))


def _add_in_step_order(out, group, step, values, start):
    """out[group[i]] += values[i] for every i with step[i] >= start, one
    step at a time: each group's adds in ascending step."""
    for k in range(start, int(step.max()) + 1):
        at = torch.nonzero(step == k).squeeze(1)
        out[group[at]] = out[group[at]] + values[at]
    return out


def sweep_add_sorted_plain(table, sorted_ids, upd):
    """The sweep by indexing (the CPU path and what the kernel is held
    against), with the kernel's adds in the kernel's order: the positions
    are cut into chunks of chunk_rows(D); each run of equal ids is cut at
    the chunks' edges into parts; each part is summed in float32 from zero
    in sorted order (one update row per step of a loop over the position
    in the part, at most chunk_rows(D) steps); a run's parts are combined
    in chunk order, the first as it is; the total is added to its row
    once. Ids outside [0, V) dropped. Any device."""
    _check(table, sorted_ids, upd)
    v, d = table.shape
    n = sorted_ids.shape[0]
    if n == 0:
        return table
    dev = table.device
    ids = sorted_ids.long()
    key = torch.where((ids >= 0) & (ids < v), ids, -1)   # as the kernel reads
    pos = torch.arange(n, device=dev)
    cut = pos % chunk_rows(d) == 0
    cut[1:] |= key[1:] != key[:-1]
    part = torch.cumsum(cut, 0) - 1
    starts = torch.nonzero(cut).squeeze(1)
    sums = _add_in_step_order(
        torch.zeros((starts.numel(), d), dtype=torch.float32, device=dev),
        part, pos - starts[part], upd, 0)
    pkey = key[starts]
    first = torch.ones(starts.numel(), dtype=torch.bool, device=dev)
    first[1:] = pkey[1:] != pkey[:-1]
    run = torch.cumsum(first, 0) - 1
    lead = torch.nonzero(first).squeeze(1)
    j = torch.arange(starts.numel(), device=dev) - lead[run]
    total = _add_in_step_order(sums[lead], run, j, sums, 1)
    rows = pkey[lead]
    live = rows >= 0
    rows, total = rows[live], total[live]
    table[rows] = table[rows] + total
    return table


def sweep_add_sorted_(table, sorted_ids, upd):
    """In place: table[sorted_ids[j]] += upd[j] for ascending ids, ids
    outside [0, V) dropped, each distinct row written once; repeats summed
    in the order of sweep_add_sorted_plain. On the card: persistent CTAs
    over chunks of chunk_rows(D) positions, then one warp per run that
    crosses a chunk's edge. Returns `table`."""
    _check(table, sorted_ids, upd)
    if not _on_card(table, "sweep_add_sorted_"):
        _check_sorted(sorted_ids)
        return sweep_add_sorted_plain(table, sorted_ids, upd)
    n = sorted_ids.shape[0]
    if n and table.shape[1]:
        with torch.cuda.device(table.device):
            _launch_sweep(table, sorted_ids.contiguous(), upd.contiguous(),
                          sweep_scratch(table, n))
        sweep_add_sorted_.launches += 1
    return table


def _launch_sweep(table, sorted_ids, upd, scratch):
    """The sweep's two kernels alone, on contiguous ids and updates and
    the scratch of sweep_scratch."""
    v, d = table.shape
    part_id, part = scratch
    chunks = -(-sorted_ids.numel() // chunk_rows(d))
    if part_id.shape != (chunks, 2) or part.shape != (chunks, 2, d):
        raise ValueError("sweep scratch %s, %s does not fit N %d, width %d"
                         % (tuple(part_id.shape), tuple(part.shape),
                            sorted_ids.numel(), d))
    _, wide, vec = _args(table, sorted_ids, upd, part)
    lib = _library()
    rc = lib.gv_sweep_add_sorted(
        table.data_ptr(), sorted_ids.data_ptr(), wide, upd.data_ptr(),
        part_id.data_ptr(), part.data_ptr(), sorted_ids.numel(), v, d,
        chunk_rows(d), vec, _stream(table))
    kernels.check_launch(lib, rc, "sweep_add_sorted")


# kernel launches since the last reset (chip_smoke.py reads them to show a
# path went through the kernels); the CPU path does not count
gather_rows.launches = 0
rmw_rows_.launches = 0
sweep_add_sorted_.launches = 0
