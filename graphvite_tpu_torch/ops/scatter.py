"""Row scatter updates: the ports of two TPU kernels of
graphvite_tpu/ops/pallas_scatter.py, each with its sorted entry and its
unsorted front end.

Kernel 1, scatter-add (`sweep_scatter_add` and `sweep_scatter_add_unsorted`):
table[ids[j]] += upd[j], duplicates summed.

* `scatter_add_sorted_(table, sorted_ids, upd)`: ids already ascending (the
  sorted heads of the edge route).
* `scatter_add_(table, ids, upd)`: any order. Every other SGD table update
  of the port goes through it.

Kernel 2, moment update (`sweep_scatter_update` and
`sweep_scatter_update_unsorted`): per unique row, gsum / gsq / touch count
summed over its entries, then one closed-form c-touch `moment_delta`
update of the row and its moment rows; rows whose counts sum to 0 pass
through untouched. SGD hands off to kernel 1.

* `scatter_update_sorted_(...)`: ids ascending.
* `scatter_update_(...)`: any order.

Shared contract (plus the XLA `mode="drop"` rule the callers rely on): ids
outside [0, V) are dropped; tables are float32 or bfloat16, contiguous,
updated in place; sums are taken in float32 in stable-sorted order; each
touched row is written once, by one writer, without float atomics, so the
result is a pure function of the inputs.

On a CUDA tensor each wrapper launches its hand-written kernels
(graphvite_tpu_torch/csrc/scatter_add.cu, scatter_update.cu, sharing
segmented.cuh; built with nvcc for sm_90a at first use, bound with ctypes)
or raises; on a CPU tensor it runs the plain version below. One call of a
wrapper is one call of the kernel's C function and one count of
`launches`, whatever number of CUDA launches stands behind it.

The design, for both kernels and all four entries (the notes at the top of
the CUDA sources say what bounds each kernel):

* A balanced segmented reduction. The N sorted positions are cut into
  tiles of `tile_rows(n, w)` rows; one warp streams each tile and
  128-column pass and closes its running sum when the id changes. A run
  inside a tile is written at once. A run that crosses a tile edge leaves
  partial sums in scratch, and a second small kernel, one warp per such
  run, adds them in tile order and writes the row. Every warp has the same
  work however long a hub id's run is, and the order of every sum depends
  only on the shape.
* No permuted copies. The unsorted entries sort (id, position) pairs (CUB's
  radix sort over the bits V needs, called by the C function on scratch
  this module allocates; stable, dropped ids keyed V so they sort to the
  end) and the kernels read entry rows through the positions: row r of the
  sorted order is upd[order[r]]. As on the TPU, where the front ends sort
  in XLA outside the Pallas kernel, the sort is a library's; everything
  after it is the hand-written kernel. int64 ids are read as they are.

The sorted entries do not check the order on the card (that would cost a
host sync): ids that are not ascending lose updates there. Their CPU path
checks it and raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from graphvite_tpu_torch.ops import kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MOMENT_CODES = {"Momentum": 1, "AdaGrad": 2, "RMSprop": 3, "Adam": 4}


@functools.lru_cache(maxsize=None)
def _library(name):
    """The kernel's library with its functions typed."""
    lib = kernels.library(name)
    vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_float)
    if name == "scatter_add":
        lib.gv_scatter_add.argtypes = [vp, i, vp, i, i, vp, vp, ll, ll, ll,
                                       i, i, vp, ll, vp]
        lib.gv_scatter_add.restype = i
    else:
        lib.gv_scatter_update.argtypes = [vp, i, vp, vp, vp, i, i, vp, vp,
                                          vp, vp, ll, ll, ll, i, i, f, f, f,
                                          f, f, i, vp, ll, vp]
        lib.gv_scatter_update.restype = i
    scratch = getattr(lib, "gv_%s_scratch" % name)
    scratch.argtypes = [ll, ll, ll, i, i]
    scratch.restype = ll
    return lib


# warps the first kernel should have for each of the H100's 132 SMs
_WARPS_WANTED = 132 * 16


def tile_rows(n, w):
    """Rows of a tile of the segmented reduction for N entries of width W:
    the largest of 32, 16, 8 that still gives `_WARPS_WANTED` warps (one
    per tile and 128-column pass), else 8. It depends on the shape alone,
    so the order of every sum is fixed: 32 at the edge route's 99,328 x
    128, 8 at DeepWalk's 11,968 x 256."""
    passes = -(-w // 128)
    for r in (32, 16):
        if -(-n // r) * passes >= _WARPS_WANTED:
            return r
    return 8


@functools.lru_cache(maxsize=None)
def _scratch_bytes(name, n, v, w, r, sort):
    """Bytes of scratch the kernel's C function asks for at this shape."""
    lib = _library(name)
    nbytes = getattr(lib, "gv_%s_scratch" % name)(n, v, w, r, sort)
    if nbytes < 0:
        kernels.check_launch(lib, -1 - nbytes, name + " scratch")
    return nbytes


def _scratch(name, table, n, r, sort):
    """Uninitialized scratch for one call: the tiles' partial sums and,
    with `sort`, the radix sort's buffers."""
    v, w = table.shape
    return torch.empty(_scratch_bytes(name, n, v, w, r, int(sort)),
                       dtype=torch.uint8, device=table.device)


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


def _check_sorted(ids):
    if ids.numel() > 1 and not bool((ids[1:] >= ids[:-1]).all()):
        raise ValueError("the sorted entry needs ascending ids")


def _on_card(table, name):
    """True for a CUDA table the kernel takes, False for a CPU table;
    raises for anything else."""
    if table.device.type == "cpu":
        return False
    if table.device.type != "cuda":
        raise ValueError("%s runs on CUDA or CPU tensors, not %s"
                         % (name, table.device))
    if not table.is_contiguous():
        raise ValueError("%s needs a contiguous table" % name)
    if table.shape[0] >= 2 ** 31:
        raise ValueError("table has %d rows; the kernel takes int32 ids"
                         % table.shape[0])
    return True


def _stream(table):
    """The raw current stream of the table's device (torch.cuda's
    current_stream builds a Stream object first, at several times the
    cost)."""
    return torch._C._cuda_getCurrentRawStream(table.device.index)


def _ids_arg(ids):
    """(pointer source, 1 for int64) of the ids as the kernels read them."""
    ids = ids.contiguous()
    return ids, int(ids.dtype == torch.int64)


def _order_ptr(order, n):
    """Pointer to a permutation the kernels read as [N] 32-bit positions,
    or None."""
    if order is None:
        return None
    if (order.dtype != torch.int32 or order.shape != (n,)
            or not order.is_contiguous()):
        raise TypeError("order must be a contiguous int32 tensor of [%d]" % n)
    return order.data_ptr()


# ---------------------------------------------------------------------------
# kernel 1: scatter-add
# ---------------------------------------------------------------------------

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


def _launch_add(table, ids, upd, sort, order=None):
    """Kernel 1: `ids` ascending (with `order` their int32 permutation of
    the rows of `upd`, or None for rows in place), or in any order with
    `sort`."""
    v, w = table.shape
    n = ids.shape[0]
    if n == 0 or w == 0:
        return
    ids, wide = _ids_arg(ids)
    upd = upd.float().contiguous()
    vec = int(w % 4 == 0 and kernels.aligned(table, upd))
    r = tile_rows(n, w)
    lib = _library("scatter_add")
    with torch.cuda.device(table.device):
        scratch = _scratch("scatter_add", table, n, r, sort)
        rc = lib.gv_scatter_add(
            table.data_ptr(), _DTYPE_CODES[table.dtype], ids.data_ptr(),
            wide, int(sort), _order_ptr(order, n),
            upd.data_ptr(), n, v, w, r, vec, scratch.data_ptr(),
            scratch.numel(), _stream(table))
    kernels.check_launch(lib, rc, "scatter_add")


def scatter_add_sorted_(table, sorted_ids, upd):
    """In place: table[sorted_ids[j]] += upd[j], duplicates summed, ids
    outside [0, V) dropped; `sorted_ids` must be ascending (the contract
    of the TPU `sweep_scatter_add`). No sort, no permute. Returns
    `table`."""
    _check(table, sorted_ids, upd)
    if not _on_card(table, "scatter_add_sorted_"):
        _check_sorted(sorted_ids)
        return scatter_add_plain(table, sorted_ids, upd)
    _launch_add(table, sorted_ids, upd, sort=False)
    scatter_add_sorted_.launches += 1
    return table


def scatter_add_(table, ids, upd):
    """In place: table[ids[j]] += upd[j] for every j in any order,
    duplicates summed, ids outside [0, V) dropped. Returns `table`.

    The ids (int32 or int64) are sorted with their positions and the rows
    of `upd` are read through the positions, in place. `upd` is float32
    (other float types are converted)."""
    _check(table, ids, upd)
    if not _on_card(table, "scatter_add_"):
        return scatter_add_plain(table, ids, upd)
    _launch_add(table, ids, upd, sort=True)
    scatter_add_.launches += 1
    return table


# ---------------------------------------------------------------------------
# kernel 2: moment update
# ---------------------------------------------------------------------------

def _check_update(table, moments, ids, grads, opt, entry_counts, entry_sqs):
    _check(table, ids, grads)
    if len(moments) != opt.num_moment:
        raise ValueError("%s takes %d moment tables, got %d"
                         % (opt.type, opt.num_moment, len(moments)))
    for m in moments:
        if m.shape != table.shape or m.dtype != torch.float32:
            raise ValueError("moments must be float32 %s"
                             % (tuple(table.shape),))
        if m.device != table.device:
            raise ValueError("moments must be on the table's device")
    n = ids.shape[0]
    if entry_counts is not None and entry_counts.shape != (n,):
        raise ValueError("entry_counts must be [%d]" % n)
    if entry_sqs is not None and entry_sqs.shape != grads.shape:
        raise ValueError("entry_sqs must be %s" % (tuple(grads.shape),))


def scatter_update_plain(table, moments, ids, grads, opt, lr,
                         entry_counts=None, entry_sqs=None, lr_scale=1.0):
    """The moment update as torch index ops and optim.moment_delta (the
    CPU path and the reference kernel 2 is held against), in place on
    `table` and `moments`. Returns (table, moments)."""
    # optim imports this module, so its moment rules are looked up here
    from graphvite_tpu_torch.optim import moment_delta

    _check_update(table, moments, ids, grads, opt, entry_counts, entry_sqs)
    v, d = table.shape
    ids = ids.long()
    keep = (ids >= 0) & (ids < v)
    g = grads.float()
    sq = g * g if entry_sqs is None else entry_sqs.float()
    cnt = (torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
           if entry_counts is None else entry_counts.float())
    sid, order = torch.sort(ids[keep], stable=True)
    rows, inverse = torch.unique_consecutive(sid, return_inverse=True)
    u = rows.numel()

    def seg_sum(x):
        return torch.zeros((u,) + x.shape[1:], dtype=torch.float32,
                           device=x.device).index_add_(0, inverse,
                                                       x[keep][order])

    gsum, gsq, counts = seg_sum(g), seg_sum(sq), seg_sum(cnt)
    touched = counts > 0
    rows, gsum, gsq = rows[touched], gsum[touched], gsq[touched]
    c = counts[touched].clamp(min=1.0)[:, None]
    delta, new_moms = moment_delta(opt, lr, gsum,
                                   tuple(m[rows] for m in moments), c, gsq)
    table[rows] = table[rows] - (lr_scale * delta).to(table.dtype)
    for m, nm in zip(moments, new_moms):
        m[rows] = nm
    return table, moments


def _launch_update(table, moments, ids, grads, opt, lr, counts, sqs,
                   lr_scale, sort, order=None):
    """Kernel 2: `ids` ascending (with `order` their int32 permutation of
    the entries, or None for entries in place), or in any order with
    `sort`; counts and sqs may be None."""
    v, d = table.shape
    n = ids.shape[0]
    if n == 0 or d == 0:
        return
    if not all(m.is_contiguous() for m in moments):
        raise ValueError("the moment kernel needs contiguous moment tables")
    ids, wide = _ids_arg(ids)
    grads, counts, sqs = _f32(grads), _f32(counts), _f32(sqs)
    m1 = moments[0]
    m2 = moments[1] if len(moments) > 1 else None
    rows = [t for t in (table, m1, m2, grads, sqs) if t is not None]
    vec = int(d % 4 == 0 and kernels.aligned(*rows))
    beta1 = {"Momentum": opt.momentum, "RMSprop": opt.alpha,
             "Adam": opt.beta1}.get(opt.type, 1.0)
    r = tile_rows(n, d)
    lib = _library("scatter_update")
    with torch.cuda.device(table.device):
        scratch = _scratch("scatter_update", table, n, r, sort)
        rc = lib.gv_scatter_update(
            table.data_ptr(), _DTYPE_CODES[table.dtype], m1.data_ptr(),
            None if m2 is None else m2.data_ptr(), ids.data_ptr(), wide,
            int(sort), _order_ptr(order, n),
            grads.data_ptr(), None if counts is None else counts.data_ptr(),
            None if sqs is None else sqs.data_ptr(), n, v, d, r,
            _MOMENT_CODES[opt.type], float(lr), float(lr_scale),
            math.log(beta1), math.log(opt.beta2), float(opt.epsilon), vec,
            scratch.data_ptr(), scratch.numel(),
            _stream(table))
    kernels.check_launch(lib, rc, "scatter_update")


def _f32(x):
    return None if x is None else x.float().contiguous()


def scatter_update_sorted_(table, moments, sorted_ids, grads, opt, lr, *,
                           entry_counts=None, entry_sqs=None, lr_scale=1.0):
    """One optimizer update of the rows `sorted_ids` (ascending) names, in
    place on `table` and `moments` (the contract of the TPU
    `sweep_scatter_update`). grads [N, D]: each entry's summed regularized
    gradient; entry_counts [N]: its touch count (default 1; 0 registers no
    touch); entry_sqs [N, D]: its summed squared per-touch gradients
    (default grad**2). `lr_scale` scales only the applied delta. SGD hands
    off to scatter_add_sorted_. Returns (table, moments)."""
    if opt.num_moment == 0:
        return (scatter_add_sorted_(table, sorted_ids,
                                    grads.float() * -(lr * lr_scale)),
                moments)
    _check_update(table, moments, sorted_ids, grads, opt, entry_counts,
                  entry_sqs)
    if not _on_card(table, "scatter_update_sorted_"):
        _check_sorted(sorted_ids)
        return scatter_update_plain(table, moments, sorted_ids, grads, opt,
                                    lr, entry_counts, entry_sqs, lr_scale)
    _launch_update(table, moments, sorted_ids, grads, opt, lr, entry_counts,
                   entry_sqs, lr_scale, sort=False)
    scatter_update_sorted_.launches += 1
    return table, moments


def scatter_update_(table, moments, ids, grads, opt, lr, *,
                    entry_counts=None, entry_sqs=None, lr_scale=1.0):
    """scatter_update_sorted_ for ids in any order (the TPU front end
    `sweep_scatter_update_unsorted`): the ids are sorted with their
    positions, and the grads, counts and squares are read through the
    positions, in place. SGD hands off to scatter_add_. Returns (table,
    moments)."""
    if opt.num_moment == 0:
        return (scatter_add_(table, ids, grads.float() * -(lr * lr_scale)),
                moments)
    _check_update(table, moments, ids, grads, opt, entry_counts, entry_sqs)
    if not _on_card(table, "scatter_update_"):
        return scatter_update_plain(table, moments, ids, grads, opt, lr,
                                    entry_counts, entry_sqs, lr_scale)
    _launch_update(table, moments, ids, grads, opt, lr, entry_counts,
                   entry_sqs, lr_scale, sort=True)
    scatter_update_.launches += 1
    return table, moments


# kernel launches since the last reset, one count per wrapper (chip_smoke.py
# reads them to show the main path went through the kernels); the CPU path
# does not count
scatter_add_.launches = 0
scatter_add_sorted_.launches = 0
scatter_update_.launches = 0
scatter_update_sorted_.launches = 0
