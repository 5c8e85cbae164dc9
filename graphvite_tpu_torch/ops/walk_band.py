"""The positive band of the banded walk step: the part of
ops/steps.py:make_graph_banded_core that pairs each walk position with its
tails at the walk offsets, on the SGD path.

`walk_band(v, c, mask, offsets, wd, head_wd, bf16_band=False)`: the
chain's vertex-role rows v and context-role rows c [B, L1, D] (float32,
columns contiguous; any walk and row strides, so the halves of one
[B, L1, 2D] gather go in as they are), the pair flags mask [B, L1, T]
(float32) for the T `offsets`. Pair (i, t) is head v[i] with tail
c[i + offsets[t]] (logit 0 where that lies past the walk), with gradient
g = (sigmoid(logit) - 1) * mask[i, t]. Returns

* dv [B, L1, D]: sum_t g[i, t] c[i + off_t] + head_wd cnt[i] v[i];
* dc [B, L1, D]: sum_t g[j - off_t, t] v[j - off_t] + wd cntc[j] c[j];
* cnt [B, L1]: mask.sum(-1), the head's pairs; cntc [B, L1]: the
  context's, sum_t mask[j - off_t, t];
* sums [B, 2]: each walk's positive loss sum m softplus(-logit) and its
  pair count (the caller adds the walks).

The caller adds the negatives' share of dv. `bf16_band` rounds each
product v * c to bf16 before a logit's float32 sum (GRAPHVITE_BF16_BAND on
bf16 tables).

On a CUDA tensor it launches the hand-written kernel of
graphvite_tpu_torch/csrc/walk_band.cu (built with nvcc for sm_90a at first
use, bound with ctypes): one block a walk, the whole band in one launch,
or raises on inputs it does not take; each launch adds 1 to the
`graphvite::walk_band_kernel` counter. On a CPU tensor it runs
`walk_band_plain`, the same float32 arithmetic in plain PyTorch
(chip_smoke.py and the card tests hold the kernel to it on the card):
products and sums rounded one by one, sums over the offsets in offset
order; only the order of a logit's sum over the columns and of a walk's
loss over its positions differs.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from graphvite_tpu_torch.ops import kernels
from graphvite_tpu_torch.utils import tracing

MAX_OFFSETS = 64          # csrc/walk_band.cu: kMaxOffsets


def walk_shift_fwd(x, kk):
    """result[:, i] = x[:, i + kk] along the walk axis (dim 1), zero-padded."""
    if kk == 0:
        return x
    out = torch.zeros_like(x)
    if kk > 0:
        out[:, :-kk] = x[:, kk:]
    else:
        out[:, -kk:] = x[:, :kk]
    return out


def walk_band_plain(v, c, mask, offsets, wd, head_wd, bf16_band=False):
    """`walk_band` in plain PyTorch on any device (the CPU's path; what the
    kernel is held to): the kernel's arithmetic, one eager step an
    offset."""
    wd, head_wd = float(np.float32(wd)), float(np.float32(head_wd))
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dc = torch.zeros_like(dv)
    loss = torch.zeros(v.shape[:2], dtype=torch.float32, device=v.device)
    cnt = torch.zeros_like(loss)
    cntc = torch.zeros_like(loss)
    for t, off in enumerate(offsets):
        csh = walk_shift_fwd(c, off)
        prod = v * csh
        if bf16_band:
            prod = prod.bfloat16().float()
        logit = prod.sum(dim=-1)
        m = mask[..., t]
        g = (torch.sigmoid(logit) - 1.0) * m
        loss = loss + m * F.softplus(-logit)
        cnt = cnt + m
        dv = dv + g[..., None] * csh
        # head i's gradient g v lands at tail i + off
        dc = dc + walk_shift_fwd(g[..., None] * v, -off)
        cntc = cntc + walk_shift_fwd(m, -off)
    dv = dv + (head_wd * cnt)[..., None] * v
    dc = dc + (wd * cntc)[..., None] * c
    sums = torch.stack([loss.sum(dim=-1), cnt.sum(dim=-1)], dim=-1)
    return dv, dc, cnt, cntc, sums


@functools.lru_cache(maxsize=None)
def _library():
    lib = kernels.library("walk_band")
    vp, i, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                     ctypes.c_float)
    lib.gv_walk_band.argtypes = ([vp] * 3 + [i64] * 4 + [i] * 4
                                 + [ctypes.POINTER(ctypes.c_int), f, f, i]
                                 + [vp] * 6)
    lib.gv_walk_band.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _offsets_array(offsets):
    return (ctypes.c_int * len(offsets))(*offsets)


def _check(v, c, mask, offsets):
    """Raise on inputs the kernel does not take (checked once for each
    key of shapes, strides, dtypes, devices and offsets); the kernel
    refuses a walk past the card's shared memory."""
    _check_key(v.shape, v.stride(), c.shape, c.stride(), mask.shape,
               mask.stride(), (v.dtype, c.dtype, mask.dtype),
               (v.device, c.device, mask.device), offsets)


@functools.lru_cache(maxsize=None)
def _check_key(v_shape, v_stride, c_shape, c_stride, m_shape, m_stride,
               dtypes, devices, offsets):
    for name, dtype in zip(("v", "c", "mask"), dtypes):
        if dtype != torch.float32:
            raise TypeError("walk_band: %s must be float32, not %s"
                            % (name, dtype))
    if len(set(devices)) != 1:
        raise ValueError("walk_band: v, c and mask on %s, %s and %s"
                         % devices)
    for name, shape in (("v", v_shape), ("c", c_shape), ("mask", m_shape)):
        if len(shape) != 3:
            raise ValueError("walk_band: %s must be 3-d, not %s"
                             % (name, tuple(shape)))
    B, L1, D = v_shape
    T = len(offsets)
    if c_shape != v_shape or tuple(m_shape) != (B, L1, T):
        raise ValueError("walk_band: v %s, c %s and mask %s must be [B, L1, "
                         "D] and [B, L1, %d]" % (tuple(v_shape),
                                                 tuple(c_shape),
                                                 tuple(m_shape), T))
    if not 0 < B < 2**31 or L1 == 0 or D == 0 or not 0 < T <= MAX_OFFSETS:
        raise ValueError("walk_band: B %d, L1 %d, D %d, T %d out of range"
                         % (B, L1, D, T))
    if v_stride[-1] != 1 or c_stride[-1] != 1:
        raise ValueError("walk_band: v and c need contiguous columns")
    if m_stride != (L1 * T, T, 1):
        raise ValueError("walk_band needs a contiguous mask")


def walk_band(v, c, mask, offsets, wd, head_wd, bf16_band=False):
    """The positive band of B walks: (dv, dc, cnt, cntc, sums), as the
    module's docstring says; the five are views of one buffer."""
    if v.device.type == "cpu":
        return walk_band_plain(v, c, mask, offsets, wd, head_wd, bf16_band)
    if v.device.type != "cuda":
        raise ValueError("walk_band runs on CUDA or CPU tensors, not %s"
                         % v.device)
    if type(offsets) is not tuple:
        offsets = tuple(int(o) for o in offsets)
    _check(v, c, mask, offsets)
    B, L1, D = v.shape
    n, p = B * L1 * D, B * L1
    out = torch.empty(2 * n + 2 * p + 2 * B, dtype=torch.float32,
                      device=v.device)
    dv, dc, cnt, cntc, sums = out.split([n, n, p, p, 2 * B])
    dv, dc = dv.view(B, L1, D), dc.view(B, L1, D)
    cnt, cntc, sums = cnt.view(B, L1), cntc.view(B, L1), sums.view(B, 2)
    _launch(v, c, mask, offsets, wd, head_wd, bf16_band, dv, dc, cnt, cntc,
            sums)
    tracing.count(tracing.WALK_BAND_KERNEL, 1)
    return dv, dc, cnt, cntc, sums


def _launch(v, c, mask, offsets, wd, head_wd, bf16_band, dv, dc, cnt, cntc,
            sums):
    """The kernel into dv, dc, cnt, cntc and sums, on checked inputs
    (`walk_band`; chip_smoke.py times it alone). `wd` and `head_wd` go to
    the kernel as float32."""
    lib = _library()
    B, L1, D = v.shape
    with torch.cuda.device(v.device):
        kernels.check_launch(lib, lib.gv_walk_band(
            v.data_ptr(), c.data_ptr(), mask.data_ptr(), v.stride(0),
            v.stride(1), c.stride(0), c.stride(1), B, L1, D, len(offsets),
            _offsets_array(offsets), wd, head_wd, int(bool(bf16_band)),
            dv.data_ptr(), dc.data_ptr(), cnt.data_ptr(), cntc.data_ptr(),
            sums.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "walk_band")
