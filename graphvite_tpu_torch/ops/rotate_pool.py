"""The RotatE isometry body's negatives on shared candidate pools: the part
of make_kg_pool_step's fast_rotate_body (ops/steps.py) that scores every
(sample, candidate) pair of every pool group and sums the per-pair
gradients.

`pool_sums(u_re, u_im, w_re, w_im, c_re, c_im, margin, outs, need_sq)`:
frames u = t e^{-i phi} and w = h e^{i phi} [G, Bg, Dh] and candidates
[G, M, Dh] as (re, im) halves, float32 and contiguous; the first M/2
candidates of a group corrupt heads (d = c - u), the rest tails (d = w -
c). Per side it takes the logits margin - sum_k |d| (the squared modulus
clamped at EPSILON^2 under an rsqrt), calls `outs(logits [G, Bg, M])` ->
(weights, loss, gn), the self-adversarial tail of the step (the mask
enters there), and sums z = gn / |d| * d over the candidates (E, per
sample) and over the samples (B, per candidate), with need_sq also the
sums of the squares (S_rr, S_ii, S_ri; B_rr, B_ii). Returns (loss, head
side's sums, tail side's sums), each side a dict of [G, Bg, Dh] (E_*,
S_*) and [G, M/2, Dh] (B_*) tensors.

On a CUDA tensor it launches the two hand-written kernels of
graphvite_tpu_torch/csrc/rotate_pool.cu (built with nvcc for sm_90a at
first use, bound with ctypes; `pool_sums.launches` counts them), which
hold no [G, Bg, M/2, Dh] intermediate, or raises on inputs they do not
take; on a CPU tensor it runs `pool_sums_plain`, the same mathematics in
plain PyTorch with such intermediates (chip_smoke.py and the card tests
also hold the kernels to it on the card). Both check their inputs first.

The kernels' order of sums is fixed by the shape (no atomics): logits
over the dimensions in order; B over the samples in order; E over the
candidates of a warp (8), then the warps, then slices of 64 candidates.
Against the plain version the sums differ in order only (float32).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from graphvite_tpu_torch.ops import kernels
from graphvite_tpu_torch.utils.common import EPSILON

# candidates of one side a gradient CTA takes (csrc/rotate_pool.cu:
# kGradSlice); more make E partial sums that the wrapper adds in order
SLICE = 64
MAX_GROUPS = 32767           # grid z is 2 G
E_KEYS = ("E_re", "E_im", "S_rr", "S_ii", "S_ri")
B_KEYS = ("B_re", "B_im", "B_rr", "B_ii")


@functools.lru_cache(maxsize=None)
def _library():
    lib = kernels.library("rotate_pool")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gv_rotate_pool_logits.argtypes = [vp] * 7 + [i] * 4 + [f, f, i, vp]
    lib.gv_rotate_pool_grads.argtypes = [vp] * 9 + [i] * 4 + [f, i, vp]
    for fn in (lib.gv_rotate_pool_logits, lib.gv_rotate_pool_grads):
        fn.restype = i
    return lib


def check(u_re, u_im, w_re, w_im, c_re, c_im):
    """Raise on inputs the kernels do not take; returns (G, Bg, M2, Dh)."""
    frames = (u_re, u_im, w_re, w_im)
    tensors = frames + (c_re, c_im)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("pool_sums takes float32 frames and candidates, "
                        "not %s" % sorted({str(t.dtype) for t in tensors}))
    if any(t.device != u_re.device for t in tensors):
        raise ValueError("pool_sums: frames and candidates on one device")
    if u_re.dim() != 3 or any(t.shape != u_re.shape for t in frames):
        raise ValueError("frames must be four [G, Bg, Dh] tensors; got %s"
                         % [tuple(t.shape) for t in frames])
    G, Bg, Dh = u_re.shape
    if (c_re.dim() != 3 or c_re.shape != c_im.shape or c_re.shape[0] != G
            or c_re.shape[2] != Dh or c_re.shape[1] % 2):
        raise ValueError("candidates must be two [%d, M, %d] tensors with M "
                         "even; got %s, %s" % (G, Dh, tuple(c_re.shape),
                                               tuple(c_im.shape)))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pool_sums needs contiguous frames and candidates")
    M2 = c_re.shape[1] // 2
    if min(G, Bg, M2, Dh) == 0:
        raise ValueError("pool_sums: empty shape G %d, Bg %d, M/2 %d, Dh %d"
                         % (G, Bg, M2, Dh))
    if G > MAX_GROUPS:
        raise ValueError("pool_sums takes at most %d groups, not %d"
                         % (MAX_GROUPS, G))
    return G, Bg, M2, Dh


def pool_sums(u_re, u_im, w_re, w_im, c_re, c_im, margin, outs, need_sq):
    """(loss, head side's sums, tail side's sums): see the module."""
    dev = u_re.device
    if dev.type == "cpu":
        return pool_sums_plain(u_re, u_im, w_re, w_im, c_re, c_im, margin,
                               outs, need_sq)
    G, Bg, M2, Dh = check(u_re, u_im, w_re, w_im, c_re, c_im)
    if dev.type != "cuda":
        raise ValueError("pool_sums runs on CUDA or CPU tensors, not %s"
                         % dev)
    lib = _library()
    eps2 = EPSILON * EPSILON
    inputs = [t.data_ptr() for t in (u_re, u_im, w_re, w_im, c_re, c_im)]
    vec = int(Dh % 4 == 0 and kernels.aligned(u_re, u_im, w_re, w_im,
                                               c_re, c_im))
    logits = torch.empty((G, Bg, 2 * M2), device=dev)
    with torch.cuda.device(dev):
        kernels.check_launch(lib, lib.gv_rotate_pool_logits(
            *inputs, logits.data_ptr(), G, Bg, M2, Dh, float(margin), eps2,
            vec, torch.cuda.current_stream().cuda_stream),
            "rotate_pool logits")
    pool_sums.launches += 1
    _, loss, gn = outs(logits)
    if gn.shape != logits.shape or gn.dtype != torch.float32:
        raise ValueError("outs gave gn %s %s, want %s float32"
                         % (tuple(gn.shape), gn.dtype, tuple(logits.shape)))
    gn = gn.contiguous()
    slices = -(-M2 // SLICE)
    qe, qb = (5, 4) if need_sq else (2, 2)
    e_out = torch.empty((qe, slices, 2, G, Bg, Dh), device=dev)
    b_out = torch.empty((qb, G, 2 * M2, Dh), device=dev)
    with torch.cuda.device(dev):
        kernels.check_launch(lib, lib.gv_rotate_pool_grads(
            *inputs, gn.data_ptr(), e_out.data_ptr(), b_out.data_ptr(), G,
            Bg, M2, Dh, eps2, int(need_sq),
            torch.cuda.current_stream().cuda_stream), "rotate_pool grads")
    pool_sums.launches += 1
    return (loss,) + unpack(e_out, b_out)


pool_sums.launches = 0


def unpack(e_out, b_out):
    """The kernels' outputs, e_out [Qe, slices, 2, G, Bg, Dh] and b_out
    [Qb, G, M, Dh], as the two sides' dicts of pool_sums (the slices'
    E partial sums added in slice order)."""
    e = e_out[:, 0]
    for p in range(1, e_out.shape[1]):
        e = e + e_out[:, p]
    M2 = b_out.shape[2] // 2
    sides = []
    for s, rows in enumerate((slice(0, M2), slice(M2, None))):
        sums = {key: e[q, s] for q, key in enumerate(E_KEYS[:e.shape[0]])}
        sums.update({key: b_out[q][:, rows]
                     for q, key in enumerate(B_KEYS[:b_out.shape[0]])})
        sides.append(sums)
    return tuple(sides)


def pool_sums_plain(u_re, u_im, w_re, w_im, c_re, c_im, margin, outs,
                    need_sq):
    """pool_sums in plain PyTorch on any device, through [G, Bg, M/2, Dh]
    intermediates (the CPU's path; the card's before the kernels)."""
    check(u_re, u_im, w_re, w_im, c_re, c_im)
    M2 = c_re.shape[1] // 2

    def side(fixed_re, fixed_im, cs_re, cs_im, head_side):
        """One corruption side: d = c - u (head) or w - c (tail) per
        (sample, candidate, dim); logits and what the gradients need."""
        if head_side:
            d_re = cs_re[:, None] - fixed_re[:, :, None]
            d_im = cs_im[:, None] - fixed_im[:, :, None]
        else:
            d_re = fixed_re[:, :, None] - cs_re[:, None]
            d_im = fixed_im[:, :, None] - cs_im[:, None]
        sq = d_re * d_re + d_im * d_im                       # [g, Bg, M2, Dh]
        rinv = torch.rsqrt(torch.clamp(sq, min=EPSILON * EPSILON))
        logits = margin - (sq * rinv).sum(dim=-1)
        return d_re, d_im, rinv, logits

    dh_re, dh_im, rinv_h, lg_h = side(u_re, u_im, c_re[:, :M2],
                                      c_im[:, :M2], True)
    dt_re, dt_im, rinv_t, lg_t = side(w_re, w_im, c_re[:, M2:],
                                      c_im[:, M2:], False)
    logits = torch.cat([lg_h, lg_t], dim=-1)                 # [g, Bg, M]
    _, loss_neg, gn = outs(logits)

    def side_grads(gn_s, d_re, d_im, rinv):
        """z = (gn / rho) * d; sums of z over the samples (candidate
        side, B_*) and over the candidates (sample side, E_*), and of
        its squares for the moment rules."""
        alpha = gn_s[..., None] * rinv                       # [g, Bg, M2, Dh]
        z_re = alpha * d_re
        z_im = alpha * d_im
        out = {"B_re": z_re.sum(dim=1), "B_im": z_im.sum(dim=1),
               "E_re": z_re.sum(dim=2), "E_im": z_im.sum(dim=2)}
        if need_sq:
            zr2 = z_re * z_re
            zi2 = z_im * z_im
            out.update(B_rr=zr2.sum(dim=1), B_ii=zi2.sum(dim=1),
                       S_rr=zr2.sum(dim=2), S_ii=zi2.sum(dim=2),
                       S_ri=(z_re * z_im).sum(dim=2))
        return out

    sh = side_grads(gn[..., :M2], dh_re, dh_im, rinv_h)
    del dh_re, dh_im, rinv_h
    st = side_grads(gn[..., M2:], dt_re, dt_im, rinv_t)
    del dt_re, dt_im, rinv_t
    return loss_neg, sh, st
