"""Knowledge-graph embedding models (the port of
graphvite_tpu/models/knowledge_graph.py).

Each model exposes:

* ``score(head, tail, relation, hyper)``: the logit, vectorized over any
  leading batch dims; `hyper` is the margin (TransE, RotatE) or the
  l3 regularization (DistMult, ComplEx, SimplE, QuatE), the reference's
  single `margin_or_l3` scalar.
* ``backward(head, tail, relation, gradient, hyper)``: hand-derived
  d(score)/d(row) * dL/dscore for each of the three rows, including the l3
  regularization term ``3 * l3 * |p| * p`` where the reference adds it.
  The optimizer then computes ``param -= lr * weight * (grad + wd * param)``.

Complex and quaternion layouts are interleaved (re,im,re,im,... /
r,i,j,k,...), so embeddings round-trip with GraphVite's on-disk format.
RotatE stores its phases in the first dim/2 slots of the relation row; the
unused second half receives zero gradient. QuatE's backward treats the
relation's norm as a constant, as the reference does.

`x[..., 0::2]` would be a strided view in torch: the parts are read through
a reshape to (..., D/2, 2) and `unbind`, the same numbers.
"""
from __future__ import annotations

import torch

from graphvite_tpu_torch.utils.common import EPSILON


def _l3_term(p, l3):
    # backward multiplies l3_regularization by 3 (d/dp of l3 * |p|^3)
    return (3.0 * l3) * p.abs() * p


def _split(x, parts):
    """Interleaved (..., parts * i + j) -> `parts` tensors (..., D / parts)."""
    return x.reshape(x.shape[:-1] + (x.shape[-1] // parts, parts)).unbind(-1)


def _merge(*parts):
    out = torch.stack(torch.broadcast_tensors(*parts), dim=-1)
    return out.reshape(out.shape[:-2] + (-1,))


def _split2(x):
    return _split(x, 2)


class TransE:
    """score = margin - ||h + r - t||_1."""

    name = "TransE"
    uses_margin = True

    @staticmethod
    def score(head, tail, relation, margin):
        return margin - (head + relation - tail).abs().sum(dim=-1)

    @staticmethod
    def backward(head, tail, relation, gradient, margin):
        # +1 where h + r - t > 0 else -1: zero maps to -1 (the reference's
        # ternary), so this is not torch.sign
        x = head + relation - tail
        s = torch.where(x > 0, torch.ones_like(x), -torch.ones_like(x))
        g = gradient[..., None] * s
        return -g, g, -g


class DistMult:
    """score = sum(h * r * t)."""

    name = "DistMult"
    uses_margin = False

    @staticmethod
    def score(head, tail, relation, l3):
        return (head * relation * tail).sum(dim=-1)

    @staticmethod
    def backward(head, tail, relation, gradient, l3):
        g = gradient[..., None]
        gh = g * relation * tail + _l3_term(head, l3)
        gt = g * head * relation + _l3_term(tail, l3)
        gr = g * head * tail + _l3_term(relation, l3)
        return gh, gt, gr


class ComplEx:
    """score = Re(<h * r, conj(t)>)."""

    name = "ComplEx"
    uses_margin = False

    @staticmethod
    def score(head, tail, relation, l3):
        h_re, h_im = _split2(head)
        t_re, t_im = _split2(tail)
        r_re, r_im = _split2(relation)
        p_re = h_re * r_re - h_im * r_im
        p_im = h_re * r_im + h_im * r_re
        return (p_re * t_re + p_im * t_im).sum(dim=-1)

    @staticmethod
    def backward(head, tail, relation, gradient, l3):
        h_re, h_im = _split2(head)
        t_re, t_im = _split2(tail)
        r_re, r_im = _split2(relation)
        g = gradient[..., None]
        gh = _merge(g * (r_re * t_re + r_im * t_im),
                    g * (-r_im * t_re + r_re * t_im)) + _l3_term(head, l3)
        gt = _merge(g * (h_re * r_re - h_im * r_im),
                    g * (h_re * r_im + h_im * r_re)) + _l3_term(tail, l3)
        gr = _merge(g * (h_re * t_re + h_im * t_im),
                    g * (-h_im * t_re + h_re * t_im)) + _l3_term(relation, l3)
        return gh, gt, gr


class SimplE:
    """score = sum(h * r * flip_pairs(t)), where dims 2i and 2i+1 swap."""

    name = "SimplE"
    uses_margin = False

    @staticmethod
    def _flip(x):
        a, b = _split2(x)
        return _merge(b, a)

    @staticmethod
    def score(head, tail, relation, l3):
        return (head * relation * SimplE._flip(tail)).sum(dim=-1)

    @staticmethod
    def backward(head, tail, relation, gradient, l3):
        g = gradient[..., None]
        t_flip = SimplE._flip(tail)
        gh = g * relation * t_flip + _l3_term(head, l3)
        # d(score)/d(t[j]) with j = i^1 lands back at position j after flip
        gt = SimplE._flip(g * head * relation) + _l3_term(tail, l3)
        gr = g * head * t_flip + _l3_term(relation, l3)
        return gh, gt, gr


class RotatE:
    """score = margin - sum_i |h_i * e^{i phase_i} - t_i|_2 over complex
    dims. The relation row stores dim/2 phases in its first half."""

    name = "RotatE"
    uses_margin = True

    @staticmethod
    def _diff(head, tail, relation):
        h_re, h_im = _split2(head)
        t_re, t_im = _split2(tail)
        phase = relation[..., : head.shape[-1] // 2]
        r_re, r_im = torch.cos(phase), torch.sin(phase)
        d_re = h_re * r_re - h_im * r_im - t_re
        d_im = h_re * r_im + h_im * r_re - t_im
        return h_re, h_im, r_re, r_im, d_re, d_im

    @staticmethod
    def score(head, tail, relation, margin):
        _, _, _, _, d_re, d_im = RotatE._diff(head, tail, relation)
        return margin - torch.sqrt(d_re * d_re + d_im * d_im).sum(dim=-1)

    @staticmethod
    def backward(head, tail, relation, gradient, margin):
        h_re, h_im, r_re, r_im, d_re, d_im = RotatE._diff(head, tail,
                                                          relation)
        dist = torch.sqrt(d_re * d_re + d_im * d_im)
        g = gradient[..., None] / (dist + EPSILON)
        gh = _merge(-g * (d_re * r_re + d_im * r_im),
                    -g * (-d_re * r_im + d_im * r_re))
        gt = _merge(g * d_re, g * d_im)
        gphase = -g * (d_re * (h_re * -r_im + h_im * -r_re)
                       + d_im * (h_re * r_re + h_im * -r_im))
        # the row's unused second half gets no gradient
        gr = torch.cat([gphase, torch.zeros_like(gphase)], dim=-1)
        return gh, gt, gr


class QuatE:
    """score = sum(hamilton(h, r/|r|) . t) per quaternion group."""

    name = "QuatE"
    uses_margin = False

    @staticmethod
    def _split4(x):
        return _split(x, 4)

    @staticmethod
    def score(head, tail, relation, l3):
        h_r, h_i, h_j, h_k = QuatE._split4(head)
        r_r, r_i, r_j, r_k = QuatE._split4(relation)
        t_r, t_i, t_j, t_k = QuatE._split4(tail)
        r_norm = torch.sqrt(r_r * r_r + r_i * r_i + r_j * r_j + r_k * r_k)
        p_r = h_r * r_r - h_i * r_i - h_j * r_j - h_k * r_k
        p_i = h_r * r_i + h_i * r_r + h_j * r_k - h_k * r_j
        p_j = h_r * r_j - h_i * r_k + h_j * r_r + h_k * r_i
        p_k = h_r * r_k + h_i * r_j - h_j * r_i + h_k * r_r
        return ((p_r * t_r + p_i * t_i + p_j * t_j + p_k * t_k)
                / (r_norm + EPSILON)).sum(dim=-1)

    @staticmethod
    def backward(head, tail, relation, gradient, l3):
        h_r, h_i, h_j, h_k = QuatE._split4(head)
        r_r, r_i, r_j, r_k = QuatE._split4(relation)
        t_r, t_i, t_j, t_k = QuatE._split4(tail)
        r_norm = torch.sqrt(r_r * r_r + r_i * r_i + r_j * r_j + r_k * r_k)
        # r_norm is a constant here: no gradient through the normalizer
        g = gradient[..., None] / (r_norm + EPSILON)
        gh = _merge(
            g * (r_r * t_r + r_i * t_i + r_j * t_j + r_k * t_k),
            g * (-r_i * t_r + r_r * t_i - r_k * t_j + r_j * t_k),
            g * (-r_j * t_r + r_k * t_i + r_r * t_j - r_i * t_k),
            g * (-r_k * t_r - r_j * t_i + r_i * t_j + r_r * t_k),
        ) + _l3_term(head, l3)
        gt = _merge(
            g * (h_r * r_r - h_i * r_i - h_j * r_j - h_k * r_k),
            g * (h_r * r_i + h_i * r_r + h_j * r_k - h_k * r_j),
            g * (h_r * r_j - h_i * r_k + h_j * r_r + h_k * r_i),
            g * (h_r * r_k + h_i * r_j - h_j * r_i + h_k * r_r),
        ) + _l3_term(tail, l3)
        gr = _merge(
            g * (h_r * t_r + h_i * t_i + h_j * t_j + h_k * t_k),
            g * (-h_i * t_r + h_r * t_i + h_k * t_j - h_j * t_k),
            g * (-h_j * t_r - h_k * t_i + h_r * t_j + h_i * t_k),
            g * (-h_k * t_r + h_j * t_i - h_i * t_j + h_r * t_k),
        ) + _l3_term(relation, l3)
        return gh, gt, gr


KG_MODELS = {m.name: m
             for m in (TransE, DistMult, ComplEx, SimplE, RotatE, QuatE)}
