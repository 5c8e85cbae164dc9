"""LargeVis visualization model (the port of
graphvite_tpu/models/visualization.py; ref
include/instance/model/visualization.h).

score x = ||head - tail||^2; training uses the student-t probability
1/(1+x) with the reference's smoothed negative gradient
(gpu/visualization.cuh:29,85).
"""
from __future__ import annotations

SMOOTH_TERM = 0.1  # gpu/visualization.cuh:29


class LargeVis:
    name = "LargeVis"

    @staticmethod
    def score(head, tail):
        d = head - tail
        return (d * d).sum(dim=-1)

    @staticmethod
    def backward(head, tail, gradient):
        """grad_head = g * (h - t), grad_tail = g * (t - h)
        (model/visualization.h:48-57): half the true gradient of the
        score; the caller's `gradient` carries the factor 2."""
        g = gradient[..., None]
        d = head - tail
        return g * d, -g * d
