"""Node-embedding models (the port of graphvite_tpu/models/graph.py).

LINE / DeepWalk / node2vec share one score, dot(vertex, context); they
differ only in how positive samples are generated (sampler side).
"""
from __future__ import annotations


class LINE:
    """score = <vertex, context>."""

    name = "LINE"

    @staticmethod
    def score(vertex, context):
        return (vertex * context).sum(dim=-1)

    @staticmethod
    def backward(vertex, context, gradient):
        """d(score)/d(vertex), d(score)/d(context) scaled by dL/dscore:
        grad_vertex = g * context, grad_context = g * vertex."""
        g = gradient[..., None]
        return g * context, g * vertex


class DeepWalk(LINE):
    name = "DeepWalk"


class Node2Vec(LINE):
    name = "node2vec"


GRAPH_MODELS = {"LINE": LINE, "DeepWalk": DeepWalk, "node2vec": Node2Vec}
