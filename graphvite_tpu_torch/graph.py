"""Host-side graph containers over numpy arrays (the port's numpy-only
copy of graphvite_tpu/graph.py: `Graph`, a CSR, and `KnowledgeGraph`, a
triplet list).

Semantics kept from the reference:
* first-seen order assigns node ids (name maps);
* `as_undirected` symmetrizes by appending reverse edges (u != v only);
* `normalization` rescales w /= sqrt(out_weight[u] * in_weight[v]);
* `num_edge` counts *input* edges (symmetrized reverses are extra directed
  edges, visible via `num_directed_edge`).
"""
from __future__ import annotations

import re

import numpy as np

from graphvite_tpu_torch.utils import tracing
from graphvite_tpu_torch.utils.common import logger


def _factorize(names):
    """ids in first-seen order + the unique names in that order (the
    vectorized equivalent of the reference's dict loop / pandas.factorize)."""
    names = np.asarray(names, dtype=str)
    if names.size == 0:
        return np.zeros(0, np.int64), []
    uniq, first, inverse = np.unique(names, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(order.size, np.int64)
    rank[order] = np.arange(order.size)
    return rank[inverse.reshape(-1)], uniq[order].tolist()


def _make_tokenizer(delimiters):
    """`delimiters` is a SET of separator characters (strtok semantics)."""
    if not delimiters:
        return lambda line: line.split()
    pattern = re.compile("[%s]+" % re.escape(delimiters))
    return lambda line: [t for t in pattern.split(line) if t]


def _parse_edge_file(file_name, num_columns, delimiters=None, comment="#"):
    """Parse a delimited edge file into string columns + a weight column."""
    cols = [[] for _ in range(num_columns)]
    weights = []
    tokenize = _make_tokenizer(delimiters)
    with open(file_name, "r") as f:
        for lineno, line in enumerate(f, 1):
            if comment:
                ci = line.find(comment)
                if ci >= 0:
                    line = line[:ci]
            parts = tokenize(line)
            if not parts:
                continue
            if len(parts) < num_columns or len(parts) > num_columns + 1:
                raise ValueError("Invalid format at line %d of %s" % (lineno, file_name))
            for c in range(num_columns):
                cols[c].append(parts[c])
            weights.append(float(parts[num_columns]) if len(parts) > num_columns else 1.0)
    return cols, np.asarray(weights, dtype=np.float32)


class Graph:
    """Named-node graph with flat directed-edge arrays and a CSR index."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.num_vertex = 0
        self.num_edge = 0
        self.name2id = {}
        self.id2name = []
        self.as_undirected = True
        self.normalization = False
        # flat directed-edge arrays (symmetrized if as_undirected)
        self.edge_heads = np.zeros(0, dtype=np.int64)
        self.edge_tails = np.zeros(0, dtype=np.int64)
        self.edge_weights = np.zeros(0, dtype=np.float32)
        # CSR over sources
        self.indptr = np.zeros(1, dtype=np.int64)
        self.indices = np.zeros(0, dtype=np.int64)
        self.csr_weights = np.zeros(0, dtype=np.float32)
        self.csr_edge_ids = np.zeros(0, dtype=np.int64)
        self.vertex_weights = np.zeros(0, dtype=np.float64)

    # -- loading -----------------------------------------------------------
    def load_file(self, file_name, as_undirected=True, normalization=False,
                  delimiters=None, comment="#"):
        logger.info("loading graph from %s", file_name)
        (us, vs), w = _parse_edge_file(file_name, 2, delimiters, comment)
        self._build(us, vs, w, as_undirected, normalization)
        return self

    def load_edge_list(self, edge_list, as_undirected=True, normalization=False):
        us = [str(e[0]) for e in edge_list]
        vs = [str(e[1]) for e in edge_list]
        w = np.array([float(e[2]) if len(e) > 2 else 1.0 for e in edge_list],
                     dtype=np.float32)
        self._build(us, vs, w, as_undirected, normalization)
        return self

    load_weighted_edge_list = load_edge_list

    def _build(self, us, vs, w, as_undirected, normalization):
        self.clear()
        self.as_undirected = as_undirected
        self.normalization = normalization
        n_in = len(us)
        codes, uniques = _factorize(list(us) + list(vs))
        self.id2name = [str(x) for x in uniques]
        self.name2id = {n: i for i, n in enumerate(self.id2name)}
        self.num_vertex = len(uniques)
        self.num_edge = n_in
        u = codes[:n_in]
        v = codes[n_in:]
        w = np.asarray(w, dtype=np.float32)
        if as_undirected:
            keep = u != v  # reverse edge only when u != v
            u = np.concatenate([u, v[keep]])
            v2 = np.concatenate([v, u[:n_in][keep]])
            w = np.concatenate([w, w[keep]])
            v = v2
        self.edge_heads = u.astype(np.int64)
        self.edge_tails = v.astype(np.int64)
        self.edge_weights = w.astype(np.float32)
        self._finalize(normalization)

    @tracing.setup_stage(tracing.GRAPH_FINALIZE)
    def _finalize(self, normalization):
        """Normalize weights (optionally) and build the CSR index from the
        flat edge arrays; callers that fill `edge_heads/edge_tails/
        edge_weights` directly (synthetic graphs) call this themselves."""
        u, v, w = self.edge_heads, self.edge_tails, self.edge_weights
        n = self.num_vertex
        if normalization:
            out_w = np.bincount(u, weights=w, minlength=n)
            in_w = np.bincount(v, weights=w, minlength=n)
            w = (w / np.sqrt(out_w[u] * in_w[v])).astype(np.float32)
            self.edge_weights = w
        self.vertex_weights = np.bincount(u, weights=w, minlength=n)
        # CSR sorted by source, stable to preserve insertion order per vertex
        order = np.argsort(u, kind="stable")
        self.indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(u, minlength=n), out=self.indptr[1:])
        self.indices = v[order]
        self.csr_weights = w[order]
        self.csr_edge_ids = order.astype(np.int64)

    # -- properties --------------------------------------------------------
    @property
    def num_directed_edge(self):
        return self.edge_heads.size

    @property
    def degrees(self):
        """Out-degree of every vertex (CSR row lengths)."""
        return np.diff(self.indptr)

    def neighbors(self, u):
        """(neighbor ids, edge weights) of vertex u, in CSR order."""
        lo, hi = self.indptr[u], self.indptr[u + 1]
        return self.indices[lo:hi], self.csr_weights[lo:hi]

    def info(self):
        return ("#vertex: %d, #edge: %d\nas undirected: %s, normalization: %s"
                % (self.num_vertex, self.num_edge,
                   "yes" if self.as_undirected else "no",
                   "yes" if self.normalization else "no"))

    def save(self, file_name, weighted=True, anonymous=False):
        """Write the directed edge list, one "head\ttail[\tweight]" line
        per edge, by name (by id when `anonymous`)."""
        with open(file_name, "w") as f:
            for u, v, w in zip(self.edge_heads, self.edge_tails,
                               self.edge_weights):
                a = str(u) if anonymous else self.id2name[u]
                b = str(v) if anonymous else self.id2name[v]
                f.write("%s\t%s\t%f\n" % (a, b, w) if weighted
                        else "%s\t%s\n" % (a, b))

    def __repr__(self):
        return "Graph<%d vertices, %d edges>" % (self.num_vertex, self.num_edge)


class KnowledgeGraph:
    """Triplet graph (ref include/instance/knowledge_graph.cuh:67-284)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.num_vertex = 0
        self.num_relation = 0
        self.num_edge = 0
        self.entity2id = {}
        self.relation2id = {}
        self.id2entity = []
        self.id2relation = []
        self.normalization = False
        self.edge_heads = np.zeros(0, dtype=np.int64)
        self.edge_tails = np.zeros(0, dtype=np.int64)
        self.edge_relations = np.zeros(0, dtype=np.int64)
        self.edge_weights = np.zeros(0, dtype=np.float32)

    def load_file(self, file_name, normalization=False, delimiters=None,
                  comment="#"):
        logger.info("loading knowledge graph from %s", file_name)
        (hs, rs, ts), w = _parse_edge_file(file_name, 3, delimiters, comment)
        self._build(hs, rs, ts, w, normalization)
        return self

    def load_triplet_list(self, triplet_list, normalization=False):
        hs = [str(e[0]) for e in triplet_list]
        rs = [str(e[1]) for e in triplet_list]
        ts = [str(e[2]) for e in triplet_list]
        w = np.array([float(e[3]) if len(e) > 3 else 1.0
                      for e in triplet_list], dtype=np.float32)
        self._build(hs, rs, ts, w, normalization)
        return self

    load_weighted_triplet_list = load_triplet_list

    def _build(self, hs, rs, ts, w, normalization):
        self.clear()
        self.normalization = normalization
        n = len(hs)
        # entity ids in first-seen order across an interleaved (h, t)
        # stream, the reference's add_edge visit order
        inter = np.empty(2 * n, dtype=object)
        inter[0::2] = hs
        inter[1::2] = ts
        codes, uniques = _factorize(inter)
        self.id2entity = [str(x) for x in uniques]
        self.entity2id = {e: i for i, e in enumerate(self.id2entity)}
        self.num_vertex = len(uniques)
        h = codes[0::2]
        t = codes[1::2]
        rcodes, runiques = _factorize(np.asarray(rs, dtype=object))
        self.id2relation = [str(x) for x in runiques]
        self.relation2id = {r: i for i, r in enumerate(self.id2relation)}
        self.num_relation = len(runiques)
        self.num_edge = n
        w = np.asarray(w, dtype=np.float32)
        if normalization:
            # w /= sqrt(head_weight[(h, r)] * tail_weight[(t, r)])
            hr = h * self.num_relation + rcodes
            tr = t * self.num_relation + rcodes
            hw = np.zeros(self.num_vertex * self.num_relation)
            tw = np.zeros(self.num_vertex * self.num_relation)
            np.add.at(hw, hr, w)
            np.add.at(tw, tr, w)
            w = (w / np.sqrt(hw[hr] * tw[tr])).astype(np.float32)
        self.edge_heads = h.astype(np.int64)
        self.edge_tails = t.astype(np.int64)
        self.edge_relations = rcodes.astype(np.int64)
        self.edge_weights = w

    @property
    def num_entity(self):
        return self.num_vertex

    @property
    def degrees(self):
        """Entity occurrence counts (head + tail roles)."""
        return (np.bincount(self.edge_heads, minlength=self.num_vertex)
                + np.bincount(self.edge_tails, minlength=self.num_vertex))

    def info(self):
        return ("#entity: %d, #relation: %d\n#triplet: %d, normalization: %s"
                % (self.num_vertex, self.num_relation, self.num_edge,
                   "yes" if self.normalization else "no"))

    def save(self, file_name, anonymous=False):
        with open(file_name, "w") as f:
            for h, t, r in zip(self.edge_heads, self.edge_tails,
                               self.edge_relations):
                if anonymous:
                    f.write("%d\t%d\t%d\n" % (h, t, r))
                else:
                    f.write("%s\t%s\t%s\n" % (self.id2entity[h],
                                              self.id2entity[t],
                                              self.id2relation[r]))

    def __repr__(self):
        return ("KnowledgeGraph<%d entities, %d relations, %d triplets>"
                % (self.num_vertex, self.num_relation, self.num_edge))
