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

from graphvite_tpu_torch import native as _native
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


def _radix_order(heads, num_vertex):
    """The stable order of the int ids `heads` (in [0, num_vertex)): one
    or two stable 16-bit passes (numpy's radix sort), each linear; a
    stable comparison sort past 32-bit ids."""
    if num_vertex <= 1 << 16:
        return np.argsort(heads.astype(np.uint16), kind="stable")
    if num_vertex > 1 << 32:
        return np.argsort(heads, kind="stable")
    lo = np.argsort((heads & 0xFFFF).astype(np.uint16), kind="stable")
    hi = (heads[lo] >> 16).astype(np.uint16)
    return lo[np.argsort(hi, kind="stable")]


def csr_by_head(heads, tails, num_vertex, with_indices=True,
                with_order=False):
    """(indptr int64 [V + 1], indices or None, order int64 or None) of the
    directed edges heads[i] -> tails[i], stable by head: the native
    counting sort (native/sampler.cpp) over int32 or int64 ids, else
    numpy's radix passes."""
    heads = np.asarray(heads)
    tails = np.asarray(tails)
    if (heads.dtype in (np.int32, np.int64) and tails.dtype == heads.dtype
            and _native.load() is not None):
        return _native.csr_by_head(np.ascontiguousarray(heads),
                                   np.ascontiguousarray(tails), num_vertex,
                                   with_indices, with_order)
    indptr = np.zeros(num_vertex + 1, dtype=np.int64)
    np.cumsum(np.bincount(heads, minlength=num_vertex), out=indptr[1:])
    order = _radix_order(heads, num_vertex)
    return (indptr, tails[order] if with_indices else None,
            order.astype(np.int64) if with_order else None)


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
        self.uniform_weights = True
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
        edge_weights` directly (synthetic graphs) call this themselves.

        The CSR is sorted by source and stable (each vertex's edges in
        their flat order), by a counting sort (`csr_by_head`): linear in
        the edges, with no comparison sort. `indices` keeps the tails'
        dtype. On a graph whose weights are all equal (`uniform_weights`)
        nothing is gathered by the sort's order: `csr_weights` is a
        read-only view of the one weight, and the flat edge id of each CSR
        position (`csr_edge_ids`, int64) is made when first read."""
        u, v, w = self.edge_heads, self.edge_tails, self.edge_weights
        n = self.num_vertex
        if normalization:
            out_w = np.bincount(u, weights=w, minlength=n)
            in_w = np.bincount(v, weights=w, minlength=n)
            w = (w / np.sqrt(out_w[u] * in_w[v])).astype(np.float32)
            self.edge_weights = w
        self.uniform_weights = bool(w.size == 0 or np.all(w == w[0]))
        if self.uniform_weights:
            self.indptr, self.indices, _ = csr_by_head(u, v, n)
            self.csr_weights = np.broadcast_to(w[:1], w.shape)
            self._csr_edge_ids = None
            deg = np.diff(self.indptr)
            if w.size and w[0] == 1:
                # a sum of ones: the bincount below, exactly
                self.vertex_weights = deg.astype(np.float64)
            else:
                self.vertex_weights = np.bincount(u, weights=w, minlength=n)
            return
        self.vertex_weights = np.bincount(u, weights=w, minlength=n)
        self.indptr, _, order = csr_by_head(u, v, n, with_indices=False,
                                            with_order=True)
        self.indices = v[order]
        self.csr_weights = w[order]
        self.csr_edge_ids = order

    @property
    def csr_edge_ids(self):
        """The flat edge id at each CSR position (int64)."""
        if self._csr_edge_ids is None:
            _, _, self._csr_edge_ids = csr_by_head(
                self.edge_heads, self.edge_tails, self.num_vertex,
                with_indices=False, with_order=True)
        return self._csr_edge_ids

    @csr_edge_ids.setter
    def csr_edge_ids(self, value):
        self._csr_edge_ids = value

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
