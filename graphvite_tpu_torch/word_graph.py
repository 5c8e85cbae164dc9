"""Word co-occurrence graph (the port's copy of graphvite_tpu/word_graph.py:
host numpy code on the port's `Graph`; ref
include/instance/word_graph.cuh:41-264).

Two-pass construction: (1) vocabulary count with `min_count` filter;
(2) window-based pair counting where multiple occurrences of the same pair
accumulate into the edge weight (the reference's "compact" variant,
word_graph.cuh:73-166). Co-occurrences are counted symmetrically (both
(u,v) and (v,u) get weight), so the graph is stored directed with both
orientations present.

The counting is vectorized numpy: the corpus becomes one flat id stream
with a parallel sentence-index array, each window offset j yields pair
keys `u * V + v` by two shifted slices, and duplicate pairs aggregate by
sort and run-length encoding in bounded-memory chunks of `_CHUNK_KEYS`
keys. Ids follow the words' first appearance in the corpus.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

from graphvite_tpu_torch.graph import Graph, _make_tokenizer
from graphvite_tpu_torch.utils.common import logger

# aggregate pair keys whenever this many are buffered (8 bytes each)
_CHUNK_KEYS = 64_000_000


class WordGraph(Graph):

    def load_file(self, file_name, window=5, min_count=5, normalization=False,
                  delimiters=None, comment="#"):
        logger.info("generating graph from corpus %s", file_name)
        self.clear()
        self.normalization = normalization
        self.as_undirected = True

        tokenize = _make_tokenizer(delimiters)

        ids = sent_of = None
        if delimiters is None:
            # FAST PATH (default whitespace tokens): both passes in numpy —
            # per-line Python loops with dict lookups cost ~50s per 1M
            # tokens, which made the reference's actual use (Wikipedia,
            # word_graph.cuh:73-166) infeasible. A '\\x00' sentinel token
            # spliced at line breaks carries the sentence index through one
            # whole-corpus split; vocabulary and token ids come from
            # np.unique + np.searchsorted (C-speed sorts).
            with open(file_name) as f:
                raw = f.read()
            if comment and comment in raw:
                raw = "\n".join(line.split(comment, 1)[0]
                                for line in raw.split("\n"))
            sentinel = "\x00"
            tokens = np.asarray(
                raw.replace("\n", " %s " % sentinel).split())
            del raw
            if tokens.size:
                is_brk = tokens == sentinel
                sent_of_all = np.cumsum(is_brk, dtype=np.int64)
                tokens = tokens[~is_brk]
                sent_of_all = sent_of_all[~is_brk]
                uniq, first, counts = np.unique(
                    tokens, return_index=True, return_counts=True)
                kept = counts >= min_count
                uniq_kept = uniq[kept]
                # first-seen id order (Counter parity; word_graph.cuh
                # assigns ids in encounter order)
                order = np.argsort(first[kept], kind="stable")
                id2name = [str(w) for w in uniq_kept[order]]
                rank_to_id = np.empty(uniq_kept.size, np.int64)
                rank_to_id[order] = np.arange(order.size)
                pos = np.searchsorted(uniq_kept, tokens)
                pos = np.minimum(pos, max(uniq_kept.size - 1, 0))
                # no word kept: nothing is in the vocabulary (the
                # reference indexes the empty array here and raises)
                in_vocab = (uniq_kept[pos] == tokens if uniq_kept.size
                            else np.zeros(tokens.size, np.bool_))
                ids = rank_to_id[pos[in_vocab]]
                sent_of = sent_of_all[in_vocab]
                del tokens, sent_of_all
            else:
                id2name = []
                ids = np.zeros(0, np.int64)
                sent_of = np.zeros(0, np.int64)
            self.id2name = id2name
            self.name2id = {w: i for i, w in enumerate(id2name)}
            self.num_vertex = len(id2name)
            V = max(self.num_vertex, 1)
        else:
            def lines():
                with open(file_name) as f:
                    for line in f:
                        ci = line.find(comment)
                        if ci >= 0:
                            line = line[:ci]
                        yield line

            # pass 1: vocabulary (Counter.update is C-speed)
            freq = Counter()
            for line in lines():
                freq.update(tokenize(line))
            id2name = [w for w, c in freq.items() if c >= min_count]
            name2id = {w: i for i, w in enumerate(id2name)}
            self.id2name = id2name
            self.name2id = name2id
            self.num_vertex = len(id2name)
            V = max(self.num_vertex, 1)

            # pass 2: flat id stream + sentence index
            id_chunks = []
            lengths = []
            for line in lines():
                sent = [name2id[w] for w in tokenize(line) if w in name2id]
                if sent:
                    id_chunks.append(np.asarray(sent, np.int64))
                    lengths.append(len(sent))
            if id_chunks:
                ids = np.concatenate(id_chunks)
                sent_of = np.repeat(
                    np.arange(len(lengths), dtype=np.int64), lengths)
                del id_chunks

        # vectorized windowed pair keys aggregated chunk-by-chunk
        partial = []          # list of (unique_keys, counts)
        if ids is not None and ids.size:
            buffered = []
            buffered_n = 0

            def _rle(keys):
                """in-place sort + run-length encode: ~3x cheaper than
                np.unique (no argsort index array, no inverse pass)."""
                keys.sort(kind="stable")
                head = np.empty(keys.size, np.bool_)
                head[0] = True
                np.not_equal(keys[1:], keys[:-1], out=head[1:])
                starts = np.flatnonzero(head)
                counts = np.diff(np.append(starts, keys.size))
                return keys[starts], counts

            def aggregate():
                nonlocal buffered, buffered_n
                if not buffered:
                    return
                keys = np.concatenate(buffered)
                partial.append(_rle(keys))
                buffered = []
                buffered_n = 0

            for j in range(1, int(window) + 1):
                if j >= ids.size:
                    break
                same = sent_of[:-j] == sent_of[j:]
                u = ids[:-j][same]
                v = ids[j:][same]
                buffered.append(u * V + v)
                buffered.append(v * V + u)
                buffered_n += 2 * u.size
                if buffered_n >= _CHUNK_KEYS:
                    aggregate()
            aggregate()

        if partial:
            # merge the per-chunk aggregates (each already unique + counted):
            # one argsort over the deduped keys, then reduceat on the counts
            keys = np.concatenate([p[0] for p in partial])
            counts = np.concatenate([p[1] for p in partial])
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            counts = counts[order]
            head = np.empty(keys.size, np.bool_)
            head[0] = True
            np.not_equal(keys[1:], keys[:-1], out=head[1:])
            starts = np.flatnonzero(head)
            uk = keys[starts]
            weights = np.add.reduceat(counts.astype(np.float64), starts)
            self.edge_heads = (uk // V).astype(np.int64)
            self.edge_tails = (uk % V).astype(np.int64)
            self.edge_weights = weights.astype(np.float32)
        self.num_edge = self.edge_heads.size
        self._finalize(normalization)
        logger.info(self.info())
        return self

    load_file_compact = load_file

    def info(self):
        return ("#vertex: %d, #edge: %d\nnormalization: %s"
                % (self.num_vertex, self.num_edge,
                   "yes" if self.normalization else "no"))
