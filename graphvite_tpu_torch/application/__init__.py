"""Application pipelines: load -> build -> train -> evaluate -> save (the
port of ApplicationMixin, GraphApplication and KnowledgeGraphApplication in
graphvite_tpu/application/__init__.py). The solver runs on CUDA unless the
caller passes `device="cpu"`; evaluation runs on the solver's device."""
from __future__ import annotations

import os
import pickle
from collections import defaultdict

import numpy as np
import torch

from graphvite_tpu_torch import base
from graphvite_tpu_torch import graph as graph_mod
from graphvite_tpu_torch import solver as solver_mod
from graphvite_tpu_torch.application import evaluate as ev
from graphvite_tpu_torch.models import KG_MODELS
from graphvite_tpu_torch.utils.common import Monitor, assert_in, auto, logger


class ApplicationMixin:
    """Pipeline skeleton (ref application.py:38-241)."""

    def __init__(self, dim, gpus=None, cpu_per_gpu=auto, float_type=None,
                 index_type=None, gpu_memory_limit=auto, device=None,
                 **kwargs):
        self.dim = dim
        self.gpus = gpus or []
        self.cpu_per_gpu = cpu_per_gpu
        self.gpu_memory_limit = gpu_memory_limit
        self.float_type = base.torch_float_type(float_type)
        self.index_type = index_type or base.index_type
        self.device = device
        self.monitor = Monitor()
        self.graph = self.get_graph(**kwargs)
        self.solver = self.get_solver(**kwargs)

    # hooks ------------------------------------------------------------------
    def get_graph(self, **kwargs):
        raise NotImplementedError

    def get_solver(self, **kwargs):
        raise NotImplementedError

    # pipeline ---------------------------------------------------------------
    def load(self, **kwargs):
        with self.monitor.stage("load"):
            if "file_name" in kwargs:
                self.graph.load_file(**kwargs)
            else:
                self._load_dispatch(**kwargs)
        return self

    def _load_dispatch(self, **kwargs):
        raise ValueError("unsupported load arguments: %s" % sorted(kwargs))

    def build(self, **kwargs):
        with self.monitor.stage("build"):
            self.solver.build(self.graph, **kwargs)
        return self

    def train(self, **kwargs):
        with self.monitor.stage("train"):
            self.solver.train(**kwargs)
        return self

    def evaluate(self, task, **kwargs):
        func = getattr(self, task.replace(" ", "_"), None)
        if func is None:
            raise ValueError("unknown evaluation task `%s`" % task)
        with self.monitor.stage("evaluate:" + task):
            result = func(**kwargs)
        logger.info("%s: %s", task, result)
        return result

    # name mapping ------------------------------------------------------------
    @staticmethod
    def tokenize(line):
        comment = line.find("#")
        if comment >= 0:
            line = line[:comment]
        return line.split()

    @staticmethod
    def name_map(dicts, name_lists):
        """Map parallel name lists through dicts, dropping rows where any
        name is unknown (ref application.py:204-219)."""
        out = [[] for _ in name_lists]
        for row in zip(*name_lists):
            mapped = []
            for d, name in zip(dicts, row):
                if name not in d:
                    break
                mapped.append(d[name])
            else:
                for o, v in zip(out, mapped):
                    o.append(v)
        return out

    @staticmethod
    def get_mapping(id2name, name2id):
        mapping = np.empty(len(id2name), dtype=np.int64)
        for i, name in enumerate(id2name):
            mapping[i] = name2id[name]
        return mapping

    # persistence --------------------------------------------------------------
    def model_state(self):
        raise NotImplementedError

    def set_model_state(self, state):
        raise NotImplementedError

    def save_model(self, file_name, save_hyperparameter=False):
        state = self.model_state()
        if save_hyperparameter:
            state["hyperparameters"] = {
                "dim": self.dim,
                "optimizer": getattr(self.solver, "optimizer", None),
                "model": getattr(self.solver, "model", None),
                "num_negative": getattr(self.solver, "num_negative", None),
                "batch_size": getattr(self.solver, "batch_size", None),
            }
        with open(file_name, "wb") as f:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
        logger.info("saved model to %s", file_name)

    def load_model(self, file_name):
        """Load a model saved by save_model (pickle: only load files this
        program wrote)."""
        with open(file_name, "rb") as f:
            state = pickle.load(f)
        self.set_model_state(state)
        logger.info("loaded model from %s", file_name)
        return self


class GraphApplication(ApplicationMixin):
    """Node embedding application (ref application.py:244-533)."""

    def get_graph(self, **kwargs):
        return graph_mod.Graph()

    def get_solver(self, **kwargs):
        return solver_mod.GraphSolver(self.dim, self.float_type,
                                      self.index_type,
                                      gpu_memory_limit=self.gpu_memory_limit,
                                      num_worker=max(len(self.gpus), 1),
                                      device=self.device)

    def _load_dispatch(self, edge_list=None, **kwargs):
        if edge_list is None:
            raise ValueError("provide file_name or edge_list")
        self.graph.load_edge_list(edge_list, **kwargs)

    # -- evaluation ------------------------------------------------------------
    def node_classification(self, X=None, Y=None, file_name=None,
                            portions=(0.02,), normalization=False, times=1,
                            patience=100, seed=0):
        if file_name:
            X, Y = [], []
            with open(file_name) as f:
                for line in f:
                    tokens = self.tokenize(line)
                    if not tokens:
                        continue
                    X.append(tokens[0])
                    Y.append(tokens[1])
        if X is None or Y is None:
            raise ValueError("provide (X, Y) or file_name")
        class2id = {c: i for i, c in enumerate(np.unique(Y))}
        new_X, new_Y = self.name_map((self.graph.name2id, class2id), (X, Y))
        logger.info("effective labels: %d / %d", len(new_X), len(X))
        X = np.asarray(new_X)
        Y = np.asarray(new_Y)
        num_class = len(class2id)
        labels = np.zeros((self.graph.num_vertex, num_class), dtype=np.int32)
        labels[X, Y] = 1
        keep = labels.sum(axis=1) > 0
        labels = labels[keep]
        emb = self.solver.vertex_embeddings[keep]
        metrics = {}
        for portion in portions:
            metrics.update(ev.linear_classification(
                emb, labels, portion, normalization, times, patience, seed,
                device=self.solver.device))
        return metrics

    def link_prediction(self, H=None, T=None, Y=None, file_name=None,
                        filter_H=None, filter_T=None, filter_file=None):
        if file_name:
            H, T, Y = [], [], []
            with open(file_name) as f:
                for line in f:
                    tokens = self.tokenize(line)
                    if not tokens:
                        continue
                    h, t, y = tokens
                    H.append(h)
                    T.append(t)
                    Y.append(y)
        if H is None or T is None or Y is None:
            raise ValueError("provide (H, T, Y) or file_name")
        if filter_file:
            filter_H, filter_T = [], []
            with open(filter_file) as f:
                for line in f:
                    tokens = self.tokenize(line)
                    if not tokens:
                        continue
                    filter_H.append(tokens[0])
                    filter_T.append(tokens[1])
        filter_H = filter_H or []
        filter_T = filter_T or []

        n2i = self.graph.name2id
        Y = [int(y) for y in Y]
        H, T, Y = self.name_map((n2i, n2i, {0: 0, 1: 1}), (H, T, Y))
        fH, fT = self.name_map((n2i, n2i), (filter_H, filter_T))
        filters = set(zip(fH, fT))
        keep = [(h, t, y) for h, t, y in zip(H, T, Y) if (h, t) not in filters]
        logger.info("remaining edges: %d / %d", len(keep), len(H))
        H = np.array([k[0] for k in keep])
        T = np.array([k[1] for k in keep])
        Y = np.array([k[2] for k in keep])
        scores = self.solver.predict(H, T)
        return {"AUC": ev.rank_sum_auc(scores, Y)}

    # -- persistence -------------------------------------------------------------
    def model_state(self):
        return {
            "kind": "graph",
            "name2id": self.graph.name2id,
            "vertex_embeddings": self.solver.vertex_embeddings,
            "context_embeddings": self.solver.context_embeddings,
            "model": self.solver.model,
        }

    def set_model_state(self, state):
        mapping = self.get_mapping(self.graph.id2name, state["name2id"])
        solver = self.solver

        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a[mapping]),
                                   device=solver.device).to(solver.float_type)

        solver.model = state.get("model", "LINE")
        if solver.state is None:
            solver._allocate()
        solver.state = {"tables": (up(state["vertex_embeddings"]),
                                   up(state["context_embeddings"])),
                        "moments": solver.state["moments"]}



class KnowledgeGraphApplication(ApplicationMixin):
    """KG embedding application (ref application.py:576-1067)."""

    def get_graph(self, **kwargs):
        return graph_mod.KnowledgeGraph()

    def get_solver(self, **kwargs):
        return solver_mod.KnowledgeGraphSolver(
            self.dim, self.float_type, self.index_type,
            gpu_memory_limit=self.gpu_memory_limit,
            num_worker=max(len(self.gpus), 1), device=self.device)

    def _load_dispatch(self, triplet_list=None, **kwargs):
        if triplet_list is None:
            raise ValueError("provide file_name or triplet_list")
        self.graph.load_triplet_list(triplet_list, **kwargs)

    def _read_triplet_file(self, file_name):
        H, R, T = [], [], []
        with open(file_name) as f:
            for i, line in enumerate(f, 1):
                tokens = self.tokenize(line)
                if not tokens:
                    continue
                if not 3 <= len(tokens) <= 4:
                    raise ValueError("Invalid line %d in %s" % (i, file_name))
                h, r, t = tokens[:3]
                H.append(h)
                R.append(r)
                T.append(t)
        return H, R, T

    def _margin_or_l3(self):
        mdl = KG_MODELS[self.solver.model]
        return (self.solver.margin if mdl.uses_margin
                else self.solver.l3_regularization)

    def entity_prediction(self, H=None, R=None, T=None, file_name=None,
                          save_file=None, target="tail", k=10):
        """Top-k entity recalls per (h, r, ?) or (?, r, t) query
        (ref application.py:650-785), streamed: host memory is O(n * k)
        at any entity count."""
        assert_in("target", target, {"head", "tail"})
        if file_name:
            H, R, T = self._read_triplet_file(file_name)
        e2i, r2i = self.graph.entity2id, self.graph.relation2id
        if target == "head":
            R_, T_ = self.name_map((r2i, e2i), (R, T))
            H_ = [0] * len(R_)
        else:
            H_, R_ = self.name_map((e2i, r2i), (H, R))
            T_ = [0] * len(R_)
        H_, R_, T_ = (np.asarray(x, dtype=np.int64) for x in (H_, R_, T_))
        entity, relation = self.solver.state["tables"]
        vals, ids = ev.kg_topk(self.solver.model, entity, relation, H_, R_,
                               T_, target, self._margin_or_l3(), k=k)
        id2e = self.graph.id2entity
        recalls = [[(id2e[int(e)], float(v)) for e, v in zip(irow, vrow)]
                   for irow, vrow in zip(ids, vals)]
        if save_file:
            ext = os.path.splitext(save_file)[1]
            if ext == ".txt":
                with open(save_file, "w") as f:
                    for recall in recalls:
                        f.write("\t".join("%s: %g" % x for x in recall)
                                + "\n")
            elif ext == ".pkl":
                with open(save_file, "wb") as f:
                    pickle.dump(recalls, f, protocol=pickle.HIGHEST_PROTOCOL)
            else:
                raise ValueError("Unknown extension `%s`" % ext)
            return None
        return recalls

    def link_prediction(self, H=None, R=None, T=None, file_name=None,
                        filter_H=None, filter_R=None, filter_T=None,
                        filter_files=None, target="both", fast_mode=None,
                        backend=None, seed=None):
        """Filtered MR/MRR/HITS@k (ref application.py:787-946).
        `fast_mode`: evaluate that many triplets drawn with `seed`;
        `backend` is accepted for parity."""
        assert_in("target", target, {"head", "tail", "both"})
        if file_name:
            H, R, T = self._read_triplet_file(file_name)
        if filter_files:
            filter_H, filter_R, filter_T = [], [], []
            for ff in filter_files:
                fh, fr, ft = self._read_triplet_file(ff)
                filter_H += fh
                filter_R += fr
                filter_T += ft
        filter_H = filter_H or []
        filter_R = filter_R or []
        filter_T = filter_T or []

        e2i, r2i = self.graph.entity2id, self.graph.relation2id
        nH, nR, nT = self.name_map((e2i, r2i, e2i), (H, R, T))
        logger.info("effective triplets: %d / %d", len(nH), len(H))
        H = np.asarray(nH, dtype=np.int64)
        R = np.asarray(nR, dtype=np.int64)
        T = np.asarray(nT, dtype=np.int64)
        fH, fR, fT = self.name_map((e2i, r2i, e2i),
                                   (filter_H, filter_R, filter_T))
        exclude_H = defaultdict(set)
        exclude_T = defaultdict(set)
        for h, r, t in zip(fH, fR, fT):
            exclude_H[(t, r)].add(h)
            exclude_T[(h, r)].add(t)

        if fast_mode:
            rng = np.random.default_rng(seed)
            idx = rng.permutation(len(H))[:fast_mode]
            H, R, T = H[idx], R[idx], T[idx]

        entity, relation = self.solver.state["tables"]
        rankings = ev.filtered_rankings(
            self.solver.model, entity, relation, H, R, T, exclude_H,
            exclude_T, self._margin_or_l3(), target)
        return ev.ranking_metrics(rankings)

    def model_state(self):
        return {
            "kind": "knowledge_graph",
            "entity2id": self.graph.entity2id,
            "relation2id": self.graph.relation2id,
            "entity_embeddings": self.solver.entity_embeddings,
            "relation_embeddings": self.solver.relation_embeddings,
            "model": self.solver.model,
            "margin": getattr(self.solver, "margin", 12.0),
            "l3_regularization": getattr(self.solver, "l3_regularization",
                                         2e-3),
        }

    def set_model_state(self, state):
        emap = self.get_mapping(self.graph.id2entity, state["entity2id"])
        rmap = self.get_mapping(self.graph.id2relation, state["relation2id"])
        solver = self.solver

        def up(a, mapping):
            return torch.as_tensor(np.ascontiguousarray(a[mapping]),
                                   device=solver.device).to(solver.float_type)

        solver.model = state.get("model", "RotatE")
        solver.margin = state.get("margin", 12.0)
        solver.l3_regularization = state.get("l3_regularization", 2e-3)
        if solver.state is None:
            solver._allocate()
        solver.state = {"tables": (up(state["entity_embeddings"], emap),
                                   up(state["relation_embeddings"], rmap)),
                        "moments": solver.state["moments"]}


APPLICATIONS = {
    "graph": GraphApplication,
    "knowledge graph": KnowledgeGraphApplication,
    "knowledge_graph": KnowledgeGraphApplication,
}
# the reference's other application types, by the ROADMAP item that ports
# them
_NOT_PORTED = {"word graph": 14, "word_graph": 14, "visualization": 13}


def Application(type, *args, **kwargs):
    """Factory mirroring graphvite.application.Application
    (ref application.py:1371-1392)."""
    if type in _NOT_PORTED:
        raise NotImplementedError(
            "the `%s` application is not ported yet (ROADMAP queue 1, item "
            "%d)" % (type, _NOT_PORTED[type]))
    assert_in("application type", type, set(APPLICATIONS))
    return APPLICATIONS[type](*args, **kwargs)
