"""Application pipeline for node embedding: load -> build -> train ->
evaluate -> save (the port of ApplicationMixin and GraphApplication in
graphvite_tpu/application/__init__.py). The solver runs on CUDA unless the
caller passes `device="cpu"`."""
from __future__ import annotations

import pickle

import numpy as np
import torch

from graphvite_tpu_torch import base
from graphvite_tpu_torch import graph as graph_mod
from graphvite_tpu_torch import solver as solver_mod
from graphvite_tpu_torch.application import evaluate as ev
from graphvite_tpu_torch.utils.common import Monitor, auto, logger


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

