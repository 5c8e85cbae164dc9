"""Application pipelines: load -> build -> train -> evaluate -> save (the
port of ApplicationMixin, GraphApplication, WordGraphApplication,
KnowledgeGraphApplication and VisualizationApplication in
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
from graphvite_tpu_torch.knn import KNNGraph
from graphvite_tpu_torch.models import KG_MODELS
from graphvite_tpu_torch.utils.common import Monitor, assert_in, auto, logger
from graphvite_tpu_torch.word_graph import WordGraph


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
                                      device_ids=self.gpus or None,
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
        tables = (up(state["vertex_embeddings"]),
                  up(state["context_embeddings"]))
        # several workers allocate nothing before their first run
        moments = (solver.state["moments"] if solver.state is not None
                   else tuple(solver.optimizer.init_moments(t.shape,
                                                            t.device)
                              for t in tables))
        solver.state = {"tables": tables, "moments": moments}


class WordGraphApplication(GraphApplication):
    """Word-cooccurrence node embedding (ref application.py:536-573): the
    graph application over a `WordGraph` built from a corpus
    (`load(file_name=..., window=..., min_count=...)`)."""

    def get_graph(self, **kwargs):
        return WordGraph()


class KnowledgeGraphApplication(ApplicationMixin):
    """KG embedding application (ref application.py:576-1067)."""

    def get_graph(self, **kwargs):
        return graph_mod.KnowledgeGraph()

    def get_solver(self, **kwargs):
        return solver_mod.KnowledgeGraphSolver(
            self.dim, self.float_type, self.index_type,
            gpu_memory_limit=self.gpu_memory_limit,
            num_worker=max(len(self.gpus), 1),
            device_ids=self.gpus or None, device=self.device)

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


class VisualizationApplication(ApplicationMixin):
    """LargeVis visualization application (ref application.py:1070-1368).
    The KNN graph is built on the application's device. Plots need
    matplotlib; without it they are skipped with a warning, as in the
    reference, and the frames and coordinates are still returned."""

    def get_graph(self, **kwargs):
        return KNNGraph(device=self.device)

    def get_solver(self, **kwargs):
        return solver_mod.VisualizationSolver(
            self.dim, self.float_type, self.index_type,
            gpu_memory_limit=self.gpu_memory_limit,
            num_worker=max(len(self.gpus), 1),
            device_ids=self.gpus or None, device=self.device)

    def load(self, vectors=None, file_name=None, **kwargs):
        with self.monitor.stage("load"):
            if vectors is not None:
                self.graph.load_numpy(vectors, **kwargs)
            elif file_name is not None:
                self.graph.load_file(file_name, **kwargs)
            else:
                raise ValueError("provide vectors or file_name")
        return self

    @staticmethod
    def _pyplot(what):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            return plt
        except ImportError as e:  # pragma: no cover - host without it
            logger.warning("matplotlib unavailable (%s); skipping %s", e,
                           what)
            return None

    def visualization(self, Y=None, save_file=None, figure_size=10, scale=2):
        """2D/3D scatter with 5-sigma outlier clipping
        (ref application.py:1119-1187); returns the clipped coordinates."""
        coords = self.solver.coordinates
        mean = coords.mean(axis=0)
        std = coords.std(axis=0)
        clipped = np.clip(coords, mean - 5 * std, mean + 5 * std)
        if save_file is None:
            return clipped
        plt = self._pyplot("plot")
        if plt is None:
            return clipped
        fig = plt.figure(figsize=(figure_size, figure_size))
        if self.dim == 3:
            ax = fig.add_subplot(111, projection="3d")
            args = (clipped[:, 0], clipped[:, 1], clipped[:, 2])
        else:
            ax = fig.add_subplot(111)
            args = (clipped[:, 0], clipped[:, 1])
        if Y is not None:
            classes = np.unique(Y)
            for c in classes:
                m = np.asarray(Y) == c
                ax.scatter(*(a[m] for a in args), s=scale, label=str(c))
            if len(classes) <= 20:
                ax.legend(markerscale=6)
        else:
            ax.scatter(*args, s=scale)
        ax.set_xticks([])
        ax.set_yticks([])
        fig.savefig(save_file, bbox_inches="tight")
        plt.close(fig)
        logger.info("saved visualization to %s", save_file)
        return clipped

    def hierarchy(self, HY=None, file_name=None, target=None, save_file=None,
                  figure_size=10, scale=2, duration=3):
        """Animated zoom over a label hierarchy (ref application.py:1189-1255
        + render_hierarchy :1317-1343): find the first vertex whose label at
        some level equals `target`; emit one frame per level down to that
        depth, coloring by the next level's labels with every vertex OUTSIDE
        the target's current branch grayed out as "else". `file_name`: text
        file with one whitespace-separated label path per vertex. Returns
        the frames (coordinates, labels, focus label)."""
        if file_name is not None and HY is None:
            with open(file_name) as f:
                HY = [line.split() for line in f if line.split()]
            width = max(len(r) for r in HY)
            HY = [r + [r[-1]] * (width - len(r)) for r in HY]
        HY = np.asarray(HY)
        if HY.dtype.kind == "U" and HY.dtype.itemsize < 4 * len("else"):
            # the fixed-width string dtype must be able to hold "else"
            # (ref application.py:1225-1227)
            HY = HY.astype("U4")
        coords = self.solver.coordinates
        # 5-sigma outlier removal (ref application.py:1229-1234)
        mean = coords.mean(axis=0)
        std = coords.std(axis=0)
        inside = np.all(np.abs(coords - mean) < 5 * std, axis=1)
        coords = coords[inside]
        HY = HY[inside]

        if target is not None:
            sample = depth = None
            for level in range(HY.shape[1]):
                idx = np.nonzero(HY[:, level] == str(target))[0]
                if idx.size:
                    sample, depth = int(idx[0]), level
                    break
            if sample is None:
                raise ValueError("can't find target `%s` in the hierarchy"
                                 % target)
            frames = []
            for i in range(depth + 1):
                y = HY[:, i].copy()
                if i > 0:
                    # gray out everything outside the target's branch
                    y[HY[:, i - 1] != HY[sample, i - 1]] = "else"
                frames.append((coords, y, y[sample]))
        else:
            frames = [(coords, HY[:, level], None)
                      for level in range(HY.shape[1])]
        if save_file is None:
            return frames
        plt = self._pyplot("gif")
        if plt is None:
            return frames
        from matplotlib import animation
        fig = plt.figure(figsize=(figure_size, figure_size))
        ax = fig.add_subplot(111)

        def draw(level):
            ax.clear()
            c_fr, y, focus = frames[level]
            classes = sorted(set(y))
            if focus is not None:
                # focus class first, "else" in light grey at the back
                classes = ([focus] + [c for c in classes
                                      if c not in (focus, "else")]
                           + (["else"] if "else" in classes else []))
            for z, c in enumerate(classes):
                m = y == c
                ax.scatter(c_fr[m, 0], c_fr[m, 1], s=scale,
                           c="lightgrey" if c == "else" else None,
                           zorder=-z, label=str(c))
            ax.set_xticks([])
            ax.set_yticks([])
            ax.legend(markerscale=6, loc="upper right")
        anim = animation.FuncAnimation(fig, draw, frames=len(frames),
                                       interval=duration * 1000)
        anim.save(save_file, writer="pillow")
        plt.close(fig)
        return frames

    def animation(self, Y=None, save_file=None, figure_size=5, scale=2,
                  elevation=30, num_frame=700):
        """Rotating 3D scatter gif (ref application.py:1257-1314); returns
        the coordinates."""
        if self.dim != 3:
            raise ValueError("animation requires dim=3")
        coords = self.solver.coordinates
        if save_file is None:
            return coords
        plt = self._pyplot("gif")
        if plt is None:
            return coords
        from matplotlib import animation as mpl_anim
        fig = plt.figure(figsize=(figure_size, figure_size))
        ax = fig.add_subplot(111, projection="3d")
        if Y is None:
            Y = np.zeros(len(coords), dtype=int)
        Y = np.asarray(Y)
        # 5-sigma outlier removal (ref application.py:1300-1305)
        mean = coords.mean(axis=0)
        std = coords.std(axis=0)
        inside = np.all(np.abs(coords - mean) < 5 * std, axis=1)
        coords = coords[inside]
        Y = Y[inside]
        # the class scatters are drawn once; each frame turns the view
        for c in np.unique(Y):
            m = Y == c
            ax.scatter(coords[m, 0], coords[m, 1], coords[m, 2], s=scale)
        ax.set_xticks([])
        ax.set_yticks([])
        ax.set_zticks([])

        def draw(frame):
            ax.view_init(elev=elevation, azim=frame * 360.0 / num_frame)
            return ()
        anim = mpl_anim.FuncAnimation(fig, draw, frames=num_frame,
                                      interval=70000.0 / num_frame)
        anim.save(save_file, writer="pillow")
        plt.close(fig)
        return coords

    def model_state(self):
        return {"kind": "visualization",
                "coordinates": self.solver.coordinates}

    def set_model_state(self, state):
        solver = self.solver
        if solver.state is None:
            solver._allocate()
        coords = np.asarray(state["coordinates"], dtype=np.float32)
        pad = solver._pad_dim - coords.shape[1]
        if pad > 0:
            coords = np.concatenate(
                [coords, np.zeros((coords.shape[0], pad), coords.dtype)],
                axis=1)
        table = torch.as_tensor(coords, device=solver.device).to(
            solver.float_type)
        solver.state = {"tables": (table,),
                        "moments": solver.state["moments"]}


APPLICATIONS = {
    "graph": GraphApplication,
    "word graph": WordGraphApplication,
    "word_graph": WordGraphApplication,
    "knowledge graph": KnowledgeGraphApplication,
    "knowledge_graph": KnowledgeGraphApplication,
    "visualization": VisualizationApplication,
}


def Application(type, *args, **kwargs):
    """Factory mirroring graphvite.application.Application
    (ref application.py:1371-1392)."""
    assert_in("application type", type, set(APPLICATIONS))
    return APPLICATIONS[type](*args, **kwargs)
