"""Node embedding on the walk route: GraphSolver.build, then
GraphSolver.train (DeepWalk), resumed call after call, on a power-law
clone of the configuration's dataset."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import clones, init
from benchmark.apps import TrainingJob
from benchmark.reference import deepwalk


class Job(TrainingJob):
    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from graphvite_tpu_torch.graph import Graph
        from graphvite_tpu_torch.solver import GraphSolver

        ds = cfg["dataset"]
        V = int(ds["num_vertex"])
        self.edges = clones.power_law_edges(V, int(ds["num_edge"]),
                                            self.seed)
        u, v = self.edges
        # chip_smoke.py:455-466: an anonymous symmetrized graph, filled
        # straight into the arrays (names of a million vertices would
        # take minutes to factorize, and the solver reads only the arrays)
        g = Graph()
        g.num_vertex = V
        g.num_edge = int(u.size)
        g.id2name = g.name2id = None
        g.as_undirected = True
        g.edge_heads = np.concatenate([u, v])
        g.edge_tails = np.concatenate([v, u])
        g.edge_weights = np.ones(g.edge_heads.size, dtype=np.float32)
        g._finalize(normalization=False)
        res = cfg["resource"]
        self.solver = GraphSolver(dim=int(res["dim"]),
                                  float_type=res["float_type"],
                                  device=self.device, seed=self.seed)
        self.solver.build(g, **cfg["build"])
        self.install_init(self.solver)

    def fault_points(self):
        """The walk route's step on the fused arena (SGD, tables above the
        dense-update size: the cell's, and its tiny copy's on the CPU),
        the walk sampler altering a walk's sixth vertex, and kernel 1. A
        configuration on another route (the edge route, or a moment
        optimizer's separate tables) needs a job that names its own."""
        train, opt = self.cfg["train"], self.cfg["build"]["optimizer"]
        if int(train["augmentation_step"]) < 2 or opt["type"] != "SGD":
            raise ValueError("%s does not train the walk route's fused arena"
                             % self.cfg["name"])
        return {"step": ("graphvite_tpu_torch.ops.steps",
                         "make_graph_banded_fused_step"),
                "sampler": ("graphvite_tpu_torch.ops.device_sampler",
                            "DeviceWalkSampler"),
                "token": (0, (0, 5)),
                "update": ("graphvite_tpu_torch.ops.scatter", "scatter_add_")}

    def step_inputs(self, step, state, args, mask, replay):
        from graphvite_tpu_torch.ops.alias import alias_draws, device_sample

        chain, tails, lr, *neg_state = args
        # the pool the step draws for itself, drawn again: the alias
        # draws of the step's shape, mapped by the program's sampler
        draws = alias_draws(neg_state, step.pool_shape, replay,
                            chain.device)
        pool = device_sample(*neg_state, *draws)
        ids = torch.cat([chain.reshape(-1), pool.reshape(-1)]).long()
        return {"chain": chain.clone(), "mask": mask.clone(), "pool": pool,
                "lr": lr, "ids": [ids, ids]}

    def step_rows(self, state, rec):
        """Vertex and context rows at the walk's and the pool's ids: the
        columns of the program's tables side by side (separate tables, or
        the fused arena), split by the configuration's widths."""
        ids = rec["ids"][0]
        rows = torch.cat([t[ids].float() for t in state["tables"]], dim=1)
        return list(rows.split([c for _, _, c in init.shapes(self.cfg)],
                               dim=1))

    def samples_per_batch(self):
        """Valid walk pairs: pair slots times the mean pair flag of the
        followed batches."""
        share = float(torch.stack([s["mask"].float().mean()
                                   for s in self.steps]).mean())
        return self.solver.effective_batch * share

    def check_sampler(self, steps):
        return deepwalk.check_sampler(self.cfg, self.edges, steps)

    def follow(self, dtype):
        return deepwalk.follow(self.cfg, self.seed, self.edges, self.steps,
                               [self.followed_call], dtype)

    def follow_window(self, dtype):
        return deepwalk.follow_window(self.cfg, self.edges, self.window_step,
                                      dtype)
