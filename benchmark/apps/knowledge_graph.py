"""Knowledge-graph embedding: KnowledgeGraphSolver.build, then
KnowledgeGraphSolver.train (RotatE), resumed call after call, on a
power-law clone of the configuration's dataset."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import clones
from benchmark.apps import TrainingJob
from benchmark.reference import rotate


class Job(TrainingJob):
    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from graphvite_tpu_torch.graph import KnowledgeGraph
        from graphvite_tpu_torch.solver import KnowledgeGraphSolver

        ds = cfg["dataset"]
        self.graph = clones.power_law_kg(int(ds["num_vertex"]),
                                         int(ds["num_relation"]),
                                         int(ds["num_edge"]), self.seed)
        heads, tails, rels = self.graph
        # chip_smoke.py:1222-1235: the arrays of an anonymous graph
        kg = KnowledgeGraph()
        kg.num_vertex = int(ds["num_vertex"])
        kg.num_relation = int(ds["num_relation"])
        kg.num_edge = int(heads.size)
        kg.id2entity = kg.entity2id = kg.id2relation = None
        kg.relation2id = None
        kg.edge_heads, kg.edge_tails, kg.edge_relations = heads, tails, rels
        kg.edge_weights = np.ones(heads.size, dtype=np.float32)
        res = cfg["resource"]
        self.solver = KnowledgeGraphSolver(dim=int(res["dim"]),
                                           float_type=res["float_type"],
                                           device=self.device,
                                           seed=self.seed)
        self.solver.build(kg, **cfg["build"])
        self.install_init(self.solver)

    def fault_points(self):
        """The pooled KG step, the edge sampler with relations altering a
        triplet's tail, and kernel 1."""
        return {"step": ("graphvite_tpu_torch.ops.steps", "make_kg_pool_step"),
                "sampler": ("graphvite_tpu_torch.ops.device_sampler",
                            "DeviceEdgeSampler"),
                "token": (1, (0,)),
                "update": ("graphvite_tpu_torch.ops.scatter", "scatter_add_")}

    def step_inputs(self, step, state, args, mask, replay):
        heads, tails, rels, lr = args[:4]
        # the candidates the step draws for itself, drawn again
        negatives = torch.randint(0, state["tables"][0].shape[0],
                                  step.pool_shape, generator=replay,
                                  device=heads.device)
        ids = torch.cat([heads, tails, negatives.reshape(-1)]).long()
        return {"heads": heads.clone(), "tails": tails.clone(),
                "rels": rels.clone(), "negatives": negatives, "lr": lr,
                "ids": [ids, rels.long()]}

    def step_rows(self, state, rec):
        """Entity rows at the heads', tails' and candidates' ids, relation
        rows at the relations'."""
        return [t[i].float() for t, i in zip(state["tables"], rec["ids"])]

    def samples_per_batch(self):
        """Positive triplets."""
        return self.solver.effective_batch

    def check_sampler(self, steps):
        return rotate.check_sampler(self.cfg, self.graph, steps)

    def follow(self, dtype):
        return rotate.follow(self.cfg, self.seed, self.steps,
                             [self.followed_call], dtype)

    def follow_window(self, dtype):
        return rotate.follow_window(self.cfg, self.window_step, dtype)
