"""graphvite_tpu_torch: the PyTorch/CUDA port of graphvite_tpu.

A second package beside the JAX one, which stays the reference. It imports
torch and numpy, never jax or graphvite_tpu. So far it trains DeepWalk,
LINE and node2vec node embeddings through the walk route
(augmentation_step >= 2) and the edge route (augmentation_step 1), word
graphs built from a corpus, knowledge-graph embeddings (six models, the
classic and the pooled step, filtered ranking), and LargeVis layouts
(exact and IVF KNN graphs on the device), with the table updates and the
edge route's sorted gather on hand-written CUDA kernels
(graphvite_tpu_torch/csrc/). The command line (`python -m
graphvite_tpu_torch.cmd`) runs the shipped configs of config/ over the
dataset registry. Its solvers and applications run on CUDA unless the
caller asks for the CPU (`device="cpu"`, or `device: cpu` under a
config's `resource:`).
"""

__version__ = "0.1.0"

import numpy as _np

from graphvite_tpu_torch.utils.common import auto
from graphvite_tpu_torch.graph import Graph, KnowledgeGraph
from graphvite_tpu_torch.word_graph import WordGraph
from graphvite_tpu_torch.knn import KNNGraph
from graphvite_tpu_torch.optim import Optimizer, make_optimizer
from graphvite_tpu_torch.solver import (GraphSolver, KnowledgeGraphSolver,
                                        VisualizationSolver,
                                        state_from_numpy, state_to_numpy)
from graphvite_tpu_torch.application import (Application, GraphApplication,
                                             KnowledgeGraphApplication,
                                             VisualizationApplication,
                                             WordGraphApplication)

# dtype shorthands, mirroring the reference's graphvite.float32 / .uint32
float32 = _np.float32
float64 = _np.float64
uint32 = _np.uint32
uint64 = _np.uint64

__all__ = [
    "auto", "Graph", "KnowledgeGraph", "WordGraph", "KNNGraph", "Optimizer",
    "make_optimizer", "GraphSolver", "KnowledgeGraphSolver",
    "VisualizationSolver", "Application", "GraphApplication",
    "WordGraphApplication", "KnowledgeGraphApplication",
    "VisualizationApplication",
    "state_from_numpy", "state_to_numpy",
    "float32", "float64", "uint32", "uint64",
]
