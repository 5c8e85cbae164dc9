from graphvite_tpu_torch.models.graph import GRAPH_MODELS, LINE, DeepWalk, Node2Vec
from graphvite_tpu_torch.models.knowledge_graph import (KG_MODELS, ComplEx,
                                                         DistMult, QuatE,
                                                         RotatE, SimplE,
                                                         TransE)
from graphvite_tpu_torch.models.visualization import SMOOTH_TERM, LargeVis

__all__ = ["GRAPH_MODELS", "LINE", "DeepWalk", "Node2Vec", "KG_MODELS",
           "TransE", "DistMult", "ComplEx", "SimplE", "RotatE", "QuatE",
           "LargeVis", "SMOOTH_TERM"]
