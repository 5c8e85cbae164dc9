from graphvite_tpu_torch.models.graph import GRAPH_MODELS, LINE, DeepWalk, Node2Vec

__all__ = ["GRAPH_MODELS", "LINE", "DeepWalk", "Node2Vec"]
