from graphembedding_tpu_torch.models.deepwalk import DeepWalk
from graphembedding_tpu_torch.models.line import LINE
from graphembedding_tpu_torch.models.node2vec import Node2Vec

__all__ = ["DeepWalk", "LINE", "Node2Vec"]
