from graphembedding_tpu_torch.models.deepwalk import DeepWalk
from graphembedding_tpu_torch.models.line import LINE
from graphembedding_tpu_torch.models.node2vec import Node2Vec
from graphembedding_tpu_torch.models.struc2vec import Struc2Vec

__all__ = ["DeepWalk", "LINE", "Node2Vec", "Struc2Vec"]
