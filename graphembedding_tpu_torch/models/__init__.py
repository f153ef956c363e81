from graphembedding_tpu_torch.models.deepwalk import DeepWalk
from graphembedding_tpu_torch.models.line import LINE

__all__ = ["DeepWalk", "LINE"]
