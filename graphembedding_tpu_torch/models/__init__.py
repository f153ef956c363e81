from graphembedding_tpu_torch.models.deepwalk import DeepWalk

__all__ = ["DeepWalk"]
