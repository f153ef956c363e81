"""graphembedding_tpu_torch — the graph-embedding framework on PyTorch.

A port of `graphembedding_tpu` (JAX on a TPU) to PyTorch with hand-written
CUDA kernels for an NVIDIA H100. It covers the DeepWalk path:

    from graphembedding_tpu_torch import DeepWalk
    from graphembedding_tpu_torch.data import load_dataset

    ds = load_dataset("wiki")
    model = DeepWalk(ds.graph, walk_length=10, num_walks=80, device="cuda")
    model.train(embed_size=128, window_size=5, iter=3)
    embeddings = model.get_embeddings()   # {node: np.ndarray[128]}

This package imports torch, numpy and scipy, never jax.
"""

from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.models import DeepWalk

__version__ = "0.1.0"

__all__ = ["Graph", "DeepWalk", "__version__"]
