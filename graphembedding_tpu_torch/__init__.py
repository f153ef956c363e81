"""graphembedding_tpu_torch — the graph-embedding framework on PyTorch.

A port of `graphembedding_tpu` (JAX on a TPU) to PyTorch with hand-written
CUDA kernels for an NVIDIA H100. It covers DeepWalk and LINE (its sampled
trainer):

    from graphembedding_tpu_torch import LINE, DeepWalk
    from graphembedding_tpu_torch.data import load_dataset

    ds = load_dataset("wiki")
    model = DeepWalk(ds.graph, walk_length=10, num_walks=80, device="cuda")
    model.train(embed_size=128, window_size=5, iter=3)
    embeddings = model.get_embeddings()   # {node: np.ndarray[128]}

    line = LINE(ds.graph, embedding_size=128, order="second", device="cuda")
    line.train(batch_size=1024, epochs=50)
    embeddings = line.get_embeddings()

This package imports torch, numpy and scipy, never jax.
"""

from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.models import LINE, DeepWalk

__version__ = "0.1.0"

__all__ = ["Graph", "DeepWalk", "LINE", "__version__"]
