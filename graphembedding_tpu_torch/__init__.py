"""graphembedding_tpu_torch — the graph-embedding framework on PyTorch.

A port of `graphembedding_tpu` (JAX on a TPU) to PyTorch with hand-written
CUDA kernels for an NVIDIA H100. It covers DeepWalk, Node2Vec (exact and
rejection (p,q) walks), Struc2Vec, LINE (its sampled trainer) and the
walk models' two objectives, SGNS and hierarchical softmax (hs=1):

    from graphembedding_tpu_torch import LINE, DeepWalk, Node2Vec, Struc2Vec
    from graphembedding_tpu_torch.data import load_dataset

    ds = load_dataset("wiki")
    model = DeepWalk(ds.graph, walk_length=10, num_walks=80, device="cuda")
    model.train(embed_size=128, window_size=5, iter=3)
    embeddings = model.get_embeddings()   # {node: np.ndarray[128]}

    n2v = Node2Vec(ds.graph, walk_length=10, num_walks=80, p=0.25, q=4,
                   device="cuda")
    n2v.train(embed_size=128, window_size=5, iter=3)

    dw = DeepWalk(ds.graph, walk_length=10, num_walks=80, device="cuda")
    dw.train(embed_size=128, window_size=5, iter=3, hs=1)

    flight = load_dataset("flight-brazil")
    s2v = Struc2Vec(flight.graph, walk_length=10, num_walks=80, workers=4,
                    device="cuda")   # context graph cached in ./temp_struc2vec/
    s2v.train(embed_size=128, window_size=5, iter=5)   # hs='auto' -> hs=1

    line = LINE(ds.graph, embedding_size=128, order="second", device="cuda")
    line.train(batch_size=1024, epochs=50)
    embeddings = line.get_embeddings()

This package imports torch, numpy and scipy, never jax; Struc2Vec's
context graph also builds a C++ library with g++ at first use.
"""

from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.models import LINE, DeepWalk, Node2Vec, Struc2Vec

__version__ = "0.1.0"

__all__ = ["Graph", "DeepWalk", "LINE", "Node2Vec", "Struc2Vec",
           "__version__"]
