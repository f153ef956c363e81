"""graphembedding_tpu_torch — the graph-embedding framework on PyTorch.

A port of `graphembedding_tpu` (JAX on a TPU) to PyTorch with hand-written
CUDA kernels for an NVIDIA H100. It covers DeepWalk, Node2Vec (exact and
rejection (p,q) walks), Struc2Vec, LINE, SDNE, and the walk models'
objectives: sampled SGNS, hierarchical softmax (hs=1) and the closed-form
expected SGNS (trainer='dense', also LINE's):

    from graphembedding_tpu_torch import (DeepWalk, LINE, Node2Vec, SDNE,
                                          Struc2Vec)
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
    line.train(trainer="dense", steps=300, lr=0.1)   # closed form

    dw.train(embed_size=128, window_size=5, trainer="dense")

    sdne = SDNE(ds.graph, hidden_size=[256, 128], device="cuda")
    sdne.train(batch_size=3000, epochs=40)   # batch >= V: full batch
    sdne.train(batch_size=1024, epochs=40)   # the minibatch loop
    sdne.train_sparse(epochs=40, row_chunk=512)   # never builds [V, V]
    embeddings = sdne.get_embeddings()   # {node: np.ndarray[128]}

Every trainer but the dense one takes checkpoint_dir= / checkpoint_every=
and resumes from the checkpoint it finds there, bit-identical to an
uninterrupted train; the walk models' trainers take metrics= (a
`utils.metrics.MetricsLogger`):

    dw.train(embed_size=128, iter=3, checkpoint_dir="ckpt/dw",
             checkpoint_every=1)   # run again after a crash: it resumes

`utils` has the embedding I/O (word2vec text, npz), similarity queries
(`most_similar`, `similarity`) and validation; `walker` the reference's
`RandomWalker` and `BiasedWalker`; `examples` the command-line entry points
(`python -m graphembedding_tpu_torch.examples.deepwalk_wiki --json`).

This package imports torch, numpy and scipy, never jax; Struc2Vec's
context graph also builds a C++ library with g++ at first use.
"""

from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.models import (
    LINE,
    SDNE,
    DeepWalk,
    Node2Vec,
    Struc2Vec,
)
from graphembedding_tpu_torch.walker import BiasedWalker, RandomWalker

__version__ = "0.1.0"

__all__ = ["Graph", "DeepWalk", "LINE", "Node2Vec", "SDNE", "Struc2Vec",
           "RandomWalker", "BiasedWalker", "__version__"]
