"""Node2Vec on Wiki, the reference's `examples/node2vec_wiki.py`.

    python -m graphembedding_tpu_torch.examples.node2vec_wiki [--json]

Hyperparameters: Node2Vec(walk_length=10, num_walks=80, p=0.25, q=4),
train(window_size=5, iter=3).
"""

from graphembedding_tpu_torch.examples.common import run
from graphembedding_tpu_torch.models import Node2Vec


def build_and_train(ds, args):
    model = Node2Vec(ds.graph, walk_length=10, num_walks=80, p=0.25, q=4.0,
                     seed=args.seed, device=args.device)
    model.train(embed_size=args.embed_size, window_size=5, iter=3,
                mesh=args.mesh, trainer=args.trainer)
    return model


def main(argv=None):
    return run("Node2Vec", "wiki", build_and_train, argv=argv)


if __name__ == "__main__":
    main()
