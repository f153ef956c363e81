"""DeepWalk on Wiki, the reference's `examples/deepwalk_wiki.py`.

    python -m graphembedding_tpu_torch.examples.deepwalk_wiki [--json]

Hyperparameters: DeepWalk(walk_length=10, num_walks=80),
train(window_size=5, iter=3).
"""

from graphembedding_tpu_torch.examples.common import run
from graphembedding_tpu_torch.models import DeepWalk


def build_and_train(ds, args):
    model = DeepWalk(ds.graph, walk_length=10, num_walks=80, seed=args.seed,
                     device=args.device)
    model.train(embed_size=args.embed_size, window_size=5, iter=3,
                trainer=args.trainer)
    return model


def main(argv=None):
    return run("DeepWalk", "wiki", build_and_train, argv=argv)


if __name__ == "__main__":
    main()
