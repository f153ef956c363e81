"""SDNE on Wiki, the reference's `examples/sdne_wiki.py`.

    python -m graphembedding_tpu_torch.examples.sdne_wiki [--json]

Hyperparameters: SDNE(hidden_size=[256, 128]), train(batch_size=3000,
epochs=40) (a full batch on Wiki's 2,405 nodes).
"""

from graphembedding_tpu_torch.examples.common import run
from graphembedding_tpu_torch.models import SDNE


def build_and_train(ds, args):
    if args.trainer == "dense":
        raise SystemExit("SDNE has no dense-SGNS mode (autoencoder "
                         "objective); drop --trainer dense")
    model = SDNE(ds.graph, hidden_size=[256, 128], seed=args.seed,
                 device=args.device)
    model.train(batch_size=3000, epochs=40)
    return model


def main(argv=None):
    return run("SDNE", "wiki", build_and_train, argv=argv)


if __name__ == "__main__":
    main()
