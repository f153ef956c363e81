"""LINE on Wiki, the reference's `examples/line_wiki.py`.

    python -m graphembedding_tpu_torch.examples.line_wiki [--json]

Hyperparameters: LINE(embedding_size=128, order='second'),
train(batch_size=1024, epochs=50).
"""

from graphembedding_tpu_torch.examples.common import run
from graphembedding_tpu_torch.models import LINE


def build_and_train(ds, args):
    model = LINE(ds.graph, embedding_size=args.embed_size, order="second",
                 seed=args.seed, device=args.device)
    # LINE's trainers are 'sampled' and 'dense' (the CLI's 'block' is the
    # sampled one)
    model.train(batch_size=1024, epochs=50,
                trainer="dense" if args.trainer == "dense" else "sampled")
    return model


def main(argv=None):
    return run("LINE", "wiki", build_and_train, argv=argv)


if __name__ == "__main__":
    main()
