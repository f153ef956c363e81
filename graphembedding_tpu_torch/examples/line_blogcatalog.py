"""LINE on BlogCatalog, BASELINE.json's LINE configuration.

    python -m graphembedding_tpu_torch.examples.line_blogcatalog [--json]

BlogCatalog (10,312 nodes, 333,983 edges, 39 labels) is the LINE paper's
benchmark; the reference ships only Wiki and the flight networks, so this
entry point is new, as it is in the JAX package. Order 'all' (first and
second order concatenated) by default, `--order` to choose, 50 epochs of
batches of 1,024 edges. Without the real edgelist it trains on the
synthetic BlogCatalog-scale SBM (`data.synthetic_blogcatalog`).
"""

from graphembedding_tpu_torch.examples.common import make_parser, run
from graphembedding_tpu_torch.models import LINE


def build_and_train(ds, args):
    model = LINE(ds.graph, embedding_size=args.embed_size, order=args.order,
                 seed=args.seed, device=args.device)
    model.train(batch_size=1024, epochs=args.epochs,
                trainer="dense" if args.trainer == "dense" else "sampled")
    return model


def main(argv=None):
    parser = make_parser("LINE-BlogCatalog", "blogcatalog")
    parser.add_argument("--order", default="all",
                        choices=["first", "second", "all"])
    parser.add_argument("--epochs", type=int, default=50)
    return run("LINE", "blogcatalog", build_and_train, parser=parser,
               argv=argv)


if __name__ == "__main__":
    main()
