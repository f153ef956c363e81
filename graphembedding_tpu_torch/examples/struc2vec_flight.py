"""Struc2Vec on the Brazil flight network, the reference's
`examples/struc2vec_flight.py`.

    python -m graphembedding_tpu_torch.examples.struc2vec_flight [--json]

Hyperparameters: Struc2Vec(walk_length=10, num_walks=80, workers=4,
verbose=40), train(window_size=5, iter=5) (hierarchical softmax); 4
activity-quartile classes. The context graph is cached in
./temp_struc2vec/. `GE_TPU_DTW_MODE=exact` swaps the reference's radius-1
fastdtw for the exact DTW, as in the JAX package.
"""

import os

from graphembedding_tpu_torch.examples.common import run
from graphembedding_tpu_torch.models import Struc2Vec


def build_and_train(ds, args):
    model = Struc2Vec(ds.graph, walk_length=10, num_walks=80, workers=4,
                      verbose=40, seed=args.seed,
                      dtw_mode=os.environ.get("GE_TPU_DTW_MODE", "fastdtw"),
                      device=args.device)
    # the dense expected-SGNS trainer trains the SGNS objective: hs off
    model.train(embed_size=args.embed_size, window_size=5, iter=5,
                trainer=args.trainer,
                **({"hs": 0} if args.trainer == "dense" else {}))
    return model


def main(argv=None):
    return run("Struc2Vec", "flight-brazil", build_and_train, argv=argv)


if __name__ == "__main__":
    main()
